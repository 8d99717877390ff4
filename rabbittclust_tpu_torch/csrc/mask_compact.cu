// Ordered compaction of the filter's packed masks (kernel K3) for Hopper.
//
// Replaces the index half of rabbittclust_tpu/ops/bitmap.py::
// _batched_filter_fn (:389) over compact_mask_two_level (:296): the jitted
// program rebuilds a batch's candidate masks and writes every set position
// of tile t, encoded t * rb^2 + r * rb + c, at the running total, in tile
// order and row-major within a tile.  Here the masks are already resident:
// K1 (filter_mask.cu) wrote them packed, (k, rb, rb / 8) uint8, little bit
// order, and the host holds K1's exact per-tile counts.  A tile's packed
// mask is its flat row-major bit array (bit r * rb + c at byte
// (r * rb + c) / 8), so the kernel reads each selected tile as 16-byte
// chunks, chunk q holding flat positions [128 q, 128 q + 128).
//
// The host passes, for each selected tile q: its index in packs, its first
// output position (the exclusive sum of the counts before it) and its code
// (the tile number of the encoding).  Two launches on one stream:
//   1. mc_count_kernel: block (s, q) sums the popcounts of segment s (SEG
//      chunks) of tile q into seg_counts[q][s];
//   2. mc_scatter_kernel: block (s, q) adds the counts of the segments
//      before s (a strided sum and a block reduction), then walks its
//      segment in STEPS steps of THREADS chunks: a block-wide exclusive scan
//      of the threads' popcounts gives each thread its first position, and
//      the thread writes its chunk's set bits in ascending order (__ffs).
// The order of the output is thus fixed by the scans, not by any race, and
// equals the JAX program's element for element.
//
// Row form (rtc_mask_compact_rows), the second half of kernel K6
// (rabbittclust_tpu/ops/greedy_device.py::_greedy_filter_fn): one (rows,
// 128 row_chunks) mask of a batch against its reps, written by K1's
// gathered form with whole 16-byte chunks a row; the same two launches
// number chunk c's bits (c / row_chunks) * out_cols + column, the JAX
// program's b_local * R + r_local, in order.
//
// Bound: device memory bandwidth.  The selected tiles' packed masks are
// read twice (count, then scatter; the second read mostly from the 50 MB L2
// at the stream generator's batch of 16 tiles of 1024^2, 2 MB) and 4 bytes
// are written per set bit.  Loads are 16 bytes a thread, neighbouring
// threads on neighbouring chunks (ld.global.nc).  The writes of a sparse
// mask are scattered; the kernel does not stage them.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream and returns the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEPS = 4;
constexpr int SEG = THREADS * STEPS;  // 16-byte chunks a block covers
constexpr unsigned FULL = 0xffffffffu;

// exclusive prefix of v over the block; *total receives the block's sum.
// Every thread of the block must call it.
__device__ int block_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int u = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    before += w < warp ? ws[w] : 0;
    all += ws[w];
  }
  __syncthreads();  // ws is rewritten by the next call
  *total = all;
  return before + incl - v;
}

__device__ __forceinline__ int popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ uint4 load_chunk(const uint4* tile, int c,
                                            int chunks) {
  return c < chunks ? __ldg(tile + c) : make_uint4(0u, 0u, 0u, 0u);
}

// tiles: (3, m) int32 = source tile, first output position, code; null:
// tile q, position 0, code 0
__global__ void __launch_bounds__(THREADS)
mc_count_kernel(const uint4* __restrict__ packs, const int* __restrict__ tiles,
                int chunks, int n_seg, int* __restrict__ seg_counts) {
  __shared__ int ws[THREADS / 32];
  const int q = blockIdx.y;
  const uint4* tile = packs + (size_t)(tiles ? tiles[q] : q) * chunks;
  const int c0 = blockIdx.x * SEG + threadIdx.x;
  int n = 0;
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    n += popc4(load_chunk(tile, c0 + s * THREADS, chunks));
  int total;
  block_scan(n, ws, &total);
  if (threadIdx.x == 0) seg_counts[(size_t)q * n_seg + blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
mc_scatter_kernel(const uint4* __restrict__ packs,
                  const int* __restrict__ tiles, int m, int chunks,
                  int n_seg, int tile_bits, int row_chunks, int out_cols,
                  const int* __restrict__ seg_counts, int limit,
                  int* __restrict__ out) {
  __shared__ int ws[THREADS / 32];
  const int q = blockIdx.y;
  const int* seg = seg_counts + (size_t)q * n_seg;
  int before = 0;
  for (int s = threadIdx.x; s < (int)blockIdx.x; s += THREADS)
    before += seg[s];
  int pos;
  block_scan(before, ws, &pos);
  pos += tiles ? tiles[m + q] : 0;
  // below 2^31 (wrapper)
  const int code = tiles ? tiles[2 * m + q] * tile_bits : 0;
  const uint4* tile = packs + (size_t)(tiles ? tiles[q] : q) * chunks;
  for (int s = 0; s < STEPS; ++s) {
    const int c = blockIdx.x * SEG + s * THREADS + threadIdx.x;
    const uint4 v = load_chunk(tile, c, chunks);
    int step_total;
    int p = pos + block_scan(popc4(v), ws, &step_total);
    const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      unsigned x = words[w];
      // row c / row_chunks of out_cols columns (one row a tile for the
      // square tiles)
      const int row = c / row_chunks;
      const int at = code + row * out_cols + (c - row * row_chunks) * 128 +
                     w * 32;
      while (x) {
        if (p < limit) out[p] = at + __ffs(x) - 1;
        ++p;
        x &= x - 1;
      }
    }
    pos += step_total;
  }
}

}  // namespace

extern "C" {

// packs: (k, rb, rb / 8) uint8, 16-byte aligned; tiles: (3, m) int32 =
// source tile, first output position, code, for the m selected tiles;
// seg_counts: scratch of m * ceil(rb^2 / 128 / SEG) int32; out: int32, no
// write at or past limit.  rb % 32 == 0 (a tile is whole 16-byte chunks),
// rb^2 < 2^31, 0 < m <= 65535; others return cudaErrorInvalidValue.
int rtc_mask_compact(const void* packs, const void* tiles, int m, int rb,
                     void* seg_counts, int limit, void* out, void* stream) {
  if (rb <= 0 || rb % 32 != 0 || (long long)rb * rb >= (1LL << 31) ||
      m <= 0 || m > 65535 || limit < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tile_bits = rb * rb;
  const int chunks = tile_bits / 128;
  const int n_seg = (chunks + SEG - 1) / SEG;
  const dim3 grid(n_seg, m);
  mc_count_kernel<<<grid, THREADS, 0, st>>>(
      (const uint4*)packs, (const int*)tiles, chunks, n_seg,
      (int*)seg_counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mc_scatter_kernel<<<grid, THREADS, 0, st>>>(
      (const uint4*)packs, (const int*)tiles, m, chunks, n_seg, tile_bits,
      chunks, 0, (const int*)seg_counts, limit, (int*)out);
  return (int)cudaGetLastError();
}

// K6's compaction: the set bits of one (rows, 128 row_chunks) packed mask,
// row-major, as int32 r * out_cols + c (c < out_cols <= 128 row_chunks),
// in order from out[0]; no write at or past limit.  seg_counts: scratch of
// ceil(rows * row_chunks / SEG) int32.  rows * out_cols < 2^31.
int rtc_mask_compact_rows(const void* packs, int rows, int row_chunks,
                          int out_cols, void* seg_counts, int limit,
                          void* out, void* stream) {
  if (rows <= 0 || row_chunks <= 0 || out_cols <= 0 ||
      out_cols > 128 * row_chunks ||
      (long long)rows * row_chunks * 128 >= (1LL << 31) || limit < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = rows * row_chunks;
  const int n_seg = (chunks + SEG - 1) / SEG;
  const dim3 grid(n_seg, 1);
  mc_count_kernel<<<grid, THREADS, 0, st>>>((const uint4*)packs, nullptr,
                                            chunks, n_seg, (int*)seg_counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mc_scatter_kernel<<<grid, THREADS, 0, st>>>(
      (const uint4*)packs, nullptr, 1, chunks, n_seg, 0, row_chunks,
      out_cols, (const int*)seg_counts, limit, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
