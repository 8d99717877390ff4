// Label-propagation round (kernel K2) for Hopper.
//
// Replaces rabbittclust_tpu/ops/labelprop.py::_round_fn and
// _round_fn_compact (jitted jnp scans over the resident packed masks).  One
// round is a fixed sequence of launches on one stream, with no host
// synchronisation:
//   1. lp_prepare_kernel: row_p = col_p = SENT, cross = 0, and the bits of
//      the clear list (pairs the host verified as failing) cleared with
//      atomicAnd(~(sub << 8 * (off & 3))) on the 32-bit word holding byte
//      off.  Two entries may name one byte (two failed pairs of one row
//      whose columns share a byte); atomicAnd clears both.  No-op entries
//      have sub == 0.  The masks are updated in place: the JAX round
//      donates them.
//   2. lp_round_kernel: for every valid tile, each set bit (i, j) whose
//      endpoints carry different labels counts into cross and proposes
//      row_p[i] = min j and col_p[j] = min i.  Integer sum and min give the
//      same result in any order, so the outputs equal JAX's element for
//      element.
//   3. lp_compact_kernel (compact variant only): [cross, ncol,
//      row_p[r_lo, +span), col_idx(cap), col_val(cap)], col_idx the first
//      cap proposing columns in ascending order padded with 0, col_val
//      col_p at those indices (jnp.nonzero(size=cap, fill_value=0)).
//
// Bound: device memory bandwidth.  A round reads the panel's masks once
// (1.07 GB for 512 tiles at rb = 4096: ~0.35 ms at 3 TB/s) plus the labels.
// Design: a block owns 128 rows of one tile and keeps the tile's column
// labels and a column-min buffer in shared memory, so set bits cost shared
// loads and shared atomicMin; per row one warp-reduced global atomicMin,
// per column one global atomicMin after the block, per block one
// atomicAdd for cross.  Zero words are skipped by whole 32-bit words.
//
// Plain C interface, loaded with ctypes; every entry point launches on the
// given stream and returns the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SENT = 1 << 30;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 128;          // rows of a tile per block
constexpr int COMPACT_THREADS = 1024;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// fused: [cross, row_p(n_pad), col_p(n_pad)]; clr: (4, n_clr) int32 rows
// t, r, b, sub (t local to the resident masks)
__global__ void lp_prepare_kernel(int* __restrict__ fused, int64_t n_fused,
                                  uint32_t* __restrict__ packs,
                                  const int* __restrict__ clr, int n_clr,
                                  int rb) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t end = n_fused > n_clr ? n_fused : n_clr;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < end;
       e += stride) {
    if (e < n_fused) fused[e] = e == 0 ? 0 : SENT;
    if (e < n_clr) {
      const unsigned sub = (unsigned)clr[3 * (int64_t)n_clr + e] & 0xffu;
      if (sub) {
        const int64_t off =
            ((int64_t)clr[e] * rb + clr[n_clr + e]) * (rb / 8) +
            clr[2 * (int64_t)n_clr + e];
        atomicAnd(packs + off / 4, ~(sub << (8 * (off & 3))));
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lp_round_kernel(const uint32_t* __restrict__ packs,
                const int* __restrict__ labels, const int* __restrict__ r0s,
                const int* __restrict__ c0s, const int* __restrict__ valid,
                int rb, int* __restrict__ fused, int n_pad) {
  const int t = blockIdx.y;
  if (!valid[t]) return;
  const int r0 = r0s[t];
  const int c0 = c0s[t];
  int* cross = fused;
  int* row_p = fused + 1;
  int* col_p = fused + 1 + n_pad;
  extern __shared__ int smem[];
  int* lc = smem;        // column labels of the tile
  int* cmin = smem + rb; // min proposing row per column, this block
  for (int c = threadIdx.x; c < rb; c += THREADS) {
    lc[c] = labels[c0 + c];
    cmin[c] = SENT;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row_words = rb / 32;
  const int row_lo = blockIdx.x * ROWS;
  int mine = 0;
  for (int k = warp; k < ROWS && row_lo + k < rb; k += WARPS) {
    const int i = row_lo + k;  // tile-local row
    const int gi = r0 + i;
    const int li = labels[gi];
    const uint32_t* row = packs + ((int64_t)t * rb + i) * row_words;
    int rmin = SENT;
    for (int w = lane; w < row_words; w += 32) {
      uint32_t bits = row[w];
      while (bits) {
        const int j = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (lc[j] != li) {
          ++mine;
          rmin = min(rmin, j);
          atomicMin(&cmin[j], gi);
        }
      }
    }
    rmin = warp_min(rmin);
    if (lane == 0 && rmin < SENT) atomicMin(&row_p[gi], c0 + rmin);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < rb; c += THREADS)
    if (cmin[c] < SENT) atomicMin(&col_p[c0 + c], cmin[c]);
  mine = warp_sum(mine);
  if (lane == 0 && mine) atomicAdd(cross, mine);
}

// one block: an ordered stream compaction of col_p < SENT
__global__ void __launch_bounds__(COMPACT_THREADS)
lp_compact_kernel(const int* __restrict__ fused, int n_pad, int r_lo,
                  int span, int cap, int* __restrict__ out) {
  const int* row_p = fused + 1;
  const int* col_p = fused + 1 + n_pad;
  int* o_idx = out + 2 + span;
  int* o_val = o_idx + cap;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int e = tid; e < span; e += COMPACT_THREADS) out[2 + e] = row_p[r_lo + e];
  __shared__ int warp_off[COMPACT_THREADS / 32];
  __shared__ int chunk_total;
  int base = 0;  // proposing columns before this chunk (same in all threads)
  for (int c0 = 0; c0 < n_pad; c0 += COMPACT_THREADS) {
    const int c = c0 + tid;
    const bool p = c < n_pad && col_p[c] < SENT;
    const unsigned bal = __ballot_sync(0xffffffffu, p);
    if (lane == 0) warp_off[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 32 warp counts
      const int v = warp_off[lane];
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      warp_off[lane] = incl - v;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    const int pos = base + warp_off[warp] + __popc(bal & ((1u << lane) - 1u));
    if (p && pos < cap) {
      o_idx[pos] = c;
      o_val[pos] = col_p[c];
    }
    base += chunk_total;
    __syncthreads();  // warp_off and chunk_total are rewritten next chunk
  }
  const int filled = base < cap ? base : cap;
  for (int e = filled + tid; e < cap; e += COMPACT_THREADS) {
    o_idx[e] = 0;
    o_val[e] = col_p[0];
  }
  if (tid == 0) {
    out[0] = fused[0];
    out[1] = base;
  }
}

int launch_round(void* packs, const void* labels, const void* clr, int n_clr,
                 const void* r0s, const void* c0s, const void* valid,
                 int n_tiles, int rb, int n_pad, void* fused,
                 cudaStream_t st) {
  const int64_t n_fused = 1 + 2 * (int64_t)n_pad;
  const int64_t work = n_fused > n_clr ? n_fused : n_clr;
  int64_t prep_blocks = (work + THREADS - 1) / THREADS;
  if (prep_blocks > 4096) prep_blocks = 4096;  // grid-stride beyond
  lp_prepare_kernel<<<(unsigned)prep_blocks, THREADS, 0, st>>>(
      (int*)fused, n_fused, (uint32_t*)packs, (const int*)clr, n_clr, rb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_tiles == 0) return 0;
  const size_t smem = 2 * (size_t)rb * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lp_round_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((rb + ROWS - 1) / ROWS, n_tiles);
  lp_round_kernel<<<grid, THREADS, smem, st>>>(
      (const uint32_t*)packs, (const int*)labels, (const int*)r0s,
      (const int*)c0s, (const int*)valid, rb, (int*)fused, n_pad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// packs: (n_tiles, rb, rb / 8) uint8, 4-byte aligned, updated in place;
// labels: (n_pad,) int32; clr: (4, n_clr) int32; r0s/c0s/valid:
// (n_tiles,) int32; fused: (1 + 2 * n_pad,) int32 output.
// rb % 32 == 0, rb <= 16384 (two int32 per column in shared memory).
int rtc_lp_round(void* packs, const void* labels, const void* clr,
                 int n_clr, const void* r0s, const void* c0s,
                 const void* valid, int n_tiles, int rb, int n_pad,
                 void* fused, void* stream) {
  if (rb <= 0 || rb % 32 != 0 || rb > 16384 || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_round(packs, labels, clr, n_clr, r0s, c0s, valid, n_tiles,
                      rb, n_pad, fused, (cudaStream_t)stream);
}

// rtc_lp_round into the scratch ``fused``, then out: (2 + span + 2 * cap,)
// int32 = [cross, ncol, row_p[r_lo, +span), col_idx(cap), col_val(cap)].
int rtc_lp_round_compact(void* packs, const void* labels, const void* clr,
                         int n_clr, const void* r0s, const void* c0s,
                         const void* valid, int n_tiles, int rb, int n_pad,
                         void* fused, int r_lo, int span, int cap, void* out,
                         void* stream) {
  if (rb <= 0 || rb % 32 != 0 || rb > 16384 || n_tiles > 65535 ||
      r_lo < 0 || span < 0 || r_lo + span > n_pad || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_round(packs, labels, clr, n_clr, r0s, c0s, valid,
                               n_tiles, rb, n_pad, fused, st);
  if (err != 0) return err;
  lp_compact_kernel<<<1, COMPACT_THREADS, 0, st>>>(
      (const int*)fused, n_pad, r_lo, span, cap, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
