// Bitmap candidate filter (kernel K1) for Hopper.
//
// Replaces rabbittclust_tpu/ops/bitmap.py::_batched_mask_fn over _tile_mask
// (jitted jnp: an unpacked 0/1 bf16 product on the MXU, then a float32
// bound, a size-ratio gate, the strict lower triangle and a bit-pack).
// For every tile t of a batch (rows [r0s[t], +rb) x columns [c0s[t], +rb)
// of the resident signatures) it writes
//     counts[t]        number of candidate pairs of the tile (int32)
//     packs[t, i, :]   row i's candidate mask, rb/8 bytes, little bit order
// and both are exactly what the JAX program returns: the shared-bit count
// popcount(x_i & x_j) is exact integer arithmetic, and the float32 bound is
// evaluated with the same IEEE operations in the same order (__fmul_rn,
// __fadd_rn, __fdiv_rn: no FMA contraction, no fast-math division).  The
// (rb, rb) count matrix never reaches device memory.
//
// Design: a block computes a 32 x 32 pair sub-tile.  The rows' and
// columns' 64-bit signature words are staged in shared memory KW words at
// a time; warp w owns rows w, w+8, w+16, w+24 and lane l column l, so each
// thread keeps 4 counts in registers.  The epilogue packs the mask with one
// __ballot_sync per row (lane l -> bit l: little-endian bit order as it
// stands) and lane 0 stores the 32-bit word.  The tile count is a
// shared-memory sum plus one integer atomicAdd per block: exact in any
// order, and equal to the popcount of the packed mask by construction.
//
// Bound: popcount throughput.  A 4096^2 tile at 8192 bits is 2.1e9
// 64-bit popcounts (two POPC each; Hopper runs 16 per SM per clock), so
// ~1.2 ms per tile, ~0.6 s for the 528-tile sweep at N = 131,072.  Shared
// loads (5 per 4 popcounts) and L2 staging traffic stay below that.  A
// tensor-core form (int8 or b1 MMA over unpacked or packed bits) is later
// work.
//
// Plain C interface, loaded with ctypes; launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;          // rows and columns of a block's sub-tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = TILE / WARPS;
constexpr int KW = 32;            // signature words staged per step

enum Bound { kMst = 0, kGreedy = 1, kMinhash = 2 };

__global__ void __launch_bounds__(THREADS)
filter_mask_kernel(const uint64_t* __restrict__ sig, int words,
                   const int* __restrict__ coll,
                   const int* __restrict__ size_row,
                   const int* __restrict__ size_col,
                   const int* __restrict__ r0s, const int* __restrict__ c0s,
                   const int* __restrict__ valid, int rb, float jmin_num,
                   float jmin_den, float c_min, int radio_i, float radio_f,
                   int containment, int bound, int* __restrict__ counts,
                   uint32_t* __restrict__ packs) {
  const int t = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile_row = blockIdx.y * TILE;
  const int tile_col = blockIdx.x * TILE;
  const int64_t row_words = rb / 32;  // uint32 words of one packed row
  // this block's 32 columns of row 0 of the tile; 64-bit offsets: a panel
  // of 512 tiles at rb = 8192 is 4.3 GB of masks
  uint32_t* out = packs + (int64_t)t * rb * row_words + tile_col / 32;
  if (!valid[t]) {  // a padding slot: zeros, count 0
    if (threadIdx.x < TILE) out[(tile_row + threadIdx.x) * row_words] = 0u;
    return;
  }
  const int r0 = r0s[t] + tile_row;  // global id of the sub-tile's row 0
  const int c0 = c0s[t] + tile_col;

  // [word][genome], one column of padding against store bank conflicts
  __shared__ uint64_t sa[KW][TILE + 1];
  __shared__ uint64_t sb[KW][TILE + 1];
  __shared__ int block_count;
  if (threadIdx.x == 0) block_count = 0;

  int acc[ROWS_PER_WARP];
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) acc[q] = 0;
  for (int w0 = 0; w0 < words; w0 += KW) {
    const int kw = min(KW, words - w0);
    for (int e = threadIdx.x; e < TILE * kw; e += THREADS) {
      const int w = e % kw;
      const int g = e / kw;
      sa[w][g] = sig[(int64_t)(r0 + g) * words + w0 + w];
      sb[w][g] = sig[(int64_t)(c0 + g) * words + w0 + w];
    }
    __syncthreads();
    for (int w = 0; w < kw; ++w) {
      const uint64_t b = sb[w][lane];
#pragma unroll
      for (int q = 0; q < ROWS_PER_WARP; ++q)
        acc[q] += __popcll(sa[w][warp + q * WARPS] & b);
    }
    __syncthreads();
  }

  // epilogue: _tile_mask's bound, ratio gate and triangle, then the pack
  const int j = c0 + lane;
  const int sj = size_col[j];
  const int cj = coll[j];
  const float fj = (float)sj;
  int mine = 0;
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int local = warp + q * WARPS;
    const int i = r0 + local;
    const int si = size_row[i];
    const float fi = (float)si;
    const float mn_f = fminf(fi, fj);
    int common_min;
    if (containment) {
      common_min = (int)floorf(__fmul_rn(c_min, mn_f)) - 1;
    } else {
      common_min = (int)floorf(__fdiv_rn(
          __fmul_rn(jmin_num, __fadd_rn(fi, fj)), jmin_den)) - 1;
    }
    const int thresh = common_min - min(coll[i], cj);
    const int mni = min(si, sj);
    bool ok = mni > 0;  // padded rows and columns die here
    if (bound == kGreedy && !containment) {
      ok = ok && fmaxf(fi, fj) <= __fadd_rn(__fmul_rn(radio_f, mn_f), 1.0f);
    } else if (bound == kMst) {
      // int32 product, wrapping as in XLA
      ok = ok && max(si, sj) <= (int)((unsigned)radio_i * (unsigned)mni);
    }
    const bool m = ok && acc[q] >= thresh && j < i;
    const unsigned bits = __ballot_sync(0xffffffffu, m);
    if (lane == 0) {
      out[(int64_t)(tile_row + local) * row_words] = bits;
      mine += __popc(bits);
    }
  }
  if (lane == 0 && mine) atomicAdd(&block_count, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(&counts[t], block_count);
}

}  // namespace

extern "C" {

// sig: (n_pad, words) uint64 (the packed uint8 signatures); coll, size_row,
// size_col: (n_pad,) int32 (size_row == size_col except for the "minhash"
// bound); r0s/c0s/valid: (batch,) int32; counts: (batch,) int32, zeroed by
// the caller; packs: (batch, rb, rb / 8) uint8, 4-byte aligned.  rb % 32 == 0.
int rtc_filter_mask(const void* sig, int words, const void* coll,
                    const void* size_row, const void* size_col,
                    const void* r0s, const void* c0s, const void* valid,
                    int batch, int rb, float jmin_num, float jmin_den,
                    float c_min, int radio_i, float radio_f, int containment,
                    int bound, void* counts, void* packs, void* stream) {
  if (batch == 0) return 0;
  if (rb <= 0 || rb % TILE != 0 || words <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(rb / TILE, rb / TILE, batch);
  filter_mask_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)sig, words, (const int*)coll, (const int*)size_row,
      (const int*)size_col, (const int*)r0s, (const int*)c0s,
      (const int*)valid, rb, jmin_num, jmin_den, c_min, radio_i, radio_f,
      containment, bound, (int*)counts, (uint32_t*)packs);
  return (int)cudaGetLastError();
}

}  // extern "C"
