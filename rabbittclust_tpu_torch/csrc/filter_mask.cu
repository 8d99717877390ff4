// Bitmap candidate filter (kernel K1) for Hopper, on the tensor cores.
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
// A second kernel, filter_pair_kernel (the same tiles, loads and product
// over FilterArgs), carries one more JAX program; the square sweep keeps
// filter_mask_kernel as it was (one generalised kernel ran slower on the
// sweep).  The mesh rings' steps, which it carried before, have a kernel
// of their own (ring_step.cu):
//   - K6, rabbittclust_tpu/ops/greedy_device.py::_greedy_filter_fn: a
//     batch's rows and its reps' columns gathered through two index lists
//     in the loads (GATHER: the block's 256 genome ids staged in shared
//     memory once), a rows x cols rectangle with ragged edges, the greedy
//     bound, and the triangle on positions in its triangular mode.  K3's
//     row form (mask_compact.cu) then writes the set positions b * R + r
//     in order; rtc_greedy_filter launches both, and writes the count into
//     the output's first word, on the stream.
//
// filter_pair_kernel's triangular grid (K6's triangular mode; tile
// origins equal) is a 1-D grid over only the 128 x 128 blocks with some
// j < i (bx <= by, tri_block), so a 4096^2 triangle launches 528 of its
// 1,024 blocks; the blocks above are never written, and the caller hands
// in a zeroed mask.
//
// Bound: the shared-bit counts are a 0/1 matrix product, rb^2 * bits
// bit multiply-adds per tile.  A 4096^2 tile at 8192 bits is 1.37e11 of
// them, 2.75e11 operations.  As an int8 product that is 0.139 ms at the
// H100's 1,979 dense int8 TOP/s, the floor of an s8 form; this kernel's
// single-bit instruction carries 8 times the bits of an s8 one, so its
// bound is the same operations at the card's rate of that instruction.
// NVIDIA publishes none for the H100: mma_b1_peak_kernel below measures
// it, and ring_step.cu's wgmma_b1_peak_kernel the faster wgmma form
// (chip_smoke.py phase 3b); the bound takes the higher of the two.  The tile's
// bytes (two 4 MB signature row blocks, a 2 MB mask) take ~3 us at
// 3.35 TB/s.  The popcount form this replaces issued two POPC per 64-bit
// word on the CUDA cores (~1.15 ms per tile) and left the tensor cores
// idle.
//
// Design: popcount(x_i & x_j) summed over a signature is what the tensor
// cores' single-bit product computes: mma.sync m16n8k256 .b1 .and.popc
// with s32 accumulators, exact (counts <= bits).  It takes the packed
// signature words as they are, 256 bits of k an instruction, with no
// expansion of bits to bytes.  An s8 m16n8k32 form needs 8 times the
// instructions for the same bits, plus two integer operations per fragment
// register to expand the bits to 0/1 bytes; on an H100 (80GB HBM3, 700 W)
// it took 0.481 ms per 4096^2 tile at 8192 bits, this form 0.151 ms and,
// in a second run, 0.176 ms (chip_smoke.py phase 3b).
//
// A block owns 128 x 128 pairs: 8 warps as 2 x 4, each a 64 x 32 warp tile
// (4 x 4 fragments, 64 int32 accumulators a thread).  The packed words of
// the block's 128 rows and 128 columns come through a 3-deep cp.async ring
// in dynamic shared memory (96 KB, two blocks an SM), 1024 bits per genome
// a stage, in 16-byte copies (8-byte ones for 64-bit signatures).  A
// 256-bit k-step is 8 words of a genome; its fragments are the 64-bit
// words (2q, 2q + 1) of rows g and g + 8 and of column g (g = lane / 4,
// q = lane % 4).  The PTX fragment gives those registers the k bits
// [32q, +32) and [128 + 32q, +32); the count does not depend on the order
// of k, and rows and columns use the same mapping, so it is exact.  The
// k-step groups of each genome's 32 words are XOR-swizzled by (genome & 3)
// so that the four genomes of a half-warp's 64-bit loads fall on distinct
// banks.
//
// Epilogue: each thread holds the counts of 8 rows x 8 columns.  It applies
// _tile_mask's bound, ratio gate and triangle to them, ORs its 8 mask bits
// of a row into the row's 32-bit word, and two shuffles across the lane
// quad complete the word (little-endian bit order as it stands).  The tile
// count is the popcount of the stored words, a warp shuffle sum, one
// shared atomicAdd per warp and one global atomicAdd per block: exact in
// any order, and equal to the popcount of the packed mask by construction.
//
// Shapes: any rb that is a multiple of 32 (block tiles past rb % 128 are
// masked: a warp's 32 columns lie wholly inside or outside the tile; K6's
// rectangles take any rows and cols, columns past cols masked one by one),
// any
// bits that is a power of two of at least 64 (a short last stage is zero),
// batches up to 65,535.  Offsets into the masks are 64-bit: a panel of 512
// tiles at rb = 8192 is 4.3 GB.
//
// Plain C interface, loaded with ctypes; launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// K3's row form (mask_compact.cu), launched by rtc_greedy_filter
extern "C" int rtc_mask_compact_rows(const void* packs, int rows,
                                     int row_chunks, int out_cols,
                                     const void* count, void* scratch,
                                     int scratch_blocks, unsigned epoch,
                                     int limit, void* out, void* stream);

namespace {

constexpr int BM = 128;                  // rows of a block tile
constexpr int BN = 128;                  // columns of a block tile
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;         // 64 rows of a warp tile
constexpr int WN = BN / WARPS_N;         // 32 columns of a warp tile
constexpr int MT = WM / 16;              // m16 fragments of a warp tile
constexpr int NT = WN / 8;               // n8 fragments of a warp tile
constexpr int CHUNK64 = 16;              // signature words per genome a stage
constexpr int CHUNK32 = 2 * CHUNK64;     // the same in 32-bit words
constexpr int KSTEPS = CHUNK32 / 8;      // 256-bit k-steps a stage
constexpr int STAGES = 3;
constexpr int STAGE32 = (BM + BN) * CHUNK32;
constexpr int SMEM_BYTES = STAGES * STAGE32 * 4;
static_assert(WN == 32, "a warp tile's columns are one 32-bit mask word");
static_assert(KSTEPS == 4, "the swizzle spreads 4 genomes over 4 groups");
constexpr unsigned FULL = 0xffffffffu;

enum Bound { kMst = 0, kGreedy = 1, kMinhash = 2 };
// filter_pair_kernel's mode.  kGather: rows and columns gathered through
// index lists (K6), the triangle when tri, radio 0 disabling the gate
enum Mode { kGather = 1 };

__device__ __forceinline__ void cp_async8(uint32_t* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += popc(a (16 x 256 bits, row) & b (256 x 8 bits, col)), s32
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// shared-memory word of word w of genome g's stage chunk: the 8-word k-step
// groups XOR-swizzled by (g & 3)
__device__ __forceinline__ int swz(int g, int w) {
  return w ^ ((g & 3) << 3);
}

// Stage chunk `chunk` (64-bit words [16 chunk, +16)) of the block's rows
// (genomes row0 + [0, rows_left)) and columns into `stage`, laid out
// [genome 0..255][32 x uint32]: rows first, then columns.  Words past the
// signature are zero; genomes past the tile are left as they are (their
// counts are never stored).
__device__ __forceinline__ void load_chunk(uint32_t* stage,
                                           const uint64_t* __restrict__ sig,
                                           int words, int chunk, int64_t row0,
                                           int64_t col0, int rows_left,
                                           int cols_left) {
  const int w0 = chunk * CHUNK64;
  // 16-byte granules of two words; 64-bit signatures (words == 1) are not
  // 16-byte aligned and take 8-byte ones
  const int per = (words & 1) ? CHUNK64 : CHUNK64 / 2;
  const int gw = (words & 1) ? 1 : 2;  // 64-bit words a granule
  for (int e = threadIdx.x; e < (BM + BN) * per; e += THREADS) {
    const int g = e / per;
    const int w = (e % per) * gw;  // 64-bit word of the chunk
    uint32_t* dst = stage + g * CHUNK32 + swz(g, 2 * w);
    const bool is_row = g < BM;
    const int local = is_row ? g : g - BM;
    if (w0 + w >= words) {
      if (gw == 2)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
    } else if (local < (is_row ? rows_left : cols_left)) {
      const uint64_t* src =
          sig + ((is_row ? row0 : col0) + local) * words + w0 + w;
      if (gw == 2)
        cp_async16(dst, src);
      else
        cp_async8(dst, src);
    }
  }
}

// _tile_mask's bound, ratio gate and triangle for pair (i, j) with
// shared-bit count `shared`
__device__ __forceinline__ bool pair_ok(int shared, int i, int j, int si,
                                        int sj, int ci, int cj,
                                        float jmin_num, float jmin_den,
                                        float c_min, int radio_i,
                                        float radio_f, int containment,
                                        int bound) {
  const float fi = (float)si;
  const float fj = (float)sj;
  const float mn_f = fminf(fi, fj);
  int common_min;
  if (containment) {
    common_min = (int)floorf(__fmul_rn(c_min, mn_f)) - 1;
  } else {
    common_min = (int)floorf(__fdiv_rn(
        __fmul_rn(jmin_num, __fadd_rn(fi, fj)), jmin_den)) - 1;
  }
  const int thresh = common_min - min(ci, cj);
  const int mni = min(si, sj);
  bool ok = mni > 0;  // padded rows and columns die here
  if (bound == kGreedy && !containment) {
    ok = ok && fmaxf(fi, fj) <= __fadd_rn(__fmul_rn(radio_f, mn_f), 1.0f);
  } else if (bound == kMst) {
    // int32 product, wrapping as in XLA
    ok = ok && max(si, sj) <= (int)((unsigned)radio_i * (unsigned)mni);
  }
  return ok && shared >= thresh && j < i;
}

__global__ void __launch_bounds__(THREADS, 2)
filter_mask_kernel(const uint64_t* __restrict__ sig, int words,
                   const int* __restrict__ coll,
                   const int* __restrict__ size_row,
                   const int* __restrict__ size_col,
                   const int* __restrict__ r0s, const int* __restrict__ c0s,
                   const int* __restrict__ valid, int rb, float jmin_num,
                   float jmin_den, float c_min, int radio_i, float radio_f,
                   int containment, int bound, int* __restrict__ counts,
                   uint32_t* __restrict__ packs) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int block_count;
  const int t = blockIdx.z;
  const int tile_row = blockIdx.y * BM;
  const int tile_col = blockIdx.x * BN;
  const int64_t row_words = rb / 32;  // uint32 words of one packed row
  uint32_t* out = packs + (int64_t)t * rb * row_words;
  if (!valid[t]) {  // a padding slot: zeros, count 0
    const int nrow = min(BM, rb - tile_row);
    const int nw = min(BN, rb - tile_col) / 32;
    for (int e = threadIdx.x; e < nrow * nw; e += THREADS)
      out[(int64_t)(tile_row + e / nw) * row_words + tile_col / 32 + e % nw] =
          0u;
    return;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane / 4;  // fragment row / column group
  const int q = lane % 4;  // lane quad: k words 2q and 2q + 1 of a k-step
  const int r0 = r0s[t];
  const int c0 = c0s[t];
  const int rows_left = rb - tile_row;
  const int cols_left = rb - tile_col;
  const int64_t row0 = (int64_t)r0 + tile_row;
  const int64_t col0 = (int64_t)c0 + tile_col;
  if (threadIdx.x == 0) block_count = 0;

  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int chunks = (words + CHUNK64 - 1) / CHUNK64;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      load_chunk(smem + s * STAGE32, sig, words, s, row0, col0, rows_left,
                 cols_left);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; stage (c - 1) % STAGES is free
    const int next = c + STAGES - 1;
    if (next < chunks)
      load_chunk(smem + (next % STAGES) * STAGE32, sig, words, next, row0,
                 col0, rows_left, cols_left);
    cp_async_commit();
    const uint32_t* stage = smem + (c % STAGES) * STAGE32;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint2 a[MT][2];
      uint2 b[NT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = wm * WM + mi * 16 + h * 8 + g;  // row g (+ 8)
          a[mi][h] = *reinterpret_cast<const uint2*>(
              stage + gr * CHUNK32 + swz(gr, 8 * ks + 2 * q));
        }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int gc = BM + wn * WN + ni * 8 + g;  // column g
        b[ni] = *reinterpret_cast<const uint2*>(
            stage + gc * CHUNK32 + swz(gc, 8 * ks + 2 * q));
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mma_b1(acc[mi][ni], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y,
                 b[ni].x, b[ni].y);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (mi, ni, 2h + e) is row wm*64 + mi*16 + h*8 + g,
  // column wn*32 + ni*8 + 2q + e of the block tile
  const int col_w = tile_col + wn * WN;  // the warp's mask word, local
  int mine = 0;
  if (col_w < rb) {  // warp-uniform: rb % 32 == 0
    int jc[NT][2], sj[NT][2], cj[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = c0 + col_w + ni * 8 + 2 * q + e;
        jc[ni][e] = j;
        sj[ni][e] = size_col[j];
        cj[ni][e] = coll[j];
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = tile_row + wm * WM + mi * 16 + h * 8 + g;
        const bool row_in = local < rb;
        const int i = r0 + local;
        const int si = row_in ? size_row[i] : 0;
        const int ci = row_in ? coll[i] : 0;
        uint32_t word = 0u;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (pair_ok(acc[mi][ni][2 * h + e], i, jc[ni][e], si, sj[ni][e],
                        ci, cj[ni][e], jmin_num, jmin_den, c_min, radio_i,
                        radio_f, containment, bound))
              word |= 1u << (ni * 8 + 2 * q + e);
        word |= __shfl_xor_sync(FULL, word, 1);
        word |= __shfl_xor_sync(FULL, word, 2);
        if (row_in && ((mi * 2 + h) & 3) == q) {
          out[(int64_t)local * row_words + col_w / 32] = word;
          mine += __popc(word);
        }
      }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if (lane == 0 && mine) atomicAdd(&block_count, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(&counts[t], block_count);
}

// The operands of one launch.  Rows come from sig_r, columns from sig_c
// (the same signatures for the square sweep and for K6's gathers).
// Row position p of a tile is genome p (sig_r's row p) unless gat_r is set
// (K6: the genome is gat_r[p]); columns likewise.  A tile is rows x cols
// pairs from positions (r0s[t], c0s[t]); its mask rows are row_words uint32
// words apart.
struct FilterArgs {
  const uint64_t* sig_r;
  const uint64_t* sig_c;
  const int* coll_r;
  const int* coll_c;
  const int* size_r;
  const int* size_c;
  const int* gat_r;
  const int* gat_c;
  const int* r0s;
  const int* c0s;
  const int* valid;
  int* counts;
  uint32_t* packs;
  int words, rows, cols, row_words;
  float jmin_num, jmin_den, c_min, radio_f;
  int radio_i, containment, bound, tri;
  // blocks of the tile along columns and rows; tri_grid: the grid's x
  // enumerates the lower-triangle blocks (tri_block) instead of columns
  int nbx, nby, tri_grid;
};

// Block (by, bx) of the k-th block with bx <= by, row by row, of a tile of
// nby x nbx blocks: the blocks of a triangle on positions (column < row,
// equal origins) that hold some j < i.  The first min(nbx, nby) rows hold
// by + 1 blocks each, later rows all nbx.  ops/bitmap.py::tri_block is the
// same map on the host.
__host__ __device__ inline int tri_count(int nbx, int nby) {
  const int m = nbx < nby ? nbx : nby;
  return m * (m + 1) / 2 + (nby - m) * nbx;
}

__device__ __forceinline__ void tri_block(int k, int nbx, int nby, int& by,
                                          int& bx) {
  const int m = min(nbx, nby);
  const int head = m * (m + 1) / 2;
  if (k < head) {
    int y = (int)((sqrtf(8.0f * (float)k + 1.0f) - 1.0f) * 0.5f);
    while (y * (y + 1) / 2 > k) --y;  // float rounding, either way
    while ((y + 1) * (y + 2) / 2 <= k) ++y;
    by = y;
    bx = k - y * (y + 1) / 2;
  } else {
    by = m + (k - head) / nbx;
    bx = (k - head) % nbx;
  }
}

// load_chunk for filter_pair_kernel: rows from sig_r, columns from sig_c,
// the genomes gr[0, rows_left) and gc[...] under GATHER.
template <int MODE>
__device__ __forceinline__ void load_pair_chunk(uint32_t* stage,
                                           const FilterArgs& A, int chunk,
                                           int64_t row0, int64_t col0,
                                           const int64_t* gr,
                                           const int64_t* gc, int rows_left,
                                           int cols_left) {
  const int words = A.words;
  const int w0 = chunk * CHUNK64;
  // 16-byte granules of two words; 64-bit signatures (words == 1) are not
  // 16-byte aligned and take 8-byte ones
  const int per = (words & 1) ? CHUNK64 : CHUNK64 / 2;
  const int gw = (words & 1) ? 1 : 2;  // 64-bit words a granule
  for (int e = threadIdx.x; e < (BM + BN) * per; e += THREADS) {
    const int g = e / per;
    const int w = (e % per) * gw;  // 64-bit word of the chunk
    uint32_t* dst = stage + g * CHUNK32 + swz(g, 2 * w);
    const bool is_row = g < BM;
    const int local = is_row ? g : g - BM;
    if (w0 + w >= words) {
      if (gw == 2)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
    } else if (local < (is_row ? rows_left : cols_left)) {
      const int64_t gen = MODE == kGather
                              ? (is_row ? gr[local] : gc[local])
                              : (is_row ? row0 : col0) + local;
      const uint64_t* src =
          (is_row ? A.sig_r : A.sig_c) + gen * words + w0 +
          w;
      if (gw == 2)
        cp_async16(dst, src);
      else
        cp_async8(dst, src);
    }
  }
}

// pair_ok for filter_pair_kernel: the triangle on positions only when tri
__device__ __forceinline__ bool pair_gate(int shared, int i, int j, int si,
                                        int sj, int ci, int cj,
                                        const FilterArgs& A) {
  const float fi = (float)si;
  const float fj = (float)sj;
  const float mn_f = fminf(fi, fj);
  int common_min;
  if (A.containment) {
    common_min = (int)floorf(__fmul_rn(A.c_min, mn_f)) - 1;
  } else {
    common_min = (int)floorf(__fdiv_rn(
        __fmul_rn(A.jmin_num, __fadd_rn(fi, fj)), A.jmin_den)) - 1;
  }
  const int thresh = common_min - min(ci, cj);
  const int mni = min(si, sj);
  bool ok = mni > 0;  // padded rows and columns die here
  if (A.bound == kGreedy && !A.containment) {
    ok = ok && fmaxf(fi, fj) <= __fadd_rn(__fmul_rn(A.radio_f, mn_f), 1.0f);
  } else if (A.bound == kMst && A.radio_i != 0) {
    // int32 product, wrapping as in XLA; radio 0 disables the gate
    ok = ok && max(si, sj) <= (int)((unsigned)A.radio_i * (unsigned)mni);
  }
  return ok && shared >= thresh && (!A.tri || j < i);
}

// filter_mask_kernel over FilterArgs: K6
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
filter_pair_kernel(const FilterArgs A) {
  constexpr bool GATHER = MODE == kGather;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int block_count;
  // the block's genomes under GATHER
  __shared__ int64_t gr[GATHER ? BM : 1], gc[GATHER ? BN : 1];
  int by = blockIdx.y, bx = blockIdx.x;
  if (A.tri_grid) tri_block(blockIdx.x, A.nbx, A.nby, by, bx);
  const int t = blockIdx.z;
  const int tile_row = by * BM;
  const int tile_col = bx * BN;
  const int64_t row_words = A.row_words;
  uint32_t* out = A.packs + (int64_t)t * A.rows * row_words;
  if (!A.valid[t]) {  // a padding slot: zeros, count 0
    const int nrow = min(BM, A.rows - tile_row);
    const int nw = min(BN / 32, A.row_words - tile_col / 32);
    for (int e = threadIdx.x; e < nrow * nw; e += THREADS)
      out[(int64_t)(tile_row + e / nw) * row_words + tile_col / 32 + e % nw] =
          0u;
    return;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane / 4;  // fragment row / column group
  const int q = lane % 4;  // lane quad: k words 2q and 2q + 1 of a k-step
  const int r0 = A.r0s[t];
  const int c0 = A.c0s[t];
  const int rows_left = A.rows - tile_row;
  const int cols_left = A.cols - tile_col;
  const int64_t row0 = (int64_t)r0 + tile_row;
  const int64_t col0 = (int64_t)c0 + tile_col;
  if (GATHER) {
    for (int e = threadIdx.x; e < BM + BN; e += THREADS) {
      const bool is_row = e < BM;
      const int local = is_row ? e : e - BM;
      if (local < (is_row ? rows_left : cols_left))
        (is_row ? gr : gc)[local] =
            is_row ? A.gat_r[row0 + local] : A.gat_c[col0 + local];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) block_count = 0;

  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int chunks = (A.words + CHUNK64 - 1) / CHUNK64;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < chunks)
      load_pair_chunk<MODE>(smem + s * STAGE32, A, s, row0, col0, gr, gc,
                            rows_left, cols_left);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; stage (c - 1) % STAGES is free
    const int next = c + STAGES - 1;
    if (next < chunks)
      load_pair_chunk<MODE>(smem + (next % STAGES) * STAGE32, A, next,
                            row0, col0, gr, gc, rows_left, cols_left);
    cp_async_commit();
    const uint32_t* stage = smem + (c % STAGES) * STAGE32;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint2 a[MT][2];
      uint2 b[NT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr_ = wm * WM + mi * 16 + h * 8 + g;  // row g (+ 8)
          a[mi][h] = *reinterpret_cast<const uint2*>(
              stage + gr_ * CHUNK32 + swz(gr_, 8 * ks + 2 * q));
        }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int gc_ = BM + wn * WN + ni * 8 + g;  // column g
        b[ni] = *reinterpret_cast<const uint2*>(
            stage + gc_ * CHUNK32 + swz(gc_, 8 * ks + 2 * q));
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mma_b1(acc[mi][ni], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y,
                 b[ni].x, b[ni].y);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (mi, ni, 2h + e) is row wm*64 + mi*16 + h*8 + g,
  // column wn*32 + ni*8 + 2q + e of the block tile
  const int col_w = tile_col + wn * WN;  // the warp's mask word, local
  int mine = 0;
  if (col_w < A.row_words * 32) {  // warp-uniform
    int jc[NT][2], sj[NT][2], cj[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int local = col_w + ni * 8 + 2 * q + e;
        const bool col_in = local < A.cols;
        const int64_t gen =
            GATHER ? (col_in ? gc[local - tile_col] : 0) : (int64_t)c0 + local;
        jc[ni][e] = c0 + local;
        sj[ni][e] = col_in ? A.size_c[gen] : 0;  // 0: no pair
        cj[ni][e] = col_in ? A.coll_c[gen] : 0;
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = tile_row + wm * WM + mi * 16 + h * 8 + g;
        const bool row_in = local < A.rows;
        const int i = r0 + local;
        const int64_t gen =
            GATHER ? (row_in ? gr[local - tile_row] : 0) : (int64_t)i;
        const int si = row_in ? A.size_r[gen] : 0;
        const int ci = row_in ? A.coll_r[gen] : 0;
        uint32_t word = 0u;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (pair_gate(acc[mi][ni][2 * h + e], i, jc[ni][e], si, sj[ni][e],
                          ci, cj[ni][e], A))
              word |= 1u << (ni * 8 + 2 * q + e);
        word |= __shfl_xor_sync(FULL, word, 1);
        word |= __shfl_xor_sync(FULL, word, 2);
        if (row_in && ((mi * 2 + h) & 3) == q) {
          out[(int64_t)local * row_words + col_w / 32] = word;
          mine += __popc(word);
        }
      }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if (lane == 0 && mine) atomicAdd(&block_count, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(&A.counts[t], block_count);
}

// The rate of mma_b1 alone, for K1's bound: each thread runs CHAINS
// independent accumulator chains of `iters` instructions on registers,
// with no memory traffic but the one sum it stores.
template <int CHAINS>
__global__ void mma_b1_peak_kernel(int iters, int* __restrict__ out) {
  const int id = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t x = (uint32_t)id * 0x9e3779b9u;
  int acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[c][r] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      mma_b1(acc[c], x, x ^ 0x55555555u, ~x, x * 3u, x + c, x ^ 0x0f0f0f0fu);
  int s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) s += acc[c][r];
  out[id] = s;
}

// Past 48 KB of dynamic shared memory: raise kernel `slot`'s limit once
// per device, before its first launch there.  Slots: filter_pair_kernel
// <MODE> MODE, filter_mask_kernel 2.
cudaError_t allow_smem(const void* kernel, int slot) {
  static bool done[3][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[slot][dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    done[slot][dev] = true;
  }
  return cudaSuccess;
}

// One launch of filter_pair_kernel<MODE> over A (nbx, nby and tri_grid
// set): x covers the column blocks, or under tri_grid the lower-triangle
// blocks; y the row blocks (1 under tri_grid); z the batch.
template <int MODE>
cudaError_t launch_pair(const FilterArgs& A, int batch, cudaStream_t st) {
  const cudaError_t err =
      allow_smem((const void*)filter_pair_kernel<MODE>, MODE);
  if (err != cudaSuccess) return err;
  const dim3 grid(A.tri_grid ? tri_count(A.nbx, A.nby) : A.nbx,
                  A.tri_grid ? 1 : A.nby, batch);
  filter_pair_kernel<MODE><<<grid, THREADS, SMEM_BYTES, st>>>(A);
  return cudaGetLastError();
}

FilterArgs filter_args(const void* sig_r, const void* sig_c, int words,
                       const void* coll_r, const void* coll_c,
                       const void* size_r, const void* size_c,
                       const void* gat_r, const void* gat_c,
                       const void* r0s, const void* c0s, const void* valid,
                       int rows, int cols, int row_words, float jmin_num,
                       float jmin_den, float c_min, int radio_i,
                       float radio_f, int containment, int bound, int tri,
                       void* counts, void* packs) {
  FilterArgs A;
  A.sig_r = (const uint64_t*)sig_r;
  A.sig_c = (const uint64_t*)sig_c;
  A.coll_r = (const int*)coll_r;
  A.coll_c = (const int*)coll_c;
  A.size_r = (const int*)size_r;
  A.size_c = (const int*)size_c;
  A.gat_r = (const int*)gat_r;
  A.gat_c = (const int*)gat_c;
  A.r0s = (const int*)r0s;
  A.c0s = (const int*)c0s;
  A.valid = (const int*)valid;
  A.counts = (int*)counts;
  A.packs = (uint32_t*)packs;
  A.words = words;
  A.rows = rows;
  A.cols = cols;
  A.row_words = row_words;
  A.jmin_num = jmin_num;
  A.jmin_den = jmin_den;
  A.c_min = c_min;
  A.radio_f = radio_f;
  A.radio_i = radio_i;
  A.containment = containment;
  A.bound = bound;
  A.tri = tri != 0;
  A.nbx = (cols + BN - 1) / BN;
  A.nby = (rows + BM - 1) / BM;
  A.tri_grid = 0;
  return A;
}

}  // namespace

extern "C" {

// sig_r/sig_c: (n, words) uint64 (the packed uint8 signatures) of the
// rows and of the columns; coll_*, size_*: int32 per genome of each (size_r
// and size_c of one set differ for the "minhash" bound only); gat_r/gat_c:
// null, or int32 genome of each row/column position (K6); r0s/c0s/valid:
// (batch,) int32 tile origins in positions; counts: (batch,) int32, zeroed
// by the caller; packs: (batch, rows, row_words) uint32.  A tile is rows x
// cols pairs; ceil(cols / 32) <= row_words <= 4 ceil(cols / 128) (every
// word of a row is written).  tri: 0 every pair; 1 keep only column
// position < row position; 2 the same on tiles whose origins are equal
// (r0s[t] == c0s[t]), launching only the blocks with some j < i: the words
// of the blocks above are not written (zero them).  Only the square sweep
// and the gathered form (gat_r, gat_c set) launch; a ring step takes
// rtc_ring_step (ring_step.cu).
int rtc_filter_mask(const void* sig_r, const void* sig_c, int words,
                    const void* coll_r, const void* coll_c,
                    const void* size_r, const void* size_c,
                    const void* gat_r, const void* gat_c, const void* r0s,
                    const void* c0s, const void* valid, int batch, int rows,
                    int cols, int row_words, float jmin_num, float jmin_den,
                    float c_min, int radio_i, float radio_f, int containment,
                    int bound, int tri, void* counts, void* packs,
                    void* stream) {
  if (batch == 0) return 0;
  if (rows <= 0 || cols <= 0 || words <= 0 || batch > 65535 ||
      tri < 0 || tri > 2 ||
      row_words < (cols + 31) / 32 || row_words > 4 * ((cols + BN - 1) / BN) ||
      (gat_r == nullptr) != (gat_c == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // the square sweep (one set of signatures, square tiles, the triangle,
  // the ratio gate) takes filter_mask_kernel; the rest filter_pair_kernel
  const bool sweep = gat_r == nullptr && sig_c == sig_r &&
                     coll_c == coll_r && tri == 1 && rows == cols &&
                     row_words * 32 == cols && cols % 32 == 0 &&
                     (bound != kMst || radio_i != 0);
  if (sweep) {
    const cudaError_t err = allow_smem((const void*)filter_mask_kernel, 2);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((cols + BN - 1) / BN, (rows + BM - 1) / BM, batch);
    filter_mask_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        (const uint64_t*)sig_r, words, (const int*)coll_r,
        (const int*)size_r, (const int*)size_c, (const int*)r0s,
        (const int*)c0s, (const int*)valid, rows, jmin_num, jmin_den, c_min,
        radio_i, radio_f, containment, bound, (int*)counts,
        (uint32_t*)packs);
    return (int)cudaGetLastError();
  }
  if (gat_r == nullptr) return (int)cudaErrorInvalidValue;
  FilterArgs A = filter_args(sig_r, sig_c, words, coll_r, coll_c, size_r,
                             size_c, gat_r, gat_c, r0s, c0s, valid, rows,
                             cols, row_words, jmin_num, jmin_den, c_min,
                             radio_i, radio_f, containment, bound, tri,
                             counts, packs);
  A.tri_grid = tri == 2;
  return (int)launch_pair<kGather>(A, batch, st);
}

// K6 (rabbittclust_tpu/ops/greedy_device.py::_greedy_filter_fn) whole, on
// the stream: the fused int32 out = [count, b_local * R + r_local (cap)],
// -1 padded.  sig (n, words) uint64, coll and size (n,) int32 resident;
// gather (b + r,) int32: the batch's genomes, then the reps'; geo (3, 1)
// int32 = 0, 0, 1 (one tile at the origin); packs: scratch of (b,
// row_words) uint32, row_words = 4 ceil(r / 128); scratch, scratch_blocks,
// epoch: K3's (mask_compact.cu; at least ceil(b * row_words /
// 4096) status words); tri: keep column position < row position (a
// triangular grid of the blocks with some j < i).
// The count goes straight from K1's atomics into out[0], and K3 takes it
// from there.
int rtc_greedy_filter(const void* sig, int words, const void* coll,
                      const void* size, const void* gather, const void* geo,
                      int b, int r, int row_words, float jmin_num,
                      float jmin_den, float c_min, float radio_f,
                      int containment, int tri, void* packs,
                      void* scratch, int scratch_blocks, unsigned epoch,
                      int cap, void* out, void* stream) {
  if (b <= 0 || r <= 0 || words <= 0 || cap < 0 ||
      row_words != 4 * ((r + BN - 1) / BN))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int* o = (int*)out;
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(int), st);  // the count
  if (err == cudaSuccess)  // -1 past the written positions
    err = cudaMemsetAsync(o + 1, 0xff, (size_t)cap * sizeof(int), st);
  if (err == cudaSuccess && tri)  // the blocks above are not launched
    err = cudaMemsetAsync(packs, 0, (size_t)b * row_words * 4, st);
  if (err != cudaSuccess) return (int)err;
  const int* gi = (const int*)gather;
  const int* g = (const int*)geo;
  FilterArgs A = filter_args(sig, sig, words, coll, coll, size, size, gi,
                             gi + b, g, g + 1, g + 2, b, r, row_words,
                             jmin_num, jmin_den, c_min, 0, radio_f,
                             containment, kGreedy, tri, o, packs);
  A.tri_grid = tri != 0;
  err = launch_pair<kGather>(A, 1, st);
  if (err != cudaSuccess) return (int)err;
  return rtc_mask_compact_rows(packs, b, row_words / 4, r, o, scratch,
                               scratch_blocks, epoch, cap, o + 1, stream);
}

// The rate probe: blocks x threads threads (threads a multiple of 32), each
// warp issuing iters * chains m16n8k256 instructions in `chains` (4, 8 or
// 16) independent chains; out: (blocks * threads,) int32.
int rtc_mma_b1_peak(int chains, int blocks, int threads, int iters,
                    void* out, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || threads % 32 != 0 ||
      iters <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (chains == 4)
    mma_b1_peak_kernel<4><<<blocks, threads, 0, s>>>(iters, (int*)out);
  else if (chains == 8)
    mma_b1_peak_kernel<8><<<blocks, threads, 0, s>>>(iters, (int*)out);
  else if (chains == 16)
    mma_b1_peak_kernel<16><<<blocks, threads, 0, s>>>(iters, (int*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
