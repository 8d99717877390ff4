// The mesh rings' slab step (kernel K9c, also K9b's step) for Hopper, on
// wgmma and TMA.
//
// Replaces the step of rabbittclust_tpu/parallel/dist_engine.py
// ::build_ring_masks_fn (:620) and ::build_ring_bitmap_fn (:296): for the
// local shard's rows against the visiting shard's columns, every pair's
// shared-bit count popcount(x_i & x_j) against the float32 bound of
// _tile_mask (rabbittclust_tpu/ops/bitmap.py:228; __fmul_rn, __fadd_rn,
// __fdiv_rn, no FMA contraction), nonzero sizes, the size-ratio gate (off
// at radio 0) and, on the self step only, the strict lower triangle j < i
// in local positions.  It writes the packed mask (rows, row_words) uint32,
// bit c % 32 of word c / 32 for column c (little-endian in the word), and
// adds the number of its set bits into `count`.  Words of tiles it does
// not visit (above the diagonal of a self step) keep the caller's zeros.
//
// Bound: the counts are a 0/1 matrix product, rows * cols * bits bit
// multiply-adds (2 operations each), at the card's rate of its single-bit
// tensor-core instruction, which NVIDIA does not publish for the H100:
// wgmma_b1_peak_kernel below measures it (chip_smoke.py phase 3b: about
// 1.7 times mma.sync m16n8k256's rate).  A 16384^2 step at 8192 bits is
// 4.4e15 operations; its 32 MB mask and 32 MB of signatures are ~20 us at
// 3.35 TB/s.  What holds the step above its bound is the epilogue's
// float32 gate, which the tensor cores wait for, and the operands' reads
// from L2 (PERF.md).
//
// Design:
//   - The product: wgmma.mma_async m64n256k256 .s32.b1.b1.and.popc, both
//     operands K-major in shared memory, which is the signatures' own
//     layout (a genome's packed words in k order).  The count does not
//     depend on how the instruction orders k, since rows and columns share
//     the layout, so it is exact.
//   - Operands by TMA: a tensor map a shard over its (rows, bits / 8)
//     bytes, box 128 B x 128 genomes with 128-byte swizzle; one stage is
//     1,024 bits of each of the tile's 128 rows and 256 columns (48 KB),
//     in a 4-deep ring of stages under full/empty mbarriers.  Signatures
//     shorter than 1,024 bits take the box as it is: TMA fills the bytes
//     past a row with zeros, and only the k-steps that hold bits are
//     issued.  64-bit signatures have an 8-byte row stride, which TMA
//     refuses (strides are multiples of 16): the producer warp writes
//     their words into the swizzled rows itself (the rest of each stage
//     is zeroed once), behind a proxy fence.
//   - A persistent grid of one CTA an SM (the tensor maps and the stage
//     ring are set up once) walks the step's 128 x 256 tiles in turn:
//     every tile of a full step, on a self step only the tiles holding
//     some j < i, row by row (ring_tile_next; ops/bitmap.py::ring_tiles is
//     the same walk on the host).  Warp 8 of a producer warpgroup (40
//     registers a thread after setmaxnreg) issues the loads and runs ahead
//     into the next tile's stages while warps 0-7, two consumer
//     warpgroups of 64 rows x 256 columns (128 s32 accumulators a thread,
//     232 registers), run this tile's epilogue.  Each consumer keeps one
//     commit group in flight and releases a stage when the next is
//     issued.  A 128 x 256 tile reads its operands once per 32,768 pairs,
//     against once per 16,384 for the 128 x 128 blocks of
//     filter_pair_kernel.
//   - The epilogue: wgmma's accumulator d[4i + 2h + e] is row 16 warp +
//     lane / 4 + 8h of the warpgroup's 64 and column 8i + 2(lane % 4) + e,
//     the m16n8 layout, so a row's 32-bit mask word gathers 8 bits a lane
//     and two shuffles across the lane quad complete it.  The tile's column
//     sizes and collisions are staged in shared memory (two buffers, one a
//     tile in turn).  The bound's division is div_rn below: __fdiv_rn's
//     called slow path made ptxas spill the accumulators.  Each thread sums
//     the popcounts of the words it stores over all its tiles; one
//     atomicAdd a warp at the end: exact in any order.
//
// Shapes: any rows and cols (the ring's are multiples of 32), signatures
// of 1 or an even number of 64-bit words (64 to 8,192 bits and more).
//
// Plain C interface, loaded with ctypes; launches on the given stream and
// returns the cudaError_t of the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

namespace {

constexpr int BM = 128;                  // rows of a tile (two warpgroups)
constexpr int BN = 256;                  // columns of a tile
constexpr int STAGES = 4;
constexpr int CHUNK = 128;               // bytes of a genome a stage
constexpr int A_BYTES = BM * CHUNK;      // 16 KB
constexpr int B_BYTES = BN * CHUNK;      // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + 1 KB alignment
constexpr int CONSUMERS = 256;           // warps 0-7
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr unsigned FULL = 0xffffffffu;

struct RingArgs {
  const uint64_t* sig_r;  // read directly only for 64-bit signatures
  const uint64_t* sig_c;
  const int* coll_r;
  const int* coll_c;
  const int* size_r;
  const int* size_c;
  int* count;
  uint32_t* packs;
  int words, rows, cols, row_words;
  float jmin_num, jmin_den, c_min;
  int radio_i, containment, tri;
  int nbx, nby, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// box (x bytes, y genomes) of the tensor map into shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand with 128-byte
// swizzle: rows of 128 B, 8-row groups 1,024 B apart (tile bases are
// 1,024-byte aligned)
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 256, s32) += popc(a (64 x 256 bits) & b (256 x 256 bits)), or
// d = ... when scale_d is 0
__device__ __forceinline__ void wgmma_b1_n256(int (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keeps the compiler from touching the accumulators before the wait
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Tiles of row block by that hold some pair j < i (self step), else every
// column block; ops/bitmap.py::ring_tiles walks the same rows.
__host__ __device__ inline int ring_row_tiles(int by, const RingArgs& A) {
  if (!A.tri) return A.nbx;
  const int end = by * BM + BM < A.rows ? by * BM + BM : A.rows;
  const int i_max = end - 1;  // the block's last row
  if (i_max < 1) return 0;
  const int n = (i_max - 1) / BN + 1;  // column blocks starting below i_max
  return n < A.nbx ? n : A.nbx;
}

// advance (by, bx) by `step` tiles of the walk (row by row)
__device__ __forceinline__ void ring_tile_next(int step, int& by, int& bx,
                                               const RingArgs& A) {
  bx += step;
  while (by < A.nby) {
    const int n = ring_row_tiles(by, A);
    if (bx < n) break;
    bx -= n;
    ++by;
  }
}

// a / b rounded to nearest (IEEE __fdiv_rn) for b in [1, 2] and a = 0 or
// a >= 2^-100, given y = __frcp_rn(b): q0 = a y is within 1.5 ulp of a / b,
// one correction (r = a - b q exact by fma) brings it within 1 ulp, and a
// second one then rounds to the correctly rounded quotient (Markstein's
// theorem: y within half an ulp of 1 / b, q within an ulp of a / b).  The
// range keeps every remainder normal.  __fdiv_rn itself branches to a
// called slow path that spilled the accumulators of the epilogue.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  float r = __fmaf_rn(-q, b, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-q, b, a);
  return __fmaf_rn(r, y, q);
}

// A column of the tile, staged in shared memory: size, collisions, size as
// float32
struct Col {
  int size, coll;
  float fsize;
  int pad;
};

// KS: the 256-bit k-steps of a stage that hold signature bits (4, or 1 or
// 2 for signatures shorter than 1,024 bits); CONT: the containment bound
template <int KS, bool CONT>
__global__ void __launch_bounds__(THREADS, 1)
ring_step_kernel(const __grid_constant__ CUtensorMap map_r,
                 const __grid_constant__ CUtensorMap map_c,
                 const RingArgs A) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ __align__(16) Col cols[2][BN];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool manual = A.words == 1;  // 64-bit signatures: no TMA
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (manual) {  // the bytes the producer never writes stay zero
    for (int e = threadIdx.x; e < STAGES * STAGE_BYTES / 16; e += THREADS)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int chunks = (A.words * 8 + CHUNK - 1) / CHUNK;

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: warp 8 loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != CONSUMERS / 32) return;
    int s = 0, ph = 0;
    int by = 0, bx = 0;
    ring_tile_next(blockIdx.x, by, bx, A);
    for (int t = blockIdx.x; t < A.n_tiles; t += gridDim.x) {
      const int row0 = by * BM, col0 = bx * BN;
      const bool second = col0 + BN / 2 < A.cols;  // the second B box
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        if (manual) {
          for (int g = lane; g < BM + BN; g += 32) {
            const bool is_row = g < BM;
            const int r = is_row ? g : g - BM;
            const int gen = (is_row ? row0 : col0) + r;
            const uint64_t w =
                gen < (is_row ? A.rows : A.cols)
                    ? (is_row ? A.sig_r : A.sig_c)[gen] : 0ull;
            // word 0 of the row, in 16-byte chunk (0 ^ (r % 8))
            *reinterpret_cast<uint64_t*>(st + (is_row ? 0 : A_BYTES) +
                                         r * CHUNK + (r & 7) * 16) = w;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        } else if (lane == 0) {
          mbar_expect_tx(&full[s], A_BYTES + (second ? B_BYTES : B_BYTES / 2));
          tma_load(st, &map_r, &full[s], c * CHUNK, row0);
          tma_load(st + A_BYTES, &map_c, &full[s], c * CHUNK, col0);
          if (second)
            tma_load(st + A_BYTES + B_BYTES / 2, &map_c, &full[s], c * CHUNK,
                     col0 + BN / 2);
        }
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      ring_tile_next(gridDim.x, by, bx, A);
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, +64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp / 4;
  const int g = lane / 4;  // accumulator row group
  const int q = lane % 4;  // lane quad: columns 2q, 2q + 1 of each 8
  const float y = __frcp_rn(A.jmin_den);
  int d[128];
#pragma unroll
  for (int r = 0; r < 128; ++r) d[r] = 0;
  int s = 0, ph = 0, buf = 0;
  int mine = 0;
  int by = 0, bx = 0;
  ring_tile_next(blockIdx.x, by, bx, A);
  for (int t = blockIdx.x; t < A.n_tiles; t += gridDim.x) {
    const int row0 = by * BM, col0 = bx * BN;
    {  // the tile's columns, one a consumer thread; size 0: no pair
      const int j = col0 + threadIdx.x;
      const int sj = j < A.cols ? A.size_c[j] : 0;
      cols[buf][threadIdx.x] =
          Col{sj, j < A.cols ? A.coll_c[j] : 0, (float)sj, 0};
    }
    // this lane's rows li[h]; columns from ilim[h] on fail the triangle
    int li[2], si[2], ci[2], ilim[2];
    float fi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      li[h] = row0 + 64 * wg + 16 * (warp % 4) + g + 8 * h;
      const bool in = li[h] < A.rows;
      si[h] = in ? A.size_r[li[h]] : 0;
      ci[h] = in ? A.coll_r[li[h]] : 0;
      fi[h] = (float)si[h];
      ilim[h] = A.tri ? li[h] : 0x7fffffff;
    }
    // the buffer written above was last read by the epilogue two tiles
    // back, which every consumer finished before the previous barrier
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    // one commit group a stage, the previous one left in flight: a
    // stage is released once the group after it has been issued
    int prev = -1;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[s], ph);
      const uint8_t* st = smem + s * STAGE_BYTES;
      const uint64_t da = smem_desc(st + wg * (A_BYTES / 2));
      const uint64_t db = smem_desc(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)  // + 32 bytes of k: 2 in a descriptor
        wgmma_b1_n256(d, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);
    fence_acc(d);

    // epilogue: word wd of row li[h] holds columns col0 + 32 wd + [0, 32);
    // this lane's are 8 ii + 2q + e, accumulator 4 (4 wd + ii) + 2h + e.
    // _tile_mask's bound ("mst"), in the JAX program's float32 operations:
    // shared >= floor(jmin_num (fi + fj) / jmin_den) - 1 - min(ci, cj)
    // (containment: floor(c_min min(fi, fj)) - 1 - min(ci, cj)), as
    // shared + 2 + min(ci, cj) > the float32 quotient (integers < 2^24 are
    // exact); nonzero sizes; the ratio gate unless radio is 0 (an int32
    // product, wrapping as in XLA); j < i on a self step.
#pragma unroll
    for (int wd = 0; wd < BN / 32; ++wd) {
      const int wcol = col0 + 32 * wd;
      const bool word_in = wcol < A.row_words * 32;
      Col cj[8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cj[2 * ii + e] = cols[buf][32 * wd + 8 * ii + 2 * q + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t word = 0u;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const Col& c = cj[2 * ii + e];
            const int lc = 32 * wd + 8 * ii + 2 * q + e;
            const float quot =
                CONT ? __fmul_rn(A.c_min, fminf(fi[h], c.fsize))
                     : div_rn(__fmul_rn(A.jmin_num, __fadd_rn(fi[h], c.fsize)),
                              A.jmin_den, y);
            const int shared = d[4 * (4 * wd + ii) + 2 * h + e];
            const int mn = min(si[h], c.size);
            const bool ok =
                mn > 0 &&
                (A.radio_i == 0 ||
                 max(si[h], c.size) <=
                     (int)((unsigned)A.radio_i * (unsigned)mn)) &&
                (float)(shared + 2 + min(ci[h], c.coll)) > quot &&
                col0 + lc < ilim[h];
            word |= (uint32_t)ok << (8 * ii + 2 * q + e);
          }
        word |= __shfl_xor_sync(FULL, word, 1);
        word |= __shfl_xor_sync(FULL, word, 2);
        if (word_in && li[h] < A.rows && (wd & 3) == q) {
          A.packs[(int64_t)li[h] * A.row_words + wcol / 32] = word;
          mine += __popc(word);
        }
      }
    }
    buf ^= 1;
    ring_tile_next(gridDim.x, by, bx, A);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if (lane == 0 && mine) atomicAdd(A.count, mine);
}

// The rate of wgmma m64n256k256 .b1 alone, for the bound of the .b1
// kernels: each warpgroup issues `per` instructions a commit group,
// `iters` groups, on operands in shared memory, registers untouched but
// the accumulators, one sum stored a thread.
template <int PER>
__global__ void __launch_bounds__(384, 1)
wgmma_b1_peak_kernel(int iters, int* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  for (int i = threadIdx.x; i < STAGE_BYTES / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = (uint32_t)i * 0x9e3779b9u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x / 128;
  int d[128];
#pragma unroll
  for (int r = 0; r < 128; ++r) d[r] = 0;
  const uint64_t da = smem_desc(smem + (wg & 1) * (A_BYTES / 2));
  const uint64_t db = smem_desc(smem + A_BYTES);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PER; ++j)
      wgmma_b1_n256(d, da + 2 * (j & 3), db + 2 * (j & 3), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_acc(d);
  int sum = 0;
#pragma unroll
  for (int r = 0; r < 128; ++r) sum += d[r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// the tensor map of (n, words) uint64 signatures as (n, 8 words) bytes,
// box 128 B x 128 genomes, 128-byte swizzle, zeros past the edges
bool sig_map(CUtensorMap* map, const void* sig, int n, int words) {
  memset(map, 0, sizeof(*map));
  if (words == 1) return true;  // read directly
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)words * 8, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)words * 8};
  const cuuint32_t box[2] = {CHUNK, BM};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(sig),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the device's SM count and, once a device, the kernel's shared-memory
// limit raised past 48 KB
cudaError_t prepare(int* sms) {
  static int known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!known[dev]) {
    for (const void* k :
         {(const void*)ring_step_kernel<1, false>,
          (const void*)ring_step_kernel<2, false>,
          (const void*)ring_step_kernel<4, false>,
          (const void*)ring_step_kernel<1, true>,
          (const void*)ring_step_kernel<2, true>,
          (const void*)ring_step_kernel<4, true>})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(k,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wgmma_b1_peak_kernel<16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 STAGE_BYTES + 1024);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&known[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      known[dev] = 0;
      return err;
    }
  }
  *sms = known[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One ring step: sig_r (rows, words) and sig_c (cols, words) uint64
// signatures (16-byte aligned unless words is 1), coll_* and size_* int32
// per genome of each side; count (1,) int32, added to; packs (rows,
// row_words) uint32 with ceil(cols / 32) <= row_words <= 8 ceil(cols /
// 256) (every word of a visited tile's row is written).  tri: keep only
// column < row and visit only the tiles holding such pairs (a ring's self
// step; the other words keep their values).  words must be 1 or even.
int rtc_ring_step(const void* sig_r, const void* sig_c, int words,
                  const void* coll_r, const void* coll_c, const void* size_r,
                  const void* size_c, int rows, int cols, int row_words,
                  float jmin_num, float jmin_den, float c_min, int radio_i,
                  int containment, int tri, void* count, void* packs,
                  void* stream) {
  // div_rn's range: the "mst" bound's jmin_den = 1 + j_min in [1, 2] and
  // jmin_num = j_min (0, 1] well above underflow
  if (rows <= 0 || cols <= 0 || words <= 0 || (words > 1 && words % 2) ||
      row_words < (cols + 31) / 32 ||
      row_words > (BN / 32) * ((cols + BN - 1) / BN) ||
      (!containment && !(jmin_den >= 1.0f && jmin_den <= 2.0f &&
                         jmin_num >= 0x1p-100f && jmin_num <= 1.0f)))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return (int)err;
  RingArgs A;
  A.sig_r = (const uint64_t*)sig_r;
  A.sig_c = (const uint64_t*)sig_c;
  A.coll_r = (const int*)coll_r;
  A.coll_c = (const int*)coll_c;
  A.size_r = (const int*)size_r;
  A.size_c = (const int*)size_c;
  A.count = (int*)count;
  A.packs = (uint32_t*)packs;
  A.words = words;
  A.rows = rows;
  A.cols = cols;
  A.row_words = row_words;
  A.jmin_num = jmin_num;
  A.jmin_den = jmin_den;
  A.c_min = c_min;
  A.radio_i = radio_i;
  A.containment = containment;
  A.tri = tri != 0;
  A.nbx = (cols + BN - 1) / BN;
  A.nby = (rows + BM - 1) / BM;
  A.n_tiles = 0;
  for (int by = 0; by < A.nby; ++by) A.n_tiles += ring_row_tiles(by, A);
  CUtensorMap map_r, map_c;
  if (!sig_map(&map_r, sig_r, rows, words) ||
      !sig_map(&map_c, sig_c, cols, words))
    return (int)cudaErrorInvalidValue;
  const int grid = A.n_tiles < sms ? A.n_tiles : sms;
  const cudaStream_t st = (cudaStream_t)stream;
  // the k-steps of a stage holding bits: 1 up to 256 bits, 2 at 512
  void (*kernel)(const CUtensorMap, const CUtensorMap, const RingArgs) =
      words <= 4 ? (containment ? ring_step_kernel<1, true>
                                : ring_step_kernel<1, false>)
      : words <= 8 ? (containment ? ring_step_kernel<2, true>
                                  : ring_step_kernel<2, false>)
                   : (containment ? ring_step_kernel<4, true>
                                  : ring_step_kernel<4, false>);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(map_r, map_c, A);
  return (int)cudaGetLastError();
}

// The rate probe: blocks x threads threads (128, 256 or 384), each
// warpgroup issuing iters groups of 16 m64n256k256 instructions; out:
// (blocks * threads,) int32.
int rtc_wgmma_b1_peak(int blocks, int threads, int iters, void* out,
                      void* stream) {
  if (blocks <= 0 || (threads != 128 && threads != 256 && threads != 384) ||
      iters <= 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = prepare(&sms);
  if (err != cudaSuccess) return (int)err;
  wgmma_b1_peak_kernel<16><<<blocks, threads, STAGE_BYTES + 1024,
                             (cudaStream_t)stream>>>(iters, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
