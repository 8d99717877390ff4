// The device KSSD sketcher (kernel K7) for Hopper.
//
// Replaces rabbittclust_tpu/ops/sketch_device.py::_chunk_kernel (:116) and
// _stream_kernel_fn (:164): over one dispatch window of base codes (int8,
// A C G T = 0..3, -1 invalid), every position p whose k codes
// p .. p + k - 1 are all valid has a forward 2k-bit tuple and its reverse
// complement; the canonical tuple is their unsigned minimum; its middle
// half_subk bases name a dimension, which the shuffle table maps to a rank
// pf; the window is kept when 0 <= pf < dim_end, and its hash is the
// dimension-reduced tuple ((uni & undomask0) | ((uni & undomask1) <<
// shift1)) >> 4 drlevel, OR pf (reference SketchInfo.cpp:1044-1048,
// 1126-1165).  The output is the kept windows' (hash, position) in
// position order, and their count.
//
// The JAX program builds each tuple from k shifted ORs over (hi, lo) uint32
// lanes and compacts a fixed-capacity buffer per scan row.  Here 64-bit
// integers are native, and the tuples roll: a thread owns RUN consecutive
// positions, reads its RUN + k - 1 codes from shared memory (the block's
// codes and a k - 1 halo, staged with 16-byte loads), and keeps the
// reference's rolling state (tup = ((tup << 2) | c) & tupmask, rvs = (rvs
// >> 2) | ((3 ^ c) << 2(k - 1)), and the count of valid codes since the
// last invalid one).  Two launches on one stream:
//   1. ks_keep_kernel: the keep bit of each position, a 32-bit word a
//      thread, and each block's count;
//   2. ks_scatter_kernel: block b adds the counts of the blocks before it
//      (a strided sum and a block scan), a block scan of the threads'
//      popcounts gives each thread its first output slot, and the thread
//      recomputes each kept window's tuple straight from its k codes and
//      writes (hash, position) in ascending order.  The last block writes
//      the total.
// The order is thus fixed by the scans, not by any race, and the total is
// known without a capacity: the caller sizes the outputs to the window.
//
// Bound: device memory.  Each position reads one byte of code; each valid
// position reads one random int32 of the 64 MB shuffle table (16^6
// entries), which costs a 32-byte sector from memory or from the 50 MB L2;
// each kept window writes 12 bytes.  Pass 1 computes every dimension of a
// thread's run before it issues the run's table loads, so the 32 gathers
// of a thread are in flight together.  Kept windows are about 16^-drlevel
// of the positions, so pass 2's recomputation (k byte loads and one more
// gather a kept window) is small except in low-complexity sequence.
//
// Every mask comes from the host (KssdParams' Python ints): at half_k = 16
// tupmask is all 64 bits, which (1 << 64) - 1 cannot express in C.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream and returns the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 32;                 // positions a thread owns
constexpr int SPAN = THREADS * RUN;     // positions a block owns
constexpr int HALO = 64;                // >= k - 1, a multiple of 16
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  uint64_t tupmask, domask, undomask0, undomask1;
  int k, hol2, shift1, drshift, dim_end;
};

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

__device__ __forceinline__ uint64_t canonical(uint64_t tup, uint64_t rvs) {
  return tup < rvs ? tup : rvs;  // unsigned: bit 63 is part of the tuple
}

__device__ __forceinline__ int dim_of(uint64_t uni, const Params& p) {
  return (int)((uni & p.domask) >> p.hol2);  // < 16^half_subk <= 2^24
}

__device__ __forceinline__ uint64_t dr_hash(uint64_t uni, int pf,
                                            const Params& p) {
  const uint64_t hi = p.shift1 < 64 ? (uni & p.undomask1) << p.shift1 : 0;
  return (((uni & p.undomask0) | hi) >> p.drshift) | (uint64_t)(uint32_t)pf;
}

__global__ void __launch_bounds__(THREADS)
ks_keep_kernel(const int8_t* __restrict__ codes, long long n_codes,
               const int* __restrict__ table, Params p,
               uint32_t* __restrict__ keep_words,
               int* __restrict__ block_counts) {
  __shared__ __align__(16) int8_t sc[SPAN + HALO];
  __shared__ int ws[THREADS / 32];
  const long long base = (long long)blockIdx.x * SPAN;
  for (int i = threadIdx.x; i < (SPAN + HALO) / 16; i += THREADS) {
    const long long g = base + 16LL * i;
    uint4 v;
    if (g + 16 <= n_codes) {
      v = __ldg(reinterpret_cast<const uint4*>(codes + g));
    } else {  // the window's end: invalid codes past it
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const long long at = g + 4 * q + b;
          const uint32_t c = at < n_codes ? (uint8_t)codes[at] : 0xffu;
          x |= c << (8 * b);
        }
        w[q] = x;
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    reinterpret_cast<uint4*>(sc)[i] = v;
  }
  __syncthreads();

  const int8_t* my = sc + threadIdx.x * RUN;
  const int k = p.k;
  const int rshift = 2 * (k - 1);
  uint64_t tup = 0, rvs = 0;
  int run = 0;
  auto roll = [&](int c) {
    if (c < 0) {
      run = 0;
    } else {
      tup = ((tup << 2) | (uint64_t)c) & p.tupmask;
      rvs = (rvs >> 2) | ((uint64_t)(3 ^ c) << rshift);
      ++run;
    }
  };
  for (int j = 0; j < k - 1; ++j) roll(my[j]);
  int dims[RUN];
#pragma unroll
  for (int q = 0; q < RUN; ++q) {
    roll(my[q + k - 1]);
    dims[q] = run >= k ? dim_of(canonical(tup, rvs), p) : -1;
  }
  int pf[RUN];
#pragma unroll
  for (int q = 0; q < RUN; ++q)
    pf[q] = dims[q] >= 0 ? __ldg(table + dims[q]) : -1;
  uint32_t keep = 0;
#pragma unroll
  for (int q = 0; q < RUN; ++q)
    keep |= (uint32_t)(pf[q] >= 0 && pf[q] < p.dim_end) << q;
  keep_words[(size_t)blockIdx.x * THREADS + threadIdx.x] = keep;
  int total;
  block_scan(__popc(keep), ws, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
ks_scatter_kernel(const int8_t* __restrict__ codes,
                  const int* __restrict__ table, Params p,
                  const uint32_t* __restrict__ keep_words,
                  const int* __restrict__ block_counts,
                  unsigned long long* __restrict__ out_hash,
                  int* __restrict__ out_pos, int* __restrict__ total) {
  __shared__ int ws[THREADS / 32];
  int before = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += THREADS)
    before += block_counts[b];
  int at;
  block_scan(before, ws, &at);
  uint32_t keep = keep_words[(size_t)blockIdx.x * THREADS + threadIdx.x];
  int block_total;
  int o = at + block_scan(__popc(keep), ws, &block_total);
  const long long p0 = (long long)blockIdx.x * SPAN + threadIdx.x * RUN;
  const int k = p.k;
  const int rshift = 2 * (k - 1);
  while (keep) {
    const long long pos = p0 + __ffs(keep) - 1;
    keep &= keep - 1;
    uint64_t tup = 0, rvs = 0;
    for (int j = 0; j < k; ++j) {  // all k codes are valid: it was kept
      const uint64_t c = (uint64_t)__ldg(codes + pos + j);
      tup = (tup << 2) | c;
      rvs = (rvs >> 2) | ((3 ^ c) << rshift);
    }
    const uint64_t uni = canonical(tup & p.tupmask, rvs);
    const int pf = __ldg(table + dim_of(uni, p));
    out_hash[o] = dr_hash(uni, pf, p);
    out_pos[o] = (int)pos;
    ++o;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    *total = at + block_total;
}

}  // namespace

extern "C" {

// codes: int8 (n_pos + k - 1), 16-byte aligned; table: int32 (16^half_subk);
// keep_words: scratch of ceil(n_pos / SPAN) * THREADS uint32; block_counts:
// scratch of ceil(n_pos / SPAN) int32; out_hash: uint64 (n_pos); out_pos:
// int32 (n_pos); total: int32 (1).  2 <= k <= 32, 0 < n_pos < 2^31 - SPAN;
// others return cudaErrorInvalidValue.
int rtc_kssd_sketch(const void* codes, int n_pos, int k, const void* table,
                    unsigned long long tupmask, unsigned long long domask,
                    unsigned long long undomask0,
                    unsigned long long undomask1, int hol2, int shift1,
                    int drshift, int dim_end, void* keep_words,
                    void* block_counts, void* out_hash, void* out_pos,
                    void* total, void* stream) {
  if (k < 2 || k > 32 || k - 1 > HALO || n_pos <= 0 ||
      (long long)n_pos >= (1LL << 31) - SPAN || hol2 < 0 || hol2 >= 64 ||
      shift1 < 0 || drshift < 0 || drshift >= 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Params p{tupmask, domask, undomask0, undomask1, k, hol2, shift1,
                 drshift, dim_end};
  const int blocks = (n_pos + SPAN - 1) / SPAN;
  ks_keep_kernel<<<blocks, THREADS, 0, st>>>(
      (const int8_t*)codes, (long long)n_pos + k - 1, (const int*)table, p,
      (uint32_t*)keep_words, (int*)block_counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ks_scatter_kernel<<<blocks, THREADS, 0, st>>>(
      (const int8_t*)codes, (const int*)table, p,
      (const uint32_t*)keep_words, (const int*)block_counts,
      (unsigned long long*)out_hash, (int*)out_pos, (int*)total);
  return (int)cudaGetLastError();
}

}  // extern "C"
