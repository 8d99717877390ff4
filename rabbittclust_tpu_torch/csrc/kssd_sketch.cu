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
// The keep test needs none of the table's ranks: it asks whether dim lies
// in the fixed set {d : 0 <= table[d] < dim_end}.  ks_bitmap_kernel
// builds that set once per (table, dim_end) as a bitmap of 16^half_subk
// bits (2 MB at half_subk 6, which stays in the 50 MB L2, where the table
// is 64 MB), followed by a coarse level of one bit per 256 dimensions (8
// KB), set when any of the 256 is kept; the wrapper caches it beside the
// table.  The table is then read only for kept windows, about 16^-drlevel
// of the positions.
//
// The JAX program builds each tuple from k shifted ORs over (hi, lo) uint32
// lanes and compacts a fixed-capacity buffer per scan row.  Here 64-bit
// integers are native, and the tuples roll: a thread owns RUN consecutive
// positions of a span of SPAN, takes its RUN + k - 1 codes from shared
// memory into registers (the span's codes and a k - 1 halo, staged with
// 16-byte loads) and keeps the reference's rolling state (tup = ((tup <<
// 2) | c) & tupmask, rvs = (rvs >> 2) | ((3 ^ c) << 2(k - 1)), and the
// count of valid codes since the last invalid one).  Three launches on one
// stream:
//   1. ks_keep_kernel: the keep bit of each position, a 32-bit word a
//      thread, and each span's count.  Its blocks stage the coarse level in
//      shared memory once and walk spans in turn; a position's dimension
//      reaches the L2 bitmap only when its coarse bit is set, and a
//      thread's run issues those loads together;
//   2. ks_scan_kernel: one block's exclusive scan of the span counts: each
//      span's first output slot, and the total;
//   3. ks_scatter_kernel: a span with kept windows stages its codes and
//      halo again; a warp takes its 32 runs in turn, one position a lane,
//      so that a round's kept windows go to consecutive slots (a ballot's
//      prefix); a kept lane builds its tuple from its k codes and gathers
//      the table's rank.
// The order is thus fixed by the scans, not by any race, and the total is
// known without a capacity: the caller sizes the outputs to the window.
//
// Bound: device memory.  Each position reads one byte of code; each kept
// window writes 12 bytes and reads a 32-byte sector of the table.  The
// passes read the codes twice (the second mostly from L2) and the coarse
// level once a block.
//
// Every mask comes from the host (KssdParams' Python ints): at half_k = 16
// tupmask is all 64 bits, which (1 << 64) - 1 cannot express in C.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// given stream and returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 32;                 // positions a thread owns
constexpr int SPAN = THREADS * RUN;     // positions of a span
constexpr int HALO = 64;                // >= k - 1, a multiple of 16
static_assert(RUN == 32, "a run is a lane's position in ks_scatter_kernel");
constexpr int COARSE_SHIFT = 8;         // dimensions a coarse bit: 256
constexpr int MAX_DIMS = 1 << 24;       // 16^6
constexpr int MAX_COARSE = MAX_DIMS >> (COARSE_SHIFT + 5);  // 2048 words
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  uint64_t tupmask, domask, undomask0, undomask1;
  int k, hol2, shift1, drshift;
};

// exclusive prefix of v over a block of NT threads; *total receives the
// block's sum.  Every thread of the block must call it.
template <int NT>
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
  for (int w = 0; w < NT / 32; ++w) {
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

// The span's codes [base, base + SPAN + HALO) into sc, invalid past the
// window's end.  The caller synchronises before reading them.
__device__ __forceinline__ void stage_codes(int8_t* sc,
                                            const int8_t* __restrict__ codes,
                                            long long base,
                                            long long n_codes) {
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
}

// The reference's rolling tuple state over one thread's codes
struct Roll {
  uint64_t tup = 0, rvs = 0;
  int run = 0;
  __device__ __forceinline__ void push(int c, const Params& p) {
    if (c < 0) {
      run = 0;
    } else {
      tup = ((tup << 2) | (uint64_t)c) & p.tupmask;
      rvs = (rvs >> 2) | ((uint64_t)(3 ^ c) << (2 * (p.k - 1)));
      ++run;
    }
  }
};

// fine bitmap word w of the keep set: bit b is dimension 32 w + b; coarse
// bit c (after the n_fine fine words) is set when any of dimensions
// [256 c, +256) is.  A warp builds 32 fine words from 32 coalesced table
// rows; the coarse bits go in with atomicOr (zeroed by the caller).
__global__ void __launch_bounds__(THREADS)
ks_bitmap_kernel(const int* __restrict__ table, int n_dims, int dim_end,
                 uint32_t* __restrict__ fine, int n_fine,
                 uint32_t* __restrict__ coarse) {
  const int lane = threadIdx.x & 31;
  const int w0 = (blockIdx.x * THREADS + threadIdx.x) / 32 * 32;
  if (w0 >= n_fine) return;  // warp-uniform
  uint32_t mine = 0;
  for (int j = 0; j < 32; ++j) {
    const long long d = (long long)(w0 + j) * 32 + lane;
    const int v = d < n_dims ? table[d] : -1;
    const uint32_t word = __ballot_sync(FULL, v >= 0 && v < dim_end);
    if (lane == j) mine = word;
  }
  if (w0 + lane < n_fine) fine[w0 + lane] = mine;
  const uint32_t nz = __ballot_sync(FULL, mine != 0u);
  if (lane == 0) {
    uint32_t bits = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bits |= ((nz >> (8 * c)) & 0xffu ? 1u : 0u) << c;
    const int cb = w0 / 8;  // the coarse bit of fine word w0; a multiple of 4
    if (bits) atomicOr(coarse + (cb >> 5), bits << (cb & 31));
  }
}

__global__ void __launch_bounds__(THREADS)
ks_keep_kernel(const int8_t* __restrict__ codes, long long n_codes,
               int n_spans, const uint32_t* __restrict__ fine,
               const uint32_t* __restrict__ coarse, int n_coarse, Params p,
               uint32_t* __restrict__ keep_words,
               int* __restrict__ span_counts) {
  __shared__ __align__(16) int8_t sc[SPAN + HALO];
  __shared__ uint32_t sco[MAX_COARSE];
  __shared__ int ws[THREADS / 32];
  for (int i = threadIdx.x; i < n_coarse; i += THREADS) sco[i] = coarse[i];
  const int k = p.k;
  for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
    stage_codes(sc, codes, (long long)span * SPAN, n_codes);
    __syncthreads();  // also the coarse level, on the first span
    // the thread's RUN + 32 codes in registers (16-byte loads), each code
    // then a byte at a compile-time place
    uint32_t w[(RUN + 32) / 4];
#pragma unroll
    for (int i = 0; i < (RUN + 32) / 16; ++i) {
      const uint4 v =
          reinterpret_cast<const uint4*>(sc + threadIdx.x * RUN)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    // roll over codes m = 0 .. RUN + 30 (k <= 32); position q = m - (k - 1)
    // is complete at code m.  A dimension whose coarse bit is set reads its
    // fine word from the bitmap in L2.  No branch: the loads of the run go
    // out together, and the codes past q = RUN - 1 are rolled for nothing.
    Roll r;
    uint32_t keep = 0;
#pragma unroll
    for (int m = 0; m < RUN + 31; ++m) {
      r.push((int)(int8_t)(w[m >> 2] >> (8 * (m & 3))), p);
      const int q = m - (k - 1);
      const bool in = (unsigned)q < (unsigned)RUN;
      const int dim = dim_of(canonical(r.tup, r.rvs), p);  // < 2^24
      const bool hit = in && r.run >= k &&
                       ((sco[dim >> (COARSE_SHIFT + 5)] >>
                         ((dim >> COARSE_SHIFT) & 31)) & 1u);
      const uint32_t fw = hit ? __ldg(fine + (dim >> 5)) : 0u;
      keep |= ((fw >> (dim & 31)) & 1u) << (q & 31);
    }
    keep_words[(size_t)span * THREADS + threadIdx.x] = keep;
    int total;
    block_scan<THREADS>(__popc(keep), ws, &total);  // its syncs free sc
    if (threadIdx.x == 0) span_counts[span] = total;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
ks_scan_kernel(const int* __restrict__ span_counts, int n_spans,
               int* __restrict__ span_offsets, int* __restrict__ total) {
  __shared__ int ws[SCAN_THREADS / 32];
  int carry = 0;
  for (int base = 0; base < n_spans; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    int sum;
    const int ex = block_scan<SCAN_THREADS>(
        i < n_spans ? span_counts[i] : 0, ws, &sum);
    if (i < n_spans) span_offsets[i] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) *total = carry;
}

// A warp writes the kept windows of its 32 runs (1,024 positions) in
// rounds of 32 consecutive positions, one a lane, so that its writes are
// consecutive; a kept lane builds its tuple from its k codes.
__global__ void __launch_bounds__(THREADS)
ks_scatter_kernel(const int8_t* __restrict__ codes, long long n_codes,
                  int n_spans, const int* __restrict__ table, Params p,
                  const uint32_t* __restrict__ keep_words,
                  const int* __restrict__ span_counts,
                  const int* __restrict__ span_offsets,
                  unsigned long long* __restrict__ out_hash,
                  int* __restrict__ out_pos) {
  __shared__ __align__(16) int8_t sc[SPAN + HALO];
  __shared__ int ws[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;  // lanes before this one
  const int k = p.k;
  const int rshift = 2 * (k - 1);
  for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
    if (span_counts[span] == 0) continue;  // block-uniform
    stage_codes(sc, codes, (long long)span * SPAN, n_codes);
    const uint32_t keep = keep_words[(size_t)span * THREADS + threadIdx.x];
    int block_total;
    // its first sync also publishes sc; the warp's first slot is lane 0's
    int o = __shfl_sync(FULL,
                        span_offsets[span] +
                            block_scan<THREADS>(__popc(keep), ws,
                                                &block_total),
                        0);
    for (int rr = 0; rr < 32; ++rr) {
      const uint32_t kw = __shfl_sync(FULL, keep, rr);  // lane rr's run
      if (kw == 0u) continue;  // warp-uniform
      if ((kw >> lane) & 1u) {  // all k codes valid: it was kept
        const int at = warp * 32 * RUN + rr * RUN + lane;  // in the span
        uint64_t tup = 0, rvs = 0;
        for (int j = 0; j < k; ++j) {
          const uint64_t c = (uint64_t)sc[at + j];
          tup = (tup << 2) | c;
          rvs = (rvs >> 2) | ((3 ^ c) << rshift);
        }
        const uint64_t uni = canonical(tup & p.tupmask, rvs);
        const int pf = __ldg(table + dim_of(uni, p));
        const int slot = o + __popc(kw & below);
        out_hash[slot] = dr_hash(uni, pf, p);
        out_pos[slot] = span * SPAN + at;
      }
      o += __popc(kw);
    }
    __syncthreads();  // sc is restaged for the next span
  }
}

// The span-walking grid of `kernel`: as many blocks as are resident at
// once on the current device (one wave; read once a device), at most
// n_spans.  Slot 0: ks_keep_kernel, 1: ks_scatter_kernel.
cudaError_t span_grid(const void* kernel, int slot, int n_spans, int* grid) {
  static int known[2][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!known[slot][dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    known[slot][dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = n_spans < known[slot][dev] ? n_spans : known[slot][dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The keep bitmap of table (n_dims int32, n_dims <= 2^24) for dim_end:
// bitmap receives ceil(n_dims / 32) fine words, then ceil(n_dims / 8192)
// coarse words (zeroed here).
int rtc_kssd_keep_bitmap(const void* table, int n_dims, int dim_end,
                         void* bitmap, void* stream) {
  if (n_dims <= 0 || n_dims > MAX_DIMS) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_fine = (n_dims + 31) / 32;
  const int n_coarse = (n_dims + (1 << (COARSE_SHIFT + 5)) - 1) >>
                       (COARSE_SHIFT + 5);
  uint32_t* fine = (uint32_t*)bitmap;
  cudaError_t err = cudaMemsetAsync(fine + n_fine, 0,
                                    (size_t)n_coarse * 4, st);
  if (err != cudaSuccess) return (int)err;
  const int warps = (n_fine + 31) / 32;
  ks_bitmap_kernel<<<(warps * 32 + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      (const int*)table, n_dims, dim_end, fine, n_fine, fine + n_fine);
  return (int)cudaGetLastError();
}

// codes: int8 (n_pos + k - 1), 16-byte aligned; bitmap: the keep bitmap
// of table for dim_end (rtc_kssd_keep_bitmap, n_dims dimensions); table:
// int32 (n_dims); scratch: int32 of ceil(n_pos / SPAN) * (THREADS + 2);
// out_hash: uint64 (n_pos); out_pos: int32 (n_pos); total: int32 (1).
// 2 <= k <= 32, 0 < n_pos < 2^31 - SPAN; others return
// cudaErrorInvalidValue.
int rtc_kssd_sketch(const void* codes, int n_pos, int k, const void* bitmap,
                    int n_dims, const void* table,
                    unsigned long long tupmask, unsigned long long domask,
                    unsigned long long undomask0,
                    unsigned long long undomask1, int hol2, int shift1,
                    int drshift, void* scratch, void* out_hash,
                    void* out_pos, void* total, void* stream) {
  if (k < 2 || k > 32 || k - 1 > HALO || n_pos <= 0 ||
      (long long)n_pos >= (1LL << 31) - SPAN || n_dims <= 0 ||
      n_dims > MAX_DIMS || hol2 < 0 || hol2 >= 64 || shift1 < 0 ||
      drshift < 0 || drshift >= 64)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Params p{tupmask, domask, undomask0, undomask1, k, hol2, shift1,
                 drshift};
  const int n_spans = (n_pos + SPAN - 1) / SPAN;
  int keep_grid = 0, scatter_grid = 0;
  cudaError_t err = span_grid((const void*)ks_keep_kernel, 0, n_spans,
                              &keep_grid);
  if (err == cudaSuccess)
    err = span_grid((const void*)ks_scatter_kernel, 1, n_spans,
                    &scatter_grid);
  if (err != cudaSuccess) return (int)err;
  const uint32_t* fine = (const uint32_t*)bitmap;
  const int n_fine = (n_dims + 31) / 32;
  const int n_coarse = (n_dims + (1 << (COARSE_SHIFT + 5)) - 1) >>
                       (COARSE_SHIFT + 5);
  uint32_t* keep_words = (uint32_t*)scratch;
  int* span_counts = (int*)scratch + (size_t)n_spans * THREADS;
  int* span_offsets = span_counts + n_spans;
  const long long n_codes = (long long)n_pos + k - 1;
  ks_keep_kernel<<<keep_grid, THREADS, 0, st>>>(
      (const int8_t*)codes, n_codes, n_spans, fine, fine + n_fine, n_coarse,
      p, keep_words, span_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ks_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(span_counts, n_spans,
                                             span_offsets, (int*)total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ks_scatter_kernel<<<scatter_grid, THREADS, 0, st>>>(
      (const int8_t*)codes, n_codes, n_spans, (const int*)table, p,
      keep_words, span_counts, span_offsets,
      (unsigned long long*)out_hash, (int*)out_pos);
  return (int)cudaGetLastError();
}

}  // extern "C"
