// Positional token matches for the WMH / OMH sketches (kernel K8) for
// Hopper.
//
// Replaces rabbittclust_tpu/ops/extra_pairs.py::_jitted_match (:48), driven
// by pairwise_tuple_matches (:59): tok is (n, s, c) uint32 token planes
// (a sketch's s samples, each c 32-bit words); out[i][j] is the number of
// samples at which all c words of genome i equal those of genome j.  The
// JAX program broadcasts a (512, n, s, c) equality per row block: n^2 s c
// word compares.
//
// Here the work is split in two passes, launched one after the other on
// one stream by one C entry:
//   1. Class ids (tm_insert_kernel, tm_resolve_kernel): ids[q][i] = the
//      smallest row j whose c words at sample q equal row i's.  One
//      open-addressing table a sample of 2^tbits >= 2n slots in device
//      scratch (one path for every n; a sample's table would outgrow
//      shared memory past n = 16,384), filled with 0xff bytes: a row
//      claims an empty slot with atomicCAS, and on an occupied slot
//      compares its c words with the occupant's (any row already there
//      has the same words), moving on only when they differ; a row that
//      finds its class lowers the slot to its index with atomicMin.  The
//      second kernel, after every insert, reads each row's slot, so the
//      id is the class's smallest row whatever the insertion order, and
//      equals the plain version element for element.
//   2. Pairs (tm_pair_kernel): out[i][j] = sum over samples of
//      ids[q][i] == ids[q][j], one 32-bit compare a sample whatever c is.
//      A block owns a 128 x 128 tile of the lower triangle (bx <= by, a
//      1-D grid walked by tile_of), each of its 256 threads an 8 x 8
//      register tile (rows ty + 16 u, columns tx + 16 v), so each id read
//      from shared memory serves 8 pairs.  The ids reach shared memory by
//      cp.async in stages of 16 words, double-buffered.  The tile is
//      written from registers and, off the diagonal, its transpose through
//      shared memory, so both stores stay coalesced.
//      Packed form (n <= 30,720 and at most 2,048 words): two samples' ids
//      in one word as fp16 bit patterns id + 1,024 (normal, finite, so two
//      halves are equal as halves exactly when they are equal as bits);
//      one HSET2 and one HADD2 count two samples, the halves summed at the
//      end (a half holds counts to 2,048 exactly).  An odd s pads every
//      row's last half with one constant, which matches in every pair and
//      is taken off.
//
// Bound: the larger of 4 n^2 bytes written (0.080 ms at n = 8,192 and
// 3.35 TB/s) and n (n + 1) / 2 s one-word compares at 67 TOP/s; the
// tokens (n s c words) are read once by the id pass, the ids (4 s n bytes)
// from L2 once a tile row.
//
// Plain C interface, loaded with ctypes; the entry points launch on the
// given stream and return the cudaError_t of the launches.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t EMPTY = 0xffffffffu;
constexpr int ID_THREADS = 256;
constexpr int T = 128;          // rows and columns of a block's pair tile
constexpr int THREADS = 256;    // 16 x 16 threads, 8 x 8 pairs each
constexpr int CH = 16;          // id words a stage holds
constexpr int STAGE = CH * 2 * T;  // words of a stage: CH x (rows, columns)
constexpr int TPAD = T + 1;     // the transposing buffer's row
constexpr int SMEM_BYTES = (2 * STAGE > T * TPAD ? 2 * STAGE : T * TPAD) * 4;
constexpr uint32_t PACK_BIAS = 1024;  // fp16's first normal pattern
constexpr int MAX_PACK_N = 30720;     // ids + bias stay below 0x7c00 (inf)
constexpr int MAX_PACK_WORDS = 2048;  // a half counts exactly to 2,048

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// MurmurHash3's 32-bit block mix and finaliser over a token's words
template <int C>
__device__ __forceinline__ uint32_t token_hash(const uint32_t (&w)[C]) {
  uint32_t h = 0x9747b28cu;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h ^= rotl(w[c] * 0xcc9e2d51u, 15) * 0x1b873593u;
    h = rotl(h, 13) * 5u + 0xe6546b64u;
  }
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

// thread e: row i = e % n_pad of sample q = e / n_pad; its slot into
// ids[q][i] (rows past n take none)
template <int C>
__global__ void __launch_bounds__(ID_THREADS)
tm_insert_kernel(const uint32_t* __restrict__ tok, int n, int s, int n_pad,
                 int tbits, uint32_t* __restrict__ table,
                 int* __restrict__ ids) {
  const int64_t e = (int64_t)blockIdx.x * ID_THREADS + threadIdx.x;
  if (e >= (int64_t)s * n_pad) return;
  const int q = (int)(e / n_pad), i = (int)(e % n_pad);
  if (i >= n) return;
  uint32_t w[C];
  const uint32_t* mine = tok + ((int64_t)i * s + q) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) w[c] = __ldg(mine + c);
  const uint32_t mask = (1u << tbits) - 1u;
  uint32_t* tab = table + ((int64_t)q << tbits);
  uint32_t slot = token_hash<C>(w) & mask;
  for (;;) {
    const uint32_t old = atomicCAS(tab + slot, EMPTY, (uint32_t)i);
    if (old == EMPTY) break;  // claimed
    const uint32_t* other = tok + ((int64_t)old * s + q) * C;
    bool same = true;
#pragma unroll
    for (int c = 0; c < C; ++c) same &= __ldg(other + c) == w[c];
    if (same) {
      // the slot only falls, so a row above ``old`` cannot lower it
      if ((uint32_t)i < old) atomicMin(tab + slot, (uint32_t)i);
      break;
    }
    slot = (slot + 1u) & mask;
  }
  ids[e] = (int)slot;
}

// thread e over (words, n_pad): the slots in ids become the classes'
// smallest rows (0 past n); PACK also writes sample pairs (2k, 2k + 1)
// into words[k] as fp16 patterns id + PACK_BIAS, an odd s's last high half
// PACK_BIAS
template <bool PACK>
__global__ void __launch_bounds__(ID_THREADS)
tm_resolve_kernel(const uint32_t* __restrict__ table, int n, int s,
                  int n_pad, int tbits, int* __restrict__ ids,
                  uint32_t* __restrict__ words) {
  const int nw = PACK ? (s + 1) / 2 : s;
  const int64_t e = (int64_t)blockIdx.x * ID_THREADS + threadIdx.x;
  if (e >= (int64_t)nw * n_pad) return;
  const int k = (int)(e / n_pad), i = (int)(e % n_pad);
  if (!PACK) {
    ids[e] = i < n ? (int)table[((int64_t)k << tbits) + ids[e]] : 0;
    return;
  }
  uint32_t half[2] = {0u, 0u};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = 2 * k + h;
    if (q >= s) continue;
    const int64_t at = (int64_t)q * n_pad + i;
    half[h] = i < n ? table[((int64_t)q << tbits) + ids[at]] : 0u;
    ids[at] = (int)half[h];
  }
  words[e] = (half[0] + PACK_BIAS) | ((half[1] + PACK_BIAS) << 16);
}

// tile t of the lower triangle, row by row: (by, bx) with bx <= by
__device__ __forceinline__ void tile_of(int64_t t, int& by, int& bx) {
  int64_t y = (int64_t)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (y * (y + 1) / 2 > t) --y;
  while ((y + 1) * (y + 2) / 2 <= t) ++y;
  by = (int)y;
  bx = (int)(t - y * (y + 1) / 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// words: (nw, n_pad) uint32 (ids, or packed pairs of them), n_pad a
// multiple of T; pad: the count an odd s's padding adds to every pair
template <bool PACK>
__global__ void __launch_bounds__(THREADS, 2)
tm_pair_kernel(const uint32_t* __restrict__ words, int n, int n_pad, int nw,
               int pad, int* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = (uint32_t*)smem4;
  int by, bx;
  tile_of(blockIdx.x, by, bx);
  const int i0 = by * T, j0 = bx * T;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // a stage: word k's 128 row ids then its 128 column ids, as 16-byte
  // pieces (4 a thread at CH = 16)
  auto load = [&](int buf, int k0) {
    const int ns = min(CH, nw - k0);
    for (int p = threadIdx.x; p < ns * 2 * (T / 4); p += THREADS) {
      const int k = p / (2 * (T / 4)), r = p % (2 * (T / 4));
      const int side = r / (T / 4), c4 = r % (T / 4);
      const uint32_t* src = words + (int64_t)(k0 + k) * n_pad +
                            (side ? j0 : i0) + 4 * c4;
      cp_async16(sm + buf * STAGE + (2 * k + side) * T + 4 * c4, src);
    }
  };

  uint32_t acc[8][8];  // int counts, or two fp16 counts
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0u;
  load(0, 0);
  cp_async_commit();
  int buf = 0;
  for (int k0 = 0; k0 < nw; k0 += CH, buf ^= 1) {
    if (k0 + CH < nw) load(buf ^ 1, k0 + CH);
    cp_async_commit();
    cp_async_wait<1>();  // this stage's group has landed
    __syncthreads();
    const int ns = min(CH, nw - k0);
    const uint32_t* st = sm + buf * STAGE;
#pragma unroll 4
    for (int k = 0; k < ns; ++k) {
      const uint32_t* rw = st + 2 * k * T;
      const uint32_t* cl = rw + T;
      uint32_t a[8], b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = rw[ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 8; ++v) b[v] = cl[tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if (PACK) {
            __half2 h = *reinterpret_cast<__half2*>(&acc[u][v]);
            h = __hadd2(h, __heq2(*reinterpret_cast<const __half2*>(&a[u]),
                                  *reinterpret_cast<const __half2*>(&b[v])));
            acc[u][v] = *reinterpret_cast<uint32_t*>(&h);
          } else {
            acc[u][v] += a[u] == b[v];
          }
        }
    }
    __syncthreads();  // the stage is read before it is loaded again
  }
  cp_async_wait<0>();

  int cnt[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (PACK) {
        const __half2 h = *reinterpret_cast<const __half2*>(&acc[u][v]);
        cnt[u][v] = (int)__low2float(h) + (int)__high2float(h) - pad;
      } else {
        cnt[u][v] = (int)acc[u][v];
      }
    }
  // the tile, from registers: a warp writes two 64-byte row pieces
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= n) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j < n) out[(int64_t)i * n + j] = cnt[u][v];
    }
  }
  if (bx == by) return;  // the diagonal tile is its own transpose
  // the transpose, through shared memory (the stages are read): tt[c][r]
  __syncthreads();
  uint32_t* tt = sm;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v)
      tt[(tx + 16 * v) * TPAD + ty + 16 * u] = (uint32_t)cnt[u][v];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < T; c += THREADS / 32) {
    const int j = j0 + c;
    if (j >= n) break;
#pragma unroll
    for (int q = 0; q < T / 32; ++q) {
      const int r = lane + 32 * q;
      if (i0 + r < n) out[(int64_t)j * n + i0 + r] = (int)tt[c * TPAD + r];
    }
  }
}

int tbits_of(int n) {
  int b = 1;
  while ((int64_t)1 << b < 2 * (int64_t)n) ++b;
  return b;
}

cudaError_t launch_ids(const void* tok, int n, int s, int c, int n_pad,
                       void* table, void* ids, cudaStream_t st) {
  const int tbits = tbits_of(n);
  cudaError_t err = cudaMemsetAsync(table, 0xff, ((size_t)s << tbits) * 4,
                                    st);
  if (err != cudaSuccess) return err;
  const int64_t blocks = ((int64_t)s * n_pad + ID_THREADS - 1) / ID_THREADS;
  const uint32_t* tk = (const uint32_t*)tok;
  uint32_t* tb = (uint32_t*)table;
  int* id = (int*)ids;
  switch (c) {
#define TM_INSERT(C)                                                        \
  case C:                                                                   \
    tm_insert_kernel<C><<<(unsigned)blocks, ID_THREADS, 0, st>>>(           \
        tk, n, s, n_pad, tbits, tb, id);                                    \
    break;
    TM_INSERT(1) TM_INSERT(2) TM_INSERT(3) TM_INSERT(4)
    TM_INSERT(5) TM_INSERT(6) TM_INSERT(7) TM_INSERT(8)
#undef TM_INSERT
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool PACK>
cudaError_t launch_resolve(int n, int s, int n_pad, const void* table,
                           void* ids, void* words, cudaStream_t st) {
  const int nw = PACK ? (s + 1) / 2 : s;
  const int64_t blocks = ((int64_t)nw * n_pad + ID_THREADS - 1) / ID_THREADS;
  tm_resolve_kernel<PACK><<<(unsigned)blocks, ID_THREADS, 0, st>>>(
      (const uint32_t*)table, n, s, n_pad, tbits_of(n), (int*)ids,
      (uint32_t*)words);
  return cudaGetLastError();
}

template <bool PACK>
cudaError_t launch_pairs(const void* words, int n, int n_pad, int s,
                         void* out, cudaStream_t st) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(tm_pair_kernel<PACK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const int64_t tiles_1d = n_pad / T;
  const int64_t tiles = tiles_1d * (tiles_1d + 1) / 2;
  tm_pair_kernel<PACK><<<(unsigned)tiles, THREADS, SMEM_BYTES, st>>>(
      (const uint32_t*)words, n, n_pad, PACK ? (s + 1) / 2 : s,
      PACK ? s & 1 : 0, (int*)out);
  return cudaGetLastError();
}

bool bad(int n, int s, int c) {
  return n <= 0 || n > 65535 * 64 || s <= 0 || c < 1 || c > 8;
}

int pad_of(int n) { return (n + T - 1) / T * T; }

}  // namespace

extern "C" {

// The id pass alone.  tok: (n, s, c) uint32, contiguous; table: s * 2^tbits
// uint32 scratch, 2^tbits the least power of two >= 2n; ids: (s, n_pad)
// int32 output, n_pad = n rounded up to 128, 0 past n.  1 <= c <= 8,
// s >= 1, 0 < n <= 65535 * 64; others return cudaErrorInvalidValue.
int rtc_tuple_ids(const void* tok, int n, int s, int c, void* table,
                  void* ids, void* stream) {
  if (bad(n, s, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_ids(tok, n, s, c, pad_of(n), table, ids, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_resolve<false>(n, s, pad_of(n), table, ids, nullptr,
                                    st);
}

// K8: the id pass, then the pairs.  As rtc_tuple_ids, and out: (n, n)
// int32; pack != 0 takes the packed form through words ((s + 1) / 2,
// n_pad) uint32 scratch, which needs n <= 30,720 and s <= 4,096.
int rtc_tuple_match(const void* tok, int n, int s, int c, void* table,
                    void* ids, void* words, int pack, void* out,
                    void* stream) {
  if (bad(n, s, c) ||
      (pack && (n > MAX_PACK_N || (s + 1) / 2 > MAX_PACK_WORDS)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_pad = pad_of(n);
  cudaError_t err = launch_ids(tok, n, s, c, n_pad, table, ids, st);
  if (err != cudaSuccess) return (int)err;
  if (pack) {
    err = launch_resolve<true>(n, s, n_pad, table, ids, words, st);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_pairs<true>(words, n, n_pad, s, out, st);
  }
  err = launch_resolve<false>(n, s, n_pad, table, ids, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pairs<false>(ids, n, n_pad, s, out, st);
}

}  // extern "C"
