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
//   3. compact variant only, an ordered multi-block compaction into
//      [cross, ncol, row_p[r_lo, +span), col_idx(cap), col_val(cap)],
//      col_idx the first cap proposing columns in ascending order padded
//      with 0, col_val col_p at those indices
//      (jnp.nonzero(size=cap, fill_value=0)): lp_copy_rows_kernel copies
//      the row span out, lp_count_kernel counts each 2,048-column segment's
//      proposing columns into the scratch row_p's first entries (copied out
//      already), lp_scatter_kernel gives each segment its offset from those
//      counts and writes its columns in order, and the padding.
//
// Bound: device memory bandwidth.  A round reads the panel's masks once
// (1.07 GB for 512 tiles at rb = 4096: 0.32 ms at 3.35 TB/s) plus the
// labels.  Design:
//   - A block owns a band of rows of one tile and the columns of a span:
//     the whole row up to rb = 8,192 (SPAN_FROM), spans of 4,096 columns
//     (SPAN, 512 bytes of each row) above it, so a block's column labels
//     and minima, staged in shared memory once per block, take at most 64
//     KB, and 32 KB at rb = 16,384 (the mesh LP's slabs), where several
//     blocks share an SM.  The band is up to 4,096 rows, narrower until
//     the blocks spread over the SMs within 10 %, down to 128 rows, or to
//     1,024 where a tile has several spans, so that staging and the flush
//     stay a few per cent of the bytes a block streams.  Whole rows of
//     16,384 columns would take 128 KB of shared memory: one block an SM,
//     bands of 128 rows, and staging and flush a sixth of the slab round's
//     time.  At rb = 8,192, spans of 4,096 took 1.08 times the whole rows'
//     time (twice the row work a byte), so spans start above it.
//   - Each warp walks its own run of the band's rows in ascending order,
//     four 16-byte loads in flight a lane (ld.global.nc, no L1
//     allocation): a warp step covers 512 B at a span of 4,096 columns
//     (one row's span, or several rows below it) and 1 KB at 8,192, and
//     lanes keep the same 128 columns of every row they take.  So a row
//     whose set bits crowd into a few 128-column runs (cluster members side
//     by side) keeps a few lanes busy while the rest wait.  Staging the
//     rows through TMA into a ring of shared-memory stages, with a
//     producer warp, was measured at the slabs' shape and took 1.03 times
//     these direct loads' time: the scan, not the loads, holds the round.
//   - A set bit's whole work is one pass of one 32-bit loop (scan_word):
//     the gate, the count, the row's first column and the column's first
//     row.  The lanes' reads of column labels and minima are spread over the
//     banks by a swizzle (slot): unswizzled, a planted cluster's bits, 64
//     columns apart, put all 32 lanes of a warp on one bank.
//   - Label gate: only set bits read a column label (shared memory); zero
//     words cost no loop iteration.
//   - Row minimum: each lane's first gated column; the warp's lowest lane
//     with one holds the row's (a ballot, or a warp min reduction when one
//     row spans the warp); one global atomicMin per row and span with a
//     hit.
//   - Column minimum: as a lane's rows ascend, a column's first gated row is
//     its minimum over that lane's rows, so each lane keeps a "found" mask of
//     its columns and only newly found bits take a shared atomicMin (a few a
//     column per block, not one per set bit); one global atomicMin per
//     column with a hit per block.
//
// Plain C interface, loaded with ctypes; every entry point launches on the
// given stream and returns the cudaError_t of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SENT = 1 << 30;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPAN = 4096;          // columns of a block above SPAN_FROM
constexpr int SPAN_FROM = 8192;     // ... up to which a block takes rows whole
constexpr int MAX_BAND = 4096;      // rows of a tile per block, at most
constexpr int MIN_BAND = 128;       // ... and at least, where rb allows
constexpr int SPAN_MIN_BAND = 1024;  // ... where a tile has several spans
constexpr int SCAN_THREADS = 512;
constexpr int SEG = 4 * SCAN_THREADS;  // columns per compaction block
constexpr unsigned FULL = 0xffffffffu;

// 16 bytes the block reads once: no L1 allocation
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Shared-memory slot of column c: lanes read the same offset of their own
// 128-column chunks (set bits of a planted cluster sit 64 columns apart), so
// the chunk index is XOR-ed into the word's low 5 bits to spread those reads
// over the 32 banks.
__device__ __forceinline__ int slot(int c) { return c ^ ((c >> 7) & 31); }

// One 32-bit word of a lane's row chunk, columns col + p (col a multiple of
// 32; sw = the chunk's swizzle): each set bit whose column label is not li
// counts into mine and proposes row gi, the first such column is the lane's
// first; a column not yet in ``found`` takes a shared atomicMin (the lane's
// rows ascend, so the first row to hit a column is its minimum over them).
__device__ __forceinline__ void scan_word(uint32_t w, const int* lc,
                                          int* cmin, int col, int sw,
                                          int li, int gi, uint32_t& found,
                                          int& first, int& mine) {
  while (w) {
    const int p = __ffs(w) - 1;
    w &= w - 1;
    if (lc[col + (p ^ sw)] != li) {
      ++mine;
      first = min(first, col + p);
      const uint32_t bit = 1u << p;
      if (!(found & bit)) {
        found |= bit;
        atomicMin(cmin + col + (p ^ sw), gi);
      }
    }
  }
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

// KPL: 16-byte chunks of a row's span per lane (1 up to 4,096 columns, 2
// up to 8,192).  Grid: (bands of a tile, spans of a tile, tiles).  A block
// takes rows [band * x, +band) of its tile and columns [span * y, +span)
// of them; each warp its own run of those rows, in whole warp steps of
// 16-byte loads, U steps in flight.
template <int KPL>
__global__ void __launch_bounds__(THREADS)
lp_round_kernel(const uint4* __restrict__ packs,
                const int* __restrict__ labels, const int* __restrict__ r0s,
                const int* __restrict__ c0s, const int* __restrict__ valid,
                int rb, int span, int band, int* __restrict__ fused,
                int n_pad) {
  constexpr int U = 4 / KPL;  // warp steps loaded before the first is read
  const int t = blockIdx.z;
  if (!valid[t]) return;
  const int s0 = blockIdx.y * span;
  const int cols = min(span, rb - s0);
  const int r0 = r0s[t];
  const int c0 = c0s[t] + s0;  // the span's first genome column
  int* row_p = fused + 1;
  int* col_p = fused + 1 + n_pad;
  extern __shared__ int smem[];
  int* lc = smem;           // column labels of the span, at slot(c)
  int* cmin = smem + span;  // min proposing row per column, this block
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    lc[slot(c)] = labels[c0 + c];
    cmin[c] = SENT;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = cols / 128;  // 16-byte chunks of a row's span
  const int rpi = chunks >= 32 ? 1 : 32 / chunks;  // rows a warp step covers
  const int grp = chunks >= 32 ? 0 : lane / chunks;  // the lane's row of them
  const bool on = grp < rpi;  // lanes past rpi * chunks idle
  const unsigned gmask =
      chunks >= 32 ? FULL : ((1u << chunks) - 1u) << (on ? grp * chunks : 0);
  int chunk[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k)
    chunk[k] = chunks >= 32 ? lane + 32 * k : lane % chunks;

  // this warp's run of rows: [w_lo, w_hi), in whole warp steps
  const int lo = blockIdx.x * band;
  const int hi = min(lo + band, rb);
  int sub = (hi - lo + WARPS - 1) / WARPS;
  sub = (sub + rpi - 1) / rpi * rpi;
  const int w_lo = lo + warp * sub;
  const int w_hi = min(w_lo + sub, hi);
  const int row_chunks = rb / 128;
  const int step = rpi * row_chunks;  // 16-byte chunks between warp steps
  const uint4* src =
      packs + ((int64_t)t * rb + w_lo + grp) * row_chunks + s0 / 128;
  const int* lrow = labels + r0 + w_lo + grp;
  uint32_t found[KPL][4];
#pragma unroll
  for (int k = 0; k < KPL; ++k)
    found[k][0] = found[k][1] = found[k][2] = found[k][3] = 0;
  int mine = 0;
  for (int base = w_lo; base < w_hi; base += U * rpi) {
    uint4 v[U][KPL];
    int li[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = on && base + u * rpi + grp < w_hi;
      li[u] = ok ? __ldg(lrow + u * rpi) : 0;
#pragma unroll
      for (int k = 0; k < KPL; ++k)
        v[u][k] = ok && chunk[k] < chunks
                      ? load_once(src + u * step + chunk[k])
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    src += U * step;
    lrow += U * rpi;
#pragma unroll
    for (int u = 0; u < U; ++u) {  // rows in ascending order
      const int gi = r0 + base + u * rpi + grp;
      int first = SENT;  // the lane's first gated column
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int col = chunk[k] * 128;
        const uint32_t w[4] = {v[u][k].x, v[u][k].y, v[u][k].z, v[u][k].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          scan_word(w[q], lc, cmin, col + 32 * q, chunk[k] & 31, li[u], gi,
                    found[k][q], first, mine);
      }
      if (chunks >= 32) {  // one row's span across the warp
        const int m = __reduce_min_sync(FULL, first);
        if (lane == 0 && m < SENT) atomicMin(row_p + gi, c0 + m);
      } else {  // the row's lowest lane with a hit holds its minimum
        const unsigned hit = __ballot_sync(FULL, first < SENT) & gmask;
        if (first < SENT && !(hit & ((1u << lane) - 1u)))
          atomicMin(row_p + gi, c0 + first);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    const int m = cmin[slot(c)];
    if (m < SENT) atomicMin(col_p + c0 + c, m);
  }
  mine = __reduce_add_sync(FULL, mine);
  if (lane == 0 && mine) atomicAdd(fused, mine);
}

// out[2 + e] = row_p[r_lo + e]
__global__ void lp_copy_rows_kernel(const int* __restrict__ fused, int r_lo,
                                    int span, int* __restrict__ out) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < span;
       e += gridDim.x * blockDim.x)
    out[2 + e] = fused[1 + r_lo + e];
}

// exclusive prefix sum of v over the block, and the block's total; ws:
// SCAN_THREADS / 32 ints of shared memory
__device__ __forceinline__ int block_scan(int v, int* ws, int* total) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
  for (int w = 0; w < SCAN_THREADS / 32; ++w) {
    before += w < warp ? ws[w] : 0;
    all += ws[w];
  }
  __syncthreads();  // ws is rewritten by the next call
  *total = all;
  return before + incl - v;
}

// block b: how many columns of segment b propose, into fused[1 + b] (the
// scratch row_p's place, copied out by lp_copy_rows_kernel)
__global__ void __launch_bounds__(SCAN_THREADS)
lp_count_kernel(int* __restrict__ fused, int n_pad) {
  __shared__ int ws[SCAN_THREADS / 32];
  const int* col_p = fused + 1 + n_pad;
  const int c = blockIdx.x * SEG + threadIdx.x * 4;
  int n = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) n += c + q < n_pad && col_p[c + q] < SENT;
  int total;
  block_scan(n, ws, &total);
  if (threadIdx.x == 0) fused[1 + blockIdx.x] = total;
}

// block b writes segment b's proposing columns at their ordered positions
// below cap; all blocks pad [min(ncol, cap), cap) with index 0 and col_p[0]
__global__ void __launch_bounds__(SCAN_THREADS)
lp_scatter_kernel(const int* __restrict__ fused, int n_pad, int n_seg,
                  int span, int cap, int* __restrict__ out) {
  __shared__ int ws[SCAN_THREADS / 32];
  const int* counts = fused + 1;
  const int* col_p = fused + 1 + n_pad;
  int* o_idx = out + 2 + span;
  int* o_val = o_idx + cap;
  int before = 0, n = 0;
  for (int s = threadIdx.x; s < n_seg; s += SCAN_THREADS) {
    const int k = counts[s];
    n += k;
    before += s < (int)blockIdx.x ? k : 0;
  }
  int ncol, base;
  block_scan(n, ws, &ncol);
  block_scan(before, ws, &base);
  const int c = blockIdx.x * SEG + threadIdx.x * 4;
  bool p[4];
  int mine = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p[q] = c + q < n_pad && col_p[c + q] < SENT;
    mine += p[q];
  }
  int seg_total;
  int pos = base + block_scan(mine, ws, &seg_total);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (p[q]) {
      if (pos < cap) {
        o_idx[pos] = c + q;
        o_val[pos] = col_p[c + q];
      }
      ++pos;
    }
  }
  const int filled = ncol < cap ? ncol : cap;
  for (int e = filled + blockIdx.x * SCAN_THREADS + threadIdx.x; e < cap;
       e += gridDim.x * SCAN_THREADS) {
    o_idx[e] = 0;
    o_val[e] = col_p[0];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = fused[0];
    out[1] = ncol;
  }
}

// the columns a block takes: a whole row up to SPAN_FROM, spans of SPAN
// above it
int span_of(int rb) { return rb > SPAN_FROM ? SPAN : rb; }

// the band: the widest, from MAX_BAND down, whose blocks spread over the
// SMs within 10 % (the fullest SM holds at most 1.1 times the mean number
// of blocks), but no narrower than MIN_BAND, or SPAN_MIN_BAND where a tile
// has several spans (so that staging and flushing a span stay a few per
// cent of the bytes its block streams)
int band_of(int n_tiles, int rb, int sms) {
  const int spans = (rb + span_of(rb) - 1) / span_of(rb);
  const int floor_band = spans > 1 ? SPAN_MIN_BAND : MIN_BAND;
  int band = rb < MAX_BAND ? rb : MAX_BAND;
  for (;;) {
    const int64_t blocks =
        (int64_t)n_tiles * spans * ((rb + band - 1) / band);
    const int64_t fullest = (blocks + sms - 1) / sms;
    if (band <= floor_band || 10 * fullest * sms <= 11 * blocks) break;
    band /= 2;
  }
  return band;
}

template <int KPL>
cudaError_t launch_tiles(dim3 grid, size_t smem, cudaStream_t st,
                         const void* packs, const void* labels,
                         const void* r0s, const void* c0s, const void* valid,
                         int rb, int span, int band, void* fused, int n_pad) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lp_round_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  lp_round_kernel<KPL><<<grid, THREADS, smem, st>>>(
      (const uint4*)packs, (const int*)labels, (const int*)r0s,
      (const int*)c0s, (const int*)valid, rb, span, band, (int*)fused,
      n_pad);
  return cudaGetLastError();
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
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int span = span_of(rb);
  const int band = band_of(n_tiles, rb, sms);
  const dim3 grid((rb + band - 1) / band, (rb + span - 1) / span, n_tiles);
  const size_t smem = 2 * (size_t)span * sizeof(int);
  if (span / 128 <= 32)
    err = launch_tiles<1>(grid, smem, st, packs, labels, r0s, c0s, valid, rb,
                          span, band, fused, n_pad);
  else
    err = launch_tiles<2>(grid, smem, st, packs, labels, r0s, c0s, valid, rb,
                          span, band, fused, n_pad);
  return (int)err;
}

int launch_compact(void* fused, int n_pad, int r_lo, int span, int cap,
                   void* out, cudaStream_t st) {
  if (span > 0) {
    int blocks = (span + THREADS - 1) / THREADS;
    if (blocks > 1024) blocks = 1024;
    lp_copy_rows_kernel<<<blocks, THREADS, 0, st>>>((const int*)fused, r_lo,
                                                    span, (int*)out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n_seg = (n_pad + SEG - 1) / SEG;
  lp_count_kernel<<<n_seg, SCAN_THREADS, 0, st>>>((int*)fused, n_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lp_scatter_kernel<<<n_seg, SCAN_THREADS, 0, st>>>(
      (const int*)fused, n_pad, n_seg, span, cap, (int*)out);
  return (int)cudaGetLastError();
}

bool bad_round(int rb, int n_tiles) {
  return rb <= 0 || rb % 128 != 0 || rb > 16384 || n_tiles > 65535;
}

bool bad_compact(int n_pad, int r_lo, int span, int cap) {
  return n_pad <= 0 || r_lo < 0 || span < 0 || r_lo + span > n_pad ||
         cap < 0;
}

}  // namespace

extern "C" {

// packs: (n_tiles, rb, rb / 8) uint8, 16-byte aligned, updated in place;
// labels: (n_pad,) int32; clr: (4, n_clr) int32; r0s/c0s/valid:
// (n_tiles,) int32; fused: (1 + 2 * n_pad,) int32 output.
// rb % 128 == 0 (16-byte row chunks), rb <= 16384 (the engines' largest
// row block); other rb return cudaErrorInvalidValue.
int rtc_lp_round(void* packs, const void* labels, const void* clr,
                 int n_clr, const void* r0s, const void* c0s,
                 const void* valid, int n_tiles, int rb, int n_pad,
                 void* fused, void* stream) {
  if (bad_round(rb, n_tiles)) return (int)cudaErrorInvalidValue;
  return launch_round(packs, labels, clr, n_clr, r0s, c0s, valid, n_tiles,
                      rb, n_pad, fused, (cudaStream_t)stream);
}

// rtc_lp_round into the scratch ``fused``, then out: (2 + span + 2 * cap,)
// int32 = [cross, ncol, row_p[r_lo, +span), col_idx(cap), col_val(cap)].
// The compaction reuses the head of fused's row_p as scratch.
int rtc_lp_round_compact(void* packs, const void* labels, const void* clr,
                         int n_clr, const void* r0s, const void* c0s,
                         const void* valid, int n_tiles, int rb, int n_pad,
                         void* fused, int r_lo, int span, int cap, void* out,
                         void* stream) {
  if (bad_round(rb, n_tiles) || bad_compact(n_pad, r_lo, span, cap))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_round(packs, labels, clr, n_clr, r0s, c0s, valid,
                               n_tiles, rb, n_pad, fused, st);
  if (err != 0) return err;
  return launch_compact(fused, n_pad, r_lo, span, cap, out, st);
}

// the compaction of rtc_lp_round_compact alone, over a given fused (whose
// row_p head it overwrites)
int rtc_lp_compact(void* fused, int n_pad, int r_lo, int span, int cap,
                   void* out, void* stream) {
  if (bad_compact(n_pad, r_lo, span, cap)) return (int)cudaErrorInvalidValue;
  return launch_compact(fused, n_pad, r_lo, span, cap, out,
                        (cudaStream_t)stream);
}

}  // extern "C"
