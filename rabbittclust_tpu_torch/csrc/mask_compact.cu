// Ordered compaction of the filter's packed masks (kernel K3) for Hopper.
//
// Replaces the index half of rabbittclust_tpu/ops/bitmap.py::
// _batched_filter_fn (:389) over compact_mask_two_level (:296): the jitted
// program rebuilds a batch's candidate masks and writes every set position
// of tile t, encoded t * rb^2 + r * rb + c, at the running total, in tile
// order and row-major within a tile.  Here the masks are already resident:
// K1 (filter_mask.cu), K4's mask mode or the ring step wrote them packed,
// (k, rb, rb / 8) uint8, little bit order, and their exact per-tile counts
// into device memory.  A tile's packed mask is its flat row-major bit array
// (bit r * rb + c at byte (r * rb + c) / 8), read here as 16-byte chunks
// of four 32-bit words.
//
// One launch, one read of the masks, no host work between the counts and
// the indices (a single-pass scan with decoupled look-back, Merrill and
// Garland 2016).  Each block covers a segment of one tile, 16 KB (4 KB
// where the grid would be small):
//   1. it takes its place from an atomic ticket (not from blockIdx), so it
//      never waits on a block that has not started;
//   2. meanwhile one warp reads the tiles' counts (at most a few dozen a
//      launch): the grid covers every tile (the host selects none), the
//      first live * n_seg tickets, live the tiles with a count, take the
//      live tiles' segments, and the other blocks stop, reading no mask; a
//      tile's first output is the sum of the counts before it;
//   3. it loads its segment into registers (eight or two 16-byte chunks a
//      thread, a warp's loads contiguous) and counts it: a warp scan a
//      chunk, then each warp's scan over the block's (chunk, warp) runs;
//   4. it publishes its count, looks back over its predecessors' status
//      words in the tile (the whole block, THREADS words at a time, so that
//      one round reaches past the blocks still running) and publishes its
//      inclusive prefix; a block with no set bit publishes its count and
//      stops;
//   5. it writes its bits from the registers, each warp its runs on its
//      own (128 consecutive words a chunk, their bits to consecutive
//      slots), with no barrier of the block.  Where every lane holds few
//      bits (at most DENSE), each lane writes its own (__ffs): the lanes'
//      runs are neighbours, so a warp's store covers a few consecutive
//      lines.  Else the warp goes word by word, lane b writing bit b, so
//      that a dense word leaves in one store to consecutive slots.  No
//      shared-memory stage is needed for either.
// The output order is thus fixed by the counts and the scans, not by any
// race, and equals the JAX program's element for element.
//
// Nothing is cleared between launches.  The status words carry the
// launch's epoch (the host's count of launches on the scratch, 30 bits): a
// word of another epoch counts as unpublished.  The block that takes the
// grid's last ticket puts the ticket word back to 0.  The scratch is zeroed
// once, when the wrapper allocates it; launches sharing it run in stream
// order (one stream a device).
//
// Row form (rtc_mask_compact_rows), the second half of kernel K6
// (rabbittclust_tpu/ops/greedy_device.py::_greedy_filter_fn): one (rows,
// 128 row_chunks) mask of a batch against its reps, written by K1's
// gathered form with whole 16-byte chunks a row, its count from K1's
// atomics; the same kernel numbers a row's bits row * out_cols + column,
// the JAX program's b_local * R + r_local, in order.
//
// Bound: device memory bandwidth.  The masks of the tiles with a candidate
// are read once and 4 bytes are written per set bit; the writes leave in
// runs of consecutive slots.  The scan's status words and the counts are a
// few bytes a block.  What holds it above the bound is latency: a block's
// ticket, counts, loads, look-back and stores come one after another, and
// an SM holds six blocks of the wide form (96 KB of masks in flight); on
// small batches that chain is the whole time.
//
// Plain C interface, loaded with ctypes; the entry points launch on the
// given stream and return the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// 16-byte chunks a thread holds: 8 (a block covers 16 KB of a tile), or 2
// (4 KB) where the 16 KB form would give the card under two blocks an SM
constexpr int CHUNKS_WIDE = 8, CHUNKS_NARROW = 2;
constexpr int WIDE_MIN_BLOCKS = 2 * 132;
// a lane's set bits in one chunk above which the warp writes the chunks
// word by word
constexpr int DENSE = 16;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNKS_WIDE * WARPS <= 32, "one warp scans the run table");

// a status word: value (bits 0-31), flag (32-33), epoch (34-63)
constexpr unsigned long long kAggregate = 1ull;
constexpr unsigned long long kPrefix = 2ull;
constexpr unsigned kEpochMask = (1u << 30) - 1;

struct Args {
  const uint32_t* packs;
  const int* src;        // (m,) source tile of each output tile, or null
  const int* counts;     // exact count of each source tile
  const int* codes;      // (m,) code of each output tile, or null: q
  long long tile_words;  // words a tile (a multiple of 4)
  int m, n_seg;          // n_seg: blocks a tile in the form launched
  unsigned code_mul;     // rb^2, or 0 for local positions
  int row_words, out_cols;  // row form
  int limit;
  int* out;
  int* head;             // [total] or [total, largest count], or null
  int head_len;
  int pad_cap, pad_value;
  unsigned* ticket;      // the scratch's ticket word, 0 between launches
  unsigned epoch;
  unsigned long long* status;
};

// The flag, the epoch and the value share one aligned 64-bit word, which
// one store writes and one load reads: no other memory is published with
// it, so relaxed accesses at device scope order all that needs ordering
// (an acquire or release would only add a fence).
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flag, unsigned value, unsigned epoch) {
  return ((unsigned long long)epoch << 34) | (flag << 32) | value;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ int popc4(const uint4& v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// the code of bit 0 of word gw of a tile (gw a multiple of 4: its chunk's
// four words follow at + 32 apart, a chunk lying in one row): its flat
// position r * rb + c after the tile's code, or, in the row form, row *
// out_cols + column (a row form's tile is below 2^26 words)
template <bool ROWS>
__device__ __forceinline__ unsigned chunk_code(const Args& a, unsigned code,
                                               long long gw) {
  if (!ROWS) return code + (unsigned)gw * 32u;
  const unsigned w = (unsigned)gw, row = w / (unsigned)a.row_words;
  return code + row * (unsigned)a.out_cols + (w - row * a.row_words) * 32u;
}

// v summed over the block; every thread must call it
__device__ long long block_sum(long long v) {
  __shared__ long long part[WARPS];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  long long all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) all += part[w];
  __syncthreads();  // part is rewritten by the next call
  return all;
}

// The exclusive prefix of this block within its tile: the whole block
// walks its predecessors' status words back, THREADS at a time (thread i
// reads the (i + 1)-th nearest), to the nearest inclusive prefix (the
// tile's first block always publishes one), waiting only while a nearer
// word is unpublished.  Every thread must call it.
__device__ long long look_back(const Args& a, int g, int s, unsigned epoch) {
  __shared__ unsigned bal[2][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = g - s;
  long long acc = 0;
  for (int j = g - 1;; j -= THREADS) {
    const int idx = j - tid;
    unsigned long long v;
    int d_pre;
    while (true) {
      // words before the tile's first block read as a zero prefix
      v = idx >= first ? load_status(a.status + idx)
                       : status_word(kPrefix, 0u, epoch);
      const unsigned flag = (unsigned)(v >> 32) & 3u;
      const bool ok = flag != 0 && (unsigned)(v >> 34) == epoch;
      const unsigned bad = __ballot_sync(FULL, !ok);
      const unsigned pre = __ballot_sync(FULL, ok && flag == kPrefix);
      if (lane == 0) {
        bal[0][warp] = bad;
        bal[1][warp] = pre;
      }
      __syncthreads();
      int d_bad = THREADS;
      d_pre = THREADS;
#pragma unroll
      for (int w = WARPS - 1; w >= 0; --w) {
        if (bal[0][w]) d_bad = w * 32 + __ffs(bal[0][w]) - 1;
        if (bal[1][w]) d_pre = w * 32 + __ffs(bal[1][w]) - 1;
      }
      __syncthreads();  // bal is rewritten by the next round
      if (d_bad > d_pre || d_bad == THREADS) break;
    }
    acc += block_sum(tid <= d_pre ? (long long)(unsigned)v : 0);
    if (d_pre < THREADS) return acc;
  }
}

// warp 0: the counts before tile q (all before a q of -1), of all, and
// the largest, into sums
__device__ void count_sums(const Args& a, int q, long long* sums) {
  const int lane = threadIdx.x;
  long long before = 0, total = 0, top = 0;
  for (int i = lane; i < a.m; i += 32) {
    const int c = a.counts[a.src ? a.src[i] : i];
    total += c;
    top = c > top ? c : top;
    if (i < q) before += c;
  }
  before = warp_sum(before);
  total = warp_sum(total);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long u = __shfl_xor_sync(FULL, top, off);
    top = u > top ? u : top;
  }
  if (lane == 0) {
    sums[0] = before;
    sums[1] = total;
    sums[2] = top;
  }
}

// the head and batched_filter's padding (the last tile's encoded -1 from
// the total on to its first output + cap, spread over the grid); sums from
// count_sums
__device__ void head_and_padding(const Args& a, const long long* sums) {
  const int tid = threadIdx.x;
  const long long total = sums[1];
  if (blockIdx.x == 0 && tid == 0 && a.head) {
    a.head[0] = total < INT_MAX ? (int)total : INT_MAX;
    if (a.head_len > 1) a.head[1] = (int)sums[2];
  }
  if (a.pad_cap > 0) {
    const int last = a.counts[a.src ? a.src[a.m - 1] : a.m - 1];
    long long end = total - last + a.pad_cap;
    end = end < a.limit ? end : a.limit;
    for (long long p = total + (long long)blockIdx.x * THREADS + tid;
         p < end; p += (long long)gridDim.x * THREADS)
      a.out[p] = a.pad_value;
  }
}

// segment s of tile q as live segment g; warp 0 fills sums (count_sums)
template <bool ROWS, int CHUNKS>
__device__ void compact_block(const Args& a, int g, int q, int s,
                              long long* sums) {
  constexpr int SEG = THREADS * CHUNKS * 4;  // words a block covers
  constexpr int RUNS = CHUNKS * WARPS;       // (chunk, warp) runs a block
  __shared__ int table[RUNS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int src = a.src ? a.src[q] : q;

  // the segment: chunk c of thread tid is the segment's chunk c * THREADS
  // + tid (a warp's loads contiguous)
  const uint4* tile =
      reinterpret_cast<const uint4*>(a.packs + (long long)src * a.tile_words);
  const long long c0 = (long long)s * (SEG / 4);
  uint4 v[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const long long j = c0 + c * THREADS + tid;
    v[c] = j < a.tile_words / 4 ? __ldg(tile + j)
                                : make_uint4(0u, 0u, 0u, 0u);
  }
  if (warp == 0) count_sums(a, q, sums);  // while the loads are in flight
  // each lane's inclusive rank in its warp's run of each chunk
  int incl[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    int x = popc4(v[c]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += u;
    }
    incl[c] = x;
    if (lane == 31) table[c * WARPS + warp] = x;
  }
  __syncthreads();
  head_and_padding(a, sums);
  // each (chunk, warp) run's first rank in the segment, in flat order:
  // every warp scans the table itself
  int run_at = lane < RUNS ? table[lane] : 0;
  const int own = run_at;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(FULL, run_at, off);
    if (lane >= off) run_at += u;
  }
  const int agg = __shfl_sync(FULL, run_at, 31);
  run_at -= own;

  // publish, look back, publish the inclusive prefix
  if (tid == 0)
    store_status(a.status + g, status_word(s == 0 ? kPrefix : kAggregate,
                                           (unsigned)agg, a.epoch));
  if (agg == 0) return;
  long long excl = 0;
  if (s > 0) {
    excl = look_back(a, g, s, a.epoch);
    if (tid == 0)
      store_status(a.status + g,
                   status_word(kPrefix, (unsigned)(excl + agg), a.epoch));
  }
  const long long pos = sums[0] + excl;
  const unsigned code = (unsigned)(a.codes ? a.codes[q] : q) * a.code_mul;

  // the bits, a chunk at a time: the warp's 32 lanes hold 128 consecutive
  // words, whose bits go to one run of consecutive slots
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int run = __shfl_sync(FULL, incl[c], 31);
    if (run == 0) continue;
    const long long base = pos + __shfl_sync(FULL, run_at, c * WARPS + warp);
    const unsigned word[4] = {v[c].x, v[c].y, v[c].z, v[c].w};
    const int mine = popc4(v[c]);
    // the code of the lane's first word
    const unsigned at = mine ? chunk_code<ROWS>(
        a, code, (c0 + c * THREADS + tid) * 4) : 0u;
    if (__reduce_max_sync(FULL, (unsigned)mine) <= DENSE) {
      // few bits a lane: each lane writes its own; the lanes' runs are
      // neighbours, so a warp's store covers a few consecutive lines
      long long p = base + incl[c] - mine;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        for (unsigned x = word[i]; x; x &= x - 1, ++p)
          if (p < a.limit)
            a.out[p] = (int)(at + 32u * i + (unsigned)(__ffs(x) - 1));
    } else {
      // dense: word by word, lane b writing bit b, so that a word's bits
      // go out in one store to consecutive slots
      long long p = base;
      const unsigned below = (1u << lane) - 1u;
      for (int o = 0; o < 32; ++o) {
        const unsigned at_o = __shfl_sync(FULL, at, o) + (unsigned)lane;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned x = __shfl_sync(FULL, word[i], o);
          if (!x) continue;
          const long long pp = p + __popc(x & below);
          if ((x >> lane) & 1u && pp < a.limit)
            a.out[pp] = (int)(at_o + 32u * i);
          p += __popc(x);
        }
      }
    }
  }
}

template <bool ROWS, int CHUNKS>
__global__ void __launch_bounds__(THREADS) mc_compact_kernel(Args a) {
  __shared__ int s_g, s_q;
  __shared__ long long sums[3];
  if (threadIdx.x < 32) {
    // warp 0: a ticket, and meanwhile the counts.  Tickets are taken in
    // the order the blocks start; the first live * n_seg of them, live the
    // tiles with a count, take the live tiles' segments, and the others
    // stop there, reading no mask
    const int lane = threadIdx.x;
    unsigned t = 0;
    if (lane == 0) {
      t = atomicAdd(a.ticket, 1u);
      // the last ticket: every block has taken one, so the word goes back
      // to 0 for the next launch
      if (t == gridDim.x - 1) *a.ticket = 0u;
    }
    unsigned lv[1];  // the live tiles among the first 32 (most launches)
    int live = 0, q = -1;
    for (int i0 = 0; i0 < a.m; i0 += 32) {
      const int i = i0 + lane;
      const int c = i < a.m ? a.counts[a.src ? a.src[i] : i] : 0;
      const unsigned b = __ballot_sync(FULL, c > 0);
      if (i0 == 0) lv[0] = b;
      live += __popc(b);
    }
    const int g = (int)__shfl_sync(FULL, t, 0);
    if (g < (long long)live * a.n_seg) {
      // live segment g is segment g % n_seg of the (g / n_seg)-th tile
      // with a count
      int k = g / a.n_seg;
      for (int i0 = 0;; i0 += 32) {
        unsigned b = lv[0];
        if (i0) {
          const int i = i0 + lane;
          b = __ballot_sync(FULL, i < a.m &&
                                      a.counts[a.src ? a.src[i] : i] > 0);
        }
        const int n = __popc(b);
        if (k < n) {
          for (int j = 0; j < k; ++j) b &= b - 1;
          q = i0 + __ffs(b) - 1;
          break;
        }
        k -= n;
      }
    }
    if (lane == 0) {
      s_g = q < 0 ? -1 : g;
      s_q = q;
    }
  }
  __syncthreads();
  if (s_g >= 0) {
    compact_block<ROWS, CHUNKS>(a, s_g, s_q, s_g % a.n_seg, sums);
  } else if ((blockIdx.x == 0 && a.head) || a.pad_cap > 0) {
    if (threadIdx.x < 32) count_sums(a, -1, sums);
    __syncthreads();
    head_and_padding(a, sums);
  }
}

template <bool ROWS>
void launch_form(const Args& a, bool wide, int grid, cudaStream_t st) {
  if (wide)
    mc_compact_kernel<ROWS, CHUNKS_WIDE><<<grid, THREADS, 0, st>>>(a);
  else
    mc_compact_kernel<ROWS, CHUNKS_NARROW><<<grid, THREADS, 0, st>>>(a);
}

int launch(Args& a, void* scratch, int scratch_blocks, unsigned epoch,
           cudaStream_t st) {
  const long long seg_wide = THREADS * CHUNKS_WIDE * 4;
  const long long seg_narrow = THREADS * CHUNKS_NARROW * 4;
  const long long n_wide = (a.tile_words + seg_wide - 1) / seg_wide;
  const bool wide = a.m * n_wide >= WIDE_MIN_BLOCKS;
  a.n_seg = (int)(wide ? n_wide : (a.tile_words + seg_narrow - 1) /
                                      seg_narrow);
  const long long grid = (long long)a.m * a.n_seg;
  if (grid <= 0 || grid > INT_MAX || grid > scratch_blocks || !scratch ||
      (epoch & kEpochMask) != epoch || epoch == 0)
    return (int)cudaErrorInvalidValue;
  a.ticket = (unsigned*)scratch;
  a.epoch = epoch;
  a.status = (unsigned long long*)scratch + 1;
  if (a.out_cols)
    launch_form<true>(a, wide, (int)grid, st);
  else
    launch_form<false>(a, wide, (int)grid, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The m output tiles: tile q is source tile src[q] (src null: q) of packs
// (k, rb, rb / 8) uint8, 16-byte aligned; counts: K1's exact count of each
// source tile, int32 on the device; its set bits are written at the sum of
// the counts of the tiles before it, encoded codes[q] * rb^2 + r * rb + c
// (codes null: q; local != 0: r * rb + c), no write at or past limit.
// head, when given, receives the total (all counts, also past limit) and,
// with head_len 2, the largest count; pad_cap > 0 writes pad_value over
// out[total : total - count of the last tile + pad_cap] (below limit).
// scratch: the ticket word (8 bytes) then scratch_blocks status words (8
// bytes each), zeroed once; epoch: this launch's (1 to 2^30 - 1, another
// than the last launch's on the scratch); at most m * ceil(rb^2 / 32 /
// 1024) blocks.  rb % 32 ==
// 0, rb^2 < 2^31, m > 0; others return cudaErrorInvalidValue.
int rtc_mask_compact(const void* packs, const void* src, const void* counts,
                     const void* codes, int m, int rb, int local, int limit,
                     void* out, void* head, int head_len, int pad_cap,
                     int pad_value, void* scratch, int scratch_blocks,
                     unsigned epoch, void* stream) {
  if (rb <= 0 || rb % 32 != 0 || (long long)rb * rb >= (1LL << 31) ||
      m <= 0 || limit < 0 || head_len < 0 || head_len > 2 ||
      (head_len > 0) != (head != nullptr) || pad_cap < 0 || !counts)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.packs = (const uint32_t*)packs;
  a.src = (const int*)src;
  a.counts = (const int*)counts;
  a.codes = (const int*)codes;
  a.tile_words = (long long)rb * rb / 32;
  a.m = m;
  a.code_mul = local ? 0u : (unsigned)rb * (unsigned)rb;
  a.limit = limit;
  a.out = (int*)out;
  a.head = (int*)head;
  a.head_len = head_len;
  a.pad_cap = pad_cap;
  a.pad_value = pad_value;
  return launch(a, scratch, scratch_blocks, epoch, (cudaStream_t)stream);
}

// K6's compaction: the set bits of one (rows, 128 row_chunks) packed mask,
// row-major, as int32 r * out_cols + c (c < out_cols <= 128 row_chunks),
// in order from out[0]; no write at or past limit.  count: the mask's
// exact count on the device; scratch as above, at most ceil(rows *
// row_chunks * 4 / 1024) blocks.  rows * row_chunks * 128 < 2^31.
int rtc_mask_compact_rows(const void* packs, int rows, int row_chunks,
                          int out_cols, const void* count, void* scratch,
                          int scratch_blocks, unsigned epoch, int limit,
                          void* out, void* stream) {
  if (rows <= 0 || row_chunks <= 0 || out_cols <= 0 ||
      out_cols > 128 * row_chunks ||
      (long long)rows * row_chunks * 128 >= (1LL << 31) || limit < 0 ||
      !count)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.packs = (const uint32_t*)packs;
  a.counts = (const int*)count;
  a.tile_words = (long long)rows * row_chunks * 4;
  a.m = 1;
  a.row_words = row_chunks * 4;
  a.out_cols = out_cols;
  a.limit = limit;
  a.out = (int*)out;
  return launch(a, scratch, scratch_blocks, epoch, (cudaStream_t)stream);
}

}  // extern "C"
