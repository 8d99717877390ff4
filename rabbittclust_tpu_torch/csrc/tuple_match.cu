// Positional token matches for the WMH / OMH sketches (kernel K8) for
// Hopper.
//
// Replaces rabbittclust_tpu/ops/extra_pairs.py::_jitted_match (:48), driven
// by pairwise_tuple_matches (:59): tok is (n, s, c) uint32 token planes
// (a sketch's s samples, each c 32-bit words); out[i][j] is the number of
// samples at which all c words of genome i equal those of genome j.  The
// JAX program broadcasts a (512, n, s, c) equality per row block.
//
// Here a block owns a tile of 64 x 64 pairs and walks the samples in
// chunks of SCH: it stages the chunk's words of its 64 i-rows and 64
// j-rows in shared memory, word-major with the 64 rows side by side (a
// padded row of 65 words keeps the transposing store free of bank
// conflicts), and each of its 256 threads keeps a 4 x 4 register tile of
// pairs (rows ty + 16 a, columns tx + 16 b).  A sample matches when the
// OR of the c XORs is zero.  Counts are exact integers: the matrix is
// written once and equals the plain version element for element.
//
// Bound: the n^2 s c word compares over the CUDA cores (about 67 TOP/s on
// an H100 SXM), beside 4 n^2 bytes written; the tokens (n s c words) are
// read from memory once a tile row and stay in the 50 MB L2.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream and returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;        // rows and columns of a block's pair tile
constexpr int THREADS = 256;
constexpr int SCH = 8;       // samples a shared-memory chunk holds
constexpr int PAD = T + 1;

template <int C>
__global__ void __launch_bounds__(THREADS)
tm_kernel(const uint32_t* __restrict__ tok, int n, int s,
          int* __restrict__ out) {
  __shared__ uint32_t ti[SCH * C][PAD];
  __shared__ uint32_t tj[SCH * C][PAD];
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row_words = (size_t)s * C;
  int cnt[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) cnt[a][b] = 0;
  for (int s0 = 0; s0 < s; s0 += SCH) {
    const int ns = min(SCH, s - s0);
    const int words = ns * C;
    __syncthreads();  // the previous chunk is read
    for (int l = threadIdx.x; l < T * words; l += THREADS) {
      const int r = l / words, w = l - r * words;
      const int gi = i0 + r, gj = j0 + r;
      const size_t off = (size_t)s0 * C + w;
      ti[w][r] = gi < n ? __ldg(tok + gi * row_words + off) : 0u;
      tj[w][r] = gj < n ? __ldg(tok + gj * row_words + off) : 0u;
    }
    __syncthreads();
    for (int q = 0; q < ns; ++q) {
      uint32_t a[4][C], b[4][C];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u][c] = ti[q * C + c][ty + 16 * u];
          b[u][c] = tj[q * C + c][tx + 16 * u];
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          uint32_t diff = 0;
#pragma unroll
          for (int c = 0; c < C; ++c) diff |= a[u][c] ^ b[v][c];
          cnt[u][v] += diff == 0u;
        }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= n) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j < n) out[(size_t)i * n + j] = cnt[u][v];
    }
  }
}

template <int C>
cudaError_t launch(const void* tok, int n, int s, void* out,
                   cudaStream_t st) {
  const dim3 grid((n + T - 1) / T, (n + T - 1) / T);
  tm_kernel<C><<<grid, THREADS, 0, st>>>((const uint32_t*)tok, n, s,
                                         (int*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tok: (n, s, c) uint32, contiguous; out: (n, n) int32.  1 <= c <= 8,
// s >= 1, 0 < n <= 65535 * 64; others return cudaErrorInvalidValue.
int rtc_tuple_match(const void* tok, int n, int s, int c, void* out,
                    void* stream) {
  if (n <= 0 || n > 65535 * T || s <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1: return (int)launch<1>(tok, n, s, out, st);
    case 2: return (int)launch<2>(tok, n, s, out, st);
    case 3: return (int)launch<3>(tok, n, s, out, st);
    case 4: return (int)launch<4>(tok, n, s, out, st);
    case 5: return (int)launch<5>(tok, n, s, out, st);
    case 6: return (int)launch<6>(tok, n, s, out, st);
    case 7: return (int)launch<7>(tok, n, s, out, st);
    case 8: return (int)launch<8>(tok, n, s, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
