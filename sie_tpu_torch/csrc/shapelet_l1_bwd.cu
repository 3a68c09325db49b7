// K2: backward of the L1 / squared sliding shapelet distance with respect
// to the shapelet bank (K1 is the forward):
//
//   'euclidean'   grad_s[j, c, l] = (1/L) sum_{b,w} g[b, j, c, w] *
//                                   (s[j, c, l] > x[b, c, w + l] ? +1 : -1)
//   'sqeuclidean' grad_s[j, c, l] = (2/L) sum_{b,w} g[b, j, c, w] *
//                                   (s[j, c, l] - x[b, c, w + l])
//
// Replaces the Pallas kernel `_bwd_kernel` of
// sie_tpu/ops/pallas/shapelet_pallas.py (launched by `_l1_bwd_impl`, rule
// `_l1_bwd_rule`). At an exact tie s == x it adds -g, as that kernel's
// `jnp.where(s_tile > xs, g, -g)` does (where the JAX scan rule's sign
// gives 0). The gradient with respect to x is zero by the JAX package's
// contract and is not computed.
//
// What bounds it on an H100: arithmetic, as in K1. At the flagship (B=64,
// C=122, n=10, six banks) there are 5.1e10 taps against ~1.1 GB of g read
// once, so the FP32 ALUs set the floor. A tap is made cheap by splitting
// off the part that does not depend on the tap: with G = sum_{b,w} g,
//   L1: sum g * (s > x ? 1 : -1) = 2 * sum g * [s > x] - G,
//   sq: sum g * (s - x)          = s * G - sum g * x,
// so the L1 tap is a compare that yields 1.0 or 0.0 and an FMA, and the sq
// tap one FMA; G is summed once per window as g is staged.
//
// Design: the TPU kernel kept the whole (n, L, C) gradient resident in VMEM
// and let its sequential grid add into it. CUDA blocks run in no order, so
// here each block owns (channel c, a tile of taps, a chunk of at most 16
// shapelet rows, a chunk of batch rows) and writes its partial sums to a
// workspace (one slice per batch chunk); a second launch adds the slices in
// a fixed order and applies 1/L (2/L). No float atomics: the result is the
// same bit for bit on every run. Within a block, each of 64 threads owns
// LPT taps strided by the block width and keeps NS x LPT accumulators and
// the matching shapelet values in registers. The block stages, for one
// batch row at a time, 256 windows of g[b, rows, c, :] and the x segment
// they touch in shared memory; each thread adds the g values it stages to
// its share of G, and the shares are summed in a fixed order at the end. A
// thread reads each x value once per window (neighbouring threads on
// neighbouring taps: no bank conflicts) and g four windows at a time as a
// broadcast float4 that serves all its taps.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int WC = 256;              // windows staged per pass
constexpr int NS_MAX = 16;           // shapelet rows per block at most

template <int NS, int LPT, bool SQ>
__global__ void __launch_bounds__(THREADS)
l1_bwd_partial(const float* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ g, float* __restrict__ ws, int B,
               int C, int T, int n, int L, int W, int tiles, int chunks,
               int bchunk) {
  __shared__ __align__(16) float gs[NS * WC];
  __shared__ float xs[WC + THREADS * LPT + 4];
  __shared__ float gw[NS][THREADS / 32];   // per-warp shares of G

  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int chunk = bid % chunks;
  const int bc = bid / chunks;
  const int c = blockIdx.y;
  const int n0 = chunk * NS;
  const int l0 = tile * THREADS * LPT;
  const int tid = threadIdx.x;
  const int b_end = min(B, (bc + 1) * bchunk);

  // acc: sum g * [s > x] (L1) or sum g * x (sq); gsum: this thread's
  // share of G = sum g, one per shapelet row
  float sv[NS][LPT], acc[NS][LPT], gsum[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    gsum[j] = 0.f;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = l0 + tid + k * THREADS;
      sv[j][k] = (n0 + j < n && l < L) ? s[((size_t)(n0 + j) * C + c) * L + l]
                                       : 0.f;
      acc[j][k] = 0.f;
    }
  }

  for (int b = bc * bchunk; b < b_end; ++b) {
    const float* xrow = x + ((size_t)b * C + c) * T;
    for (int w0 = 0; w0 < W; w0 += WC) {
      const int wc = min(WC, W - w0);
      const int wc4 = (wc + 3) & ~3;
      __syncthreads();   // the previous pass is done with xs and gs
      for (int i = tid; i < wc4 + THREADS * LPT; i += THREADS) {
        const int t = w0 + l0 + i;
        xs[i] = t < T ? xrow[t] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bool row = n0 + j < n;
        const float* grow = g + (((size_t)b * n + n0 + j) * C + c) * W + w0;
        for (int w = tid; w < WC; w += THREADS) {
          const float v = (row && w < wc) ? grow[w] : 0.f;
          gs[j * WC + w] = v;
          gsum[j] += v;
        }
      }
      __syncthreads();

      // windows past W carry g = 0 and add nothing
      for (int w = 0; w < wc4; w += 4) {
        float xv[LPT][4];
#pragma unroll
        for (int k = 0; k < LPT; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[k][q] = xs[w + q + tid + k * THREADS];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 gv = *reinterpret_cast<const float4*>(&gs[j * WC + w]);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int k = 0; k < LPT; ++k)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[j][k] = fmaf(g4[q],
                               SQ ? xv[k][q]
                                  : (sv[j][k] > xv[k][q] ? 1.f : 0.f),
                               acc[j][k]);
        }
      }
    }
  }

  // G of each row: warp sums, then the two warps' sums in order
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float v = gsum[j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tid % 32 == 0) gw[j][tid / 32] = v;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (n0 + j >= n) break;
    float G = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) G += gw[j][i];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int l = l0 + tid + k * THREADS;
      if (l < L)
        ws[(((size_t)bc * n + n0 + j) * C + c) * L + l] =
            SQ ? sv[j][k] * G - acc[j][k] : 2.f * acc[j][k] - G;
    }
  }
}

// out[i] = scale * sum over the batch chunks p, in order, of ws[p][i]
__global__ void l1_bwd_reduce(const float* __restrict__ ws,
                              float* __restrict__ out, int count, int parts,
                              float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += ws[(size_t)p * count + i];
  out[i] = acc * scale;
}

template <int NS, int LPT>
void launch_partial(const float* x, const float* s, const float* g, float* ws,
                    int B, int C, int T, int n, int L, int bchunk, bool sq,
                    cudaStream_t stream) {
  const int W = T - L + 1;
  const int tiles = (L + THREADS * LPT - 1) / (THREADS * LPT);
  const int chunks = (n + NS - 1) / NS;
  const int parts = (B + bchunk - 1) / bchunk;
  const dim3 grid(tiles * chunks * parts, C);
  if (sq)
    l1_bwd_partial<NS, LPT, true><<<grid, THREADS, 0, stream>>>(
        x, s, g, ws, B, C, T, n, L, W, tiles, chunks, bchunk);
  else
    l1_bwd_partial<NS, LPT, false><<<grid, THREADS, 0, stream>>>(
        x, s, g, ws, B, C, T, n, L, W, tiles, chunks, bchunk);
}

template <int NS>
void launch_ns(const float* x, const float* s, const float* g, float* ws,
               int B, int C, int T, int n, int L, int bchunk, bool sq,
               cudaStream_t stream) {
  // taps per thread: enough for L up to 256 in one tile, else 4 per tile
  const int lpt = (L + THREADS - 1) / THREADS;
  switch (lpt < 4 ? lpt : 4) {
    case 1: launch_partial<NS, 1>(x, s, g, ws, B, C, T, n, L, bchunk, sq, stream); break;
    case 2: launch_partial<NS, 2>(x, s, g, ws, B, C, T, n, L, bchunk, sq, stream); break;
    case 3: launch_partial<NS, 3>(x, s, g, ws, B, C, T, n, L, bchunk, sq, stream); break;
    default: launch_partial<NS, 4>(x, s, g, ws, B, C, T, n, L, bchunk, sq, stream); break;
  }
}

}  // namespace

// x (B, C, T), s (n, C, L), g (B, n, C, T - L + 1), grad_s (n, C, L):
// contiguous float32 on the device; ws a float32 workspace of
// ceil(B / batch_chunk) * n * C * L. The caller checks shapes and grid
// limits (C <= 65535).
extern "C" int shapelet_l1_bwd(const void* x, const void* s, const void* g,
                               void* ws, void* grad_s, int B, int C, int T,
                               int n, int L, int batch_chunk, int squared,
                               void* stream) {
  if (batch_chunk < 1) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(s);
  const float* gp = static_cast<const float*>(g);
  float* wp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sq = squared != 0;
  // balanced chunks of at most 16 rows, rounded up to an even count
  const int chunks = (n + NS_MAX - 1) / NS_MAX;
  const int ns = (((n + chunks - 1) / chunks) + 1) & ~1;
  switch (ns) {
#define K2_CASE(N) \
    case N: launch_ns<N>(xp, sp, gp, wp, B, C, T, n, L, batch_chunk, sq, st); break;
    K2_CASE(2) K2_CASE(4) K2_CASE(6) K2_CASE(8) K2_CASE(10) K2_CASE(12)
    K2_CASE(14) K2_CASE(16)
#undef K2_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int count = n * C * L;
  const int parts = (B + batch_chunk - 1) / batch_chunk;
  const float scale = (sq ? 2.f : 1.f) / (float)L;
  l1_bwd_reduce<<<(count + 255) / 256, 256, 0, st>>>(
      wp, static_cast<float*>(grad_s), count, parts, scale);
  return (int)cudaGetLastError();
}
