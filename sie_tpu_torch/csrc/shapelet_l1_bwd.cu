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
// broadcast float4 that serves all its taps. The block's body is
// `l1_bwd_block` in shapelet_common.cuh, which K4 runs too.

#include "shapelet_common.cuh"

namespace {

using namespace shapelet;

template <int NS, int LPT, bool SQ>
__global__ void __launch_bounds__(THREADS)
l1_bwd_partial(const float* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ g, float* __restrict__ ws, int B,
               int C, int T, int n, int L, int W, int tiles, int chunks,
               int bchunk) {
  __shared__ __align__(16) float gs[NS * WC];
  __shared__ float xs[bwd_xs_floats(LPT)];
  __shared__ float gw[NS * (THREADS / 32)];   // per-warp shares of G
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int chunk = bid % chunks;
  l1_bwd_block<NS, LPT, SQ>(x, s, g, ws, B, C, T, n, L, W, tile, chunk,
                            bid / chunks, bchunk, blockIdx.y, gs, xs, gw);
}

__global__ void l1_bwd_reduce(const float* __restrict__ ws,
                              float* __restrict__ out, int count, int parts,
                              float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) l1_bwd_reduce_one(ws, out, i, count, parts, scale);
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
  switch (bwd_lpt(L)) {
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
  switch (n < 1 ? 0 : bwd_rows(n)) {
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
