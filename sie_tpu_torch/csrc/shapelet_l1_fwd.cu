// K1: forward of the L1 / squared sliding shapelet distance.
//
//   d[b, j, c, w] = (1/L) * sum_l op(x[b, c, w + l] - s[j, c, l]),
//   op = |.| (metric 'euclidean') or (.)^2 ('sqeuclidean'), stride 1.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// sie_tpu/ops/pallas/shapelet_pallas.py (launched by `_l1_fwd`).
//
// What bounds it on an H100: arithmetic. Each tap is two FP32 instructions
// (a subtract, then an add with the |.| modifier, or an FMA for the square),
// and there is no matrix-unit form of |.|. At the flagship shapes
// (B=64, C=122, n=10, six banks) that is ~1e11 FP32 operations against
// ~1.1 GB of output, so the ALUs, not memory, set the floor.
//
// Design: one block per (window tile, shapelet chunk, batch row) and channel.
// The block stages LC taps of its x row segment and of s[chunk, c, :] in
// shared memory; each of its 64 threads owns WPT windows, strided by the
// block width so that the x reads and the output stores are coalesced along
// W. A thread keeps NS x WPT accumulators in registers: every x value it
// reads from shared memory serves all NS shapelets, and every s value (read
// four taps at a time as a broadcast float4) serves all WPT windows, so the
// loop issues about one shared-memory load for every six FP32 instructions.
// Taps are summed in order, like the JAX scan. Shapelet banks of more than
// 16 rows are split into equal chunks (the grid's chunk index); the rows of
// a last, shorter chunk are zero-filled and never stored. The block's body
// is `l1_fwd_block` in shapelet_common.cuh, which K3 runs too.

#include "shapelet_common.cuh"

namespace {

using namespace shapelet;

template <int NS, bool SQ>
__global__ void __launch_bounds__(THREADS)
l1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
              float* __restrict__ out, int C, int T, int n, int L, int W,
              int tiles, int chunks) {
  __shared__ float xs[WT + LC];
  __shared__ __align__(16) float ss[NS * LC];
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int chunk = bid % chunks;
  l1_fwd_block<NS, SQ>(x, s, out, C, T, n, L, W, tile, chunk, bid / chunks,
                       blockIdx.y, xs, ss);
}

template <int NS>
void launch(const float* x, const float* s, float* out, int B, int C, int T,
            int n, int L, bool sq, cudaStream_t stream) {
  const int W = T - L + 1;
  const int tiles = (W + WT - 1) / WT;
  const int chunks = (n + NS - 1) / NS;
  const dim3 grid(tiles * chunks * B, C);
  if (sq)
    l1_fwd_kernel<NS, true><<<grid, THREADS, 0, stream>>>(
        x, s, out, C, T, n, L, W, tiles, chunks);
  else
    l1_fwd_kernel<NS, false><<<grid, THREADS, 0, stream>>>(
        x, s, out, C, T, n, L, W, tiles, chunks);
}

}  // namespace

// x (B, C, T), s (n, C, L), out (B, n, C, T - L + 1): contiguous float32 on
// the device. The caller checks shapes and grid limits (C <= 65535).
extern "C" int shapelet_l1_fwd(const void* x, const void* s, void* out,
                               int B, int C, int T, int n, int L, int squared,
                               void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool sq = squared != 0;
  switch (n < 1 ? 0 : fwd_rows(n)) {   // balanced chunks of <= 16 rows
#define K1_CASE(N) \
    case N: launch<N>(xp, sp, op, B, C, T, n, L, sq, st); break;
    K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5) K1_CASE(6)
    K1_CASE(7) K1_CASE(8) K1_CASE(9) K1_CASE(10) K1_CASE(11) K1_CASE(12)
    K1_CASE(13) K1_CASE(14) K1_CASE(15) K1_CASE(16)
#undef K1_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
