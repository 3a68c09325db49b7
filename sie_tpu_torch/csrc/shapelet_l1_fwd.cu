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
// Design: the work of one (shapelet chunk, channel) is items of WPT = 8
// consecutive windows of one batch row, numbered row by row, and a block
// of 128 threads takes 128 consecutive items, one a thread, whatever rows
// they fall in: the padded taps are only the < 8 windows past each row's
// end (<= 3.5 % at the flagship's six banks). The block stages 128 taps of
// x for every row it spans, and of s[chunk, c, :], in shared memory by
// cp.async, two passes deep, so that the next pass loads while this one
// is computed. For four taps a thread reads the 11 x values of its
// windows as three float4 loads, one register window that serves every
// shapelet row, and each row's four s values as one broadcast float4:
// about one shared load for every 50 FP32 instructions. A thread keeps
// NS x 8 accumulators in registers; each sums its taps in order, as the
// JAX scan does. The outputs go through shared memory and are stored
// along W, coalesced. Shapelet banks of more than 16 rows are split into
// equal chunks (the grid's chunk index); the rows of a last, shorter
// chunk are zero-filled and never stored. The block's body is
// `l1_fwd_block` in shapelet_common.cuh, which K3 runs too. At the
// flagship (NS = 10) it takes 128 registers and 4 blocks an SM; 256-thread
// blocks, 64-tap passes and 5 blocks an SM (96 registers) were each
// slower on the card (PERF.md, section 6).

#include "shapelet_common.cuh"

namespace {

using namespace shapelet;

template <int NS, bool SQ>
__global__ void __launch_bounds__(FWD_THREADS)
l1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ s,
              float* __restrict__ out, int B, int C, int T, int n, int L,
              int W, FwdTiling tl) {
  extern __shared__ __align__(16) float smem[];
  l1_fwd_block<NS, SQ>(x, s, out, B, C, T, n, L, W, tl,
                       blockIdx.x % tl.blocks, blockIdx.x / tl.blocks,
                       blockIdx.y, smem);
}

template <int NS>
void launch(const float* x, const float* s, float* out, int B, int C, int T,
            int n, int L, bool sq, cudaStream_t stream) {
  const int W = T - L + 1;
  const FwdTiling tl = fwd_tiling(B, W);
  const int chunks = (n + NS - 1) / NS;
  const dim3 grid(tl.blocks * chunks, C);
  const int bytes = 4 * fwd_smem_floats(tl, NS);
  auto kernel = sq ? l1_fwd_kernel<NS, true> : l1_fwd_kernel<NS, false>;
  allow_smem(kernel, bytes);
  kernel<<<grid, FWD_THREADS, bytes, stream>>>(x, s, out, B, C, T, n, L, W,
                                               tl);
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
