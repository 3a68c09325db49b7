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
// tap one FMA; G is summed once per window, from the staged g. The compare
// (FSET) runs on the ALU pipe, half as wide as the FMA pipe, so an L1 tap
// also takes two of its cycles a warp.
//
// Design: the TPU kernel kept the whole (n, L, C) gradient resident in VMEM
// and let its sequential grid add into it. CUDA blocks run in no order, so
// here each block owns (channel c, a tile of taps, a chunk of at most 5
// shapelet rows, a chunk of batch rows) and writes its partial sums to a
// workspace (one slice per batch chunk); a second launch adds the slices in
// a fixed order and applies 1/L (2/L). No float atomics: the result is the
// same bit for bit on every run.
//
// Inside a block: a thread owns TPT = 4 consecutive taps of every shapelet
// row of the chunk and keeps their 4 x NS shapelet values and accumulators
// in registers. For 4 windows it reads the 7 x values they touch as two
// float4 loads and each row's 4 g values as one float4: one shared load
// for every 23 FP32 and ALU instructions at NS = 5. Five rows a block (not
// 10) keep a thread at 64 registers, so that two blocks of up to 512
// threads fit an SM; 8 taps a thread was faster at some banks and slower
// at others (PERF.md, section 6). A short L has few tap groups, so the
// block has tg x wsh threads: thread (group, share) takes the window quads
// share, share + wsh, ... of each pass, and the shares' sums are added in
// order at the end. `bwd_tiling` (shapelet_common.cuh) picks the tap tiles
// and wsh of each L at launch for the fewest issued taps: at the
// flagship's six banks <= 3.8 % beyond the work. One block covers all of
// L's taps for every flagship bank, so it reads each g value once. g and
// x are staged by cp.async, a batch row's windows (up to 1024) a pass, two
// passes deep; thread i adds quads i, i + threads, ... of each row's
// staged g to its share of G, and the shares are summed in a fixed order
// (warp sums, then the warps' in order). The block's body is
// `l1_bwd_block` in shapelet_common.cuh, which K4 runs too.

#include "shapelet_common.cuh"

namespace {

using namespace shapelet;

template <int NS, bool SQ>
__global__ void __launch_bounds__(BWD_THREADS_MAX, 2)
l1_bwd_partial(const float* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ g, float* __restrict__ ws, int B,
               int C, int T, int n, int L, int W, BwdTiling tl, int chunks,
               int bchunk) {
  extern __shared__ __align__(16) float smem[];
  int bid = blockIdx.x;
  const int tile = bid % tl.tiles;
  bid /= tl.tiles;
  const int chunk = bid % chunks;
  l1_bwd_block<NS, SQ>(x, s, g, ws, B, C, T, n, L, W, tl, tile, chunk,
                       bid / chunks, bchunk, blockIdx.y, smem);
}

__global__ void l1_bwd_reduce(const float* __restrict__ ws,
                              float* __restrict__ out, int count, int parts,
                              float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) l1_bwd_reduce_one(ws, out, i, count, parts, scale);
}

template <int NS>
void launch_partial(const float* x, const float* s, const float* g, float* ws,
                    int B, int C, int T, int n, int L, int bchunk, bool sq,
                    cudaStream_t stream) {
  const int W = T - L + 1;
  const BwdTiling tl = bwd_tiling(L, W);
  const int chunks = (n + NS - 1) / NS;
  const int parts = (B + bchunk - 1) / bchunk;
  const dim3 grid(tl.tiles * chunks * parts, C);
  const int bytes = 4 * bwd_smem_floats(tl, NS);
  auto kernel = sq ? l1_bwd_partial<NS, true> : l1_bwd_partial<NS, false>;
  allow_smem(kernel, bytes);
  kernel<<<grid, tl.block, bytes, stream>>>(x, s, g, ws, B, C, T, n, L, W,
                                            tl, chunks, bchunk);
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
  switch (n < 1 ? 0 : bwd_rows(n)) {   // balanced chunks of <= 5 rows
#define K2_CASE(N) \
    case N: launch_partial<N>(xp, sp, gp, wp, B, C, T, n, L, batch_chunk, sq, st); break;
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4) K2_CASE(5)
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
