// K3: forward of the L1 sliding shapelet distance for several stride-1
// banks in one launch:
//
//   d_g[b, j, c, w] = (1/L_g) * sum_l |x[b, c, w + l] - s_g[j, c, l]|
//
// for banks s_g (n_g, C, L_g), each written to its own (B, n_g, C, W_g)
// tensor, W_g = T - L_g + 1.
//
// Replaces the Pallas kernel `_fwd_kernel_grouped` of
// sie_tpu/ops/pallas/shapelet_pallas.py (launched by `_grouped_fwd`, entry
// `l1_sliding_distance_grouped`), which the SBM takes under
// `fuse_short_banks` for the stride-1 banks.
//
// What bounds it on an H100: arithmetic, as for K1 (shapelet_l1_fwd.cu):
// two FP32 instructions a tap, ~1e11 operations at the flagship's six banks
// (B=64, C=122, n=10) against ~1.1 GB of output.
//
// Design: the TPU kernel packed the banks into one (N, L_max, C) buffer and
// let each group of shapelet rows take only its own taps, so that the
// banks shared the x window loads held in vector registers. On Hopper the
// cost of separate launches is elsewhere: each K1 launch of a long bank is
// a small grid and the card drains between launches. So this kernel keeps
// K1's per-block work unchanged and only merges the grids: a table in the
// kernel arguments holds, per bank, n, L, W, its tiling (`fwd_tiling`, the
// one K1 takes for that bank), chunk count, the first block of its range
// and its s and out pointers; each block finds its bank from blockIdx.x
// and runs `l1_fwd_block` (shapelet_common.cuh), the body of K1. The
// result is K1's on every bank, bit for bit. The table lists the banks by
// descending L, so the blocks with the most taps start first and the short
// banks' blocks fill the tail. All banks share one shapelet-row chunk NS,
// the largest of K1's per-bank choices (rows past a bank's n are
// zero-filled and never stored, as in K1), and one dynamic shared-memory
// size, the largest bank's.

#include "shapelet_common.cuh"

namespace {

using namespace shapelet;

constexpr int MAX_BANKS = 8;

struct Bank {
  const float* s;
  float* out;
  int n, L, W, chunks, start;   // start: first block of the bank
  FwdTiling tl;
};

struct Table {
  Bank bank[MAX_BANKS];
  int count;
};

template <int NS>
__global__ void __launch_bounds__(FWD_THREADS)
l1_fwd_grouped(const float* __restrict__ x, const Table tab, int B, int C,
               int T) {
  extern __shared__ __align__(16) float smem[];
  // the bank of this block: the last one whose range starts at or before it
  // (static indices only, so the table stays in the parameter space)
  Bank bk = tab.bank[0];
#pragma unroll
  for (int i = 1; i < MAX_BANKS; ++i)
    if (i < tab.count && (int)blockIdx.x >= tab.bank[i].start) bk = tab.bank[i];
  const int bid = blockIdx.x - bk.start;
  l1_fwd_block<NS, false>(x, bk.s, bk.out, B, C, T, bk.n, bk.L, bk.W, bk.tl,
                          bid % bk.tl.blocks, bid / bk.tl.blocks, blockIdx.y,
                          smem);
}

template <int NS>
int launch(const float* x, const Table& tab, int total, int B, int C, int T,
           cudaStream_t stream) {
  int bytes = 0;
  for (int i = 0; i < tab.count; ++i) {
    const int b = 4 * fwd_smem_floats(tab.bank[i].tl, NS);
    bytes = b > bytes ? b : bytes;
  }
  allow_smem(l1_fwd_grouped<NS>, bytes);
  l1_fwd_grouped<NS><<<dim3(total, C), FWD_THREADS, bytes, stream>>>(
      x, tab, B, C, T);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, C, T) and, for each of the `banks` banks, s[i] (n[i], C, L[i]) and
// out[i] (B, n[i], C, T - L[i] + 1): contiguous float32 on the device;
// s, out, n and L are host arrays. The caller checks shapes, 1 <= L[i] <=
// T, n[i] >= 1, 2 <= banks <= 8 and C <= 65535.
extern "C" int shapelet_l1_grouped_fwd(const void* x, int B, int C, int T,
                                       int banks, const void* const* s,
                                       void* const* out, const int* n,
                                       const int* L, void* stream) {
  if (banks < 1 || banks > MAX_BANKS) return (int)cudaErrorInvalidValue;
  int ns = 1;
  for (int i = 0; i < banks; ++i) {
    if (n[i] < 1 || L[i] < 1 || L[i] > T) return (int)cudaErrorInvalidValue;
    ns = fwd_rows(n[i]) > ns ? fwd_rows(n[i]) : ns;
  }
  // banks by descending L (insertion sort of at most 8 indices)
  int order[MAX_BANKS];
  for (int i = 0; i < banks; ++i) {
    int j = i;
    for (; j > 0 && L[order[j - 1]] < L[i]; --j) order[j] = order[j - 1];
    order[j] = i;
  }
  Table tab{};
  tab.count = banks;
  long long total = 0;
  for (int r = 0; r < banks; ++r) {
    const int i = order[r];
    Bank& bk = tab.bank[r];
    bk.s = static_cast<const float*>(s[i]);
    bk.out = static_cast<float*>(out[i]);
    bk.n = n[i];
    bk.L = L[i];
    bk.W = T - L[i] + 1;
    bk.tl = fwd_tiling(B, bk.W);
    bk.chunks = (n[i] + ns - 1) / ns;
    bk.start = (int)total;
    total += (long long)bk.tl.blocks * bk.chunks;
  }
  if (total == 0) return 0;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
#define K3_CASE(N) \
    case N: return launch<N>(xp, tab, (int)total, B, C, T, st);
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6)
    K3_CASE(7) K3_CASE(8) K3_CASE(9) K3_CASE(10) K3_CASE(11) K3_CASE(12)
    K3_CASE(13) K3_CASE(14) K3_CASE(15) K3_CASE(16)
#undef K3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
