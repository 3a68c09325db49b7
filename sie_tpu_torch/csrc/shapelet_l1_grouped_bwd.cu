// K4: backward of K3 with respect to every bank, in one call:
//
//   grad_g[j, c, l] = (1/L_g) sum_{b,w} g_g[b, j, c, w] *
//                     (s_g[j, c, l] > x[b, c, w + l] ? +1 : -1)
//
// for banks s_g (n_g, C, L_g) and output gradients g_g (B, n_g, C, W_g),
// each gradient written to its own (n_g, C, L_g) tensor. An exact tie adds
// -g, as K2 and the Pallas select do.
//
// Replaces the Pallas kernel `_bwd_kernel_grouped` of
// sie_tpu/ops/pallas/shapelet_pallas.py (launched by `_grouped_bwd_rule`).
//
// What bounds it on an H100: arithmetic, as for K2 (shapelet_l1_bwd.cu):
// a compare-to-float and an FMA a tap, 5.1e10 taps at the flagship's six
// banks (B=64, C=122, n=10) against ~1.1 GB of g read once.
//
// Design: K2's, over a table of banks, the way K3 extends K1. The partial
// launch's blocks each find their bank from blockIdx.x and run
// `l1_bwd_block` (shapelet_common.cuh), the body of K2, with that bank's
// tiling (`bwd_tiling`, K2's for that bank) and batch chunk, writing
// partial sums into the bank's slice of one workspace; one reduce launch
// then adds every bank's slices in a fixed order and applies 1/L_g. No
// float atomics: the gradients are K2's bit for bit, and the same on every
// run. The caller passes each bank's batch chunk (K2's choice for that
// bank alone) so that the partial sums, and hence the roundings, are K2's.
// The table lists the banks by descending work per block, so the longest
// blocks start first. All banks share one shapelet-row chunk NS, the
// largest of K2's per-bank choices, and the launch's block size and
// dynamic shared memory are the largest bank's; a bank's threads past its
// own tg x wsh only take part in the barriers (in K2 too, up to the next
// multiple of 32), so every bank's sums are formed as in K2.

#include "shapelet_common.cuh"

namespace {

using namespace shapelet;

constexpr int MAX_BANKS = 8;

struct Bank {
  const float* s;
  const float* g;
  float* ws;
  int n, L, W, chunks, bchunk, start;   // start: first block
  BwdTiling tl;
};

struct Table {
  Bank bank[MAX_BANKS];
  int count;
};

struct ReduceBank {
  const float* ws;
  float* out;
  int count, parts, start;   // start: first element in the launch's range
  float scale;
};

struct ReduceTable {
  ReduceBank bank[MAX_BANKS];
  int count, total;
};

template <int NS>
__global__ void __launch_bounds__(BWD_THREADS_MAX, 2)
l1_bwd_grouped_partial(const float* __restrict__ x, const Table tab, int B,
                       int C, int T) {
  extern __shared__ __align__(16) float smem[];
  Bank bk = tab.bank[0];
#pragma unroll
  for (int i = 1; i < MAX_BANKS; ++i)
    if (i < tab.count && (int)blockIdx.x >= tab.bank[i].start) bk = tab.bank[i];
  int bid = blockIdx.x - bk.start;
  const int tile = bid % bk.tl.tiles;
  bid /= bk.tl.tiles;
  const int chunk = bid % bk.chunks;
  l1_bwd_block<NS, false>(x, bk.s, bk.g, bk.ws, B, C, T, bk.n, bk.L, bk.W,
                          bk.tl, tile, chunk, bid / bk.chunks, bk.bchunk,
                          blockIdx.y, smem);
}

__global__ void l1_bwd_grouped_reduce(const ReduceTable tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= tab.total) return;
  ReduceBank bk = tab.bank[0];
#pragma unroll
  for (int r = 1; r < MAX_BANKS; ++r)
    if (r < tab.count && i >= tab.bank[r].start) bk = tab.bank[r];
  l1_bwd_reduce_one(bk.ws, bk.out, i - bk.start, bk.count, bk.parts,
                    bk.scale);
}

template <int NS>
int launch(const float* x, const Table& tab, int total, int B, int C, int T,
           cudaStream_t stream) {
  int bytes = 0, block = 32;
  for (int i = 0; i < tab.count; ++i) {
    const int b = 4 * bwd_smem_floats(tab.bank[i].tl, NS);
    bytes = b > bytes ? b : bytes;
    block = tab.bank[i].tl.block > block ? tab.bank[i].tl.block : block;
  }
  allow_smem(l1_bwd_grouped_partial<NS>, bytes);
  l1_bwd_grouped_partial<NS><<<dim3(total, C), block, bytes, stream>>>(
      x, tab, B, C, T);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, C, T) and, for each of the `banks` banks, s[i] (n[i], C, L[i]),
// g[i] (B, n[i], C, T - L[i] + 1) and grad[i] (n[i], C, L[i]): contiguous
// float32 on the device; ws a float32 workspace of sum_i ceil(B /
// bchunk[i]) * n[i] * C * L[i], the banks' slices in the given order; s, g,
// grad, n, L and bchunk are host arrays. The caller checks shapes, 1 <=
// L[i] <= T, n[i] >= 1, B >= 1, 2 <= banks <= 8 and C <= 65535.
extern "C" int shapelet_l1_grouped_bwd(const void* x, int B, int C, int T,
                                       int banks, const void* const* s,
                                       const void* const* g,
                                       void* const* grad, void* ws,
                                       const int* n, const int* L,
                                       const int* bchunk, void* stream) {
  if (banks < 1 || banks > MAX_BANKS || B < 1) return (int)cudaErrorInvalidValue;
  int ns = 1;
  for (int i = 0; i < banks; ++i) {
    if (n[i] < 1 || L[i] < 1 || L[i] > T || bchunk[i] < 1)
      return (int)cudaErrorInvalidValue;
    ns = bwd_rows(n[i]) > ns ? bwd_rows(n[i]) : ns;
  }
  // each bank's slice of the workspace, and the reduce table
  ReduceTable red{};
  red.count = banks;
  Bank bank[MAX_BANKS];
  long long wsoff = 0, elems = 0;
  for (int i = 0; i < banks; ++i) {
    Bank& bk = bank[i];
    bk.s = static_cast<const float*>(s[i]);
    bk.g = static_cast<const float*>(g[i]);
    bk.ws = static_cast<float*>(ws) + wsoff;
    bk.n = n[i];
    bk.L = L[i];
    bk.W = T - L[i] + 1;
    bk.tl = bwd_tiling(L[i], bk.W);
    bk.chunks = (n[i] + ns - 1) / ns;
    bk.bchunk = bchunk[i];
    const int parts = (B + bchunk[i] - 1) / bchunk[i];
    const long long count = (long long)n[i] * C * L[i];
    red.bank[i] = {bk.ws, static_cast<float*>(grad[i]), (int)count, parts,
                   (int)elems, 1.f / (float)L[i]};
    wsoff += parts * count;
    elems += count;
  }
  if (elems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  red.total = (int)elems;
  // the partial launch's table by descending work per block: issued tap
  // slots x batch rows (insertion sort of at most 8 indices)
  auto work = [&](int i) {
    const BwdTiling& t = bank[i].tl;
    return bwd_issued(t.tg, t.wsh, (bank[i].W + 3) / 4, t.wpass, t.qp) *
           bank[i].bchunk;
  };
  int order[MAX_BANKS];
  for (int i = 0; i < banks; ++i) {
    int j = i;
    for (; j > 0 && work(order[j - 1]) < work(i); --j) order[j] = order[j - 1];
    order[j] = i;
  }
  Table tab{};
  tab.count = banks;
  long long total = 0;
  for (int r = 0; r < banks; ++r) {
    tab.bank[r] = bank[order[r]];
    tab.bank[r].start = (int)total;
    const int parts = (B + bank[order[r]].bchunk - 1) / bank[order[r]].bchunk;
    total += (long long)tab.bank[r].tl.tiles * tab.bank[r].chunks * parts;
  }
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (ns) {
#define K4_CASE(N) \
    case N: err = launch<N>(xp, tab, (int)total, B, C, T, st); break;
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4) K4_CASE(5)
#undef K4_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  l1_bwd_grouped_reduce<<<(red.total + 255) / 256, 256, 0, st>>>(red);
  return (int)cudaGetLastError();
}
