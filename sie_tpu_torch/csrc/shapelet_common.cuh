// Per-block bodies shared by the shapelet-distance kernels: K1
// (shapelet_l1_fwd.cu) and K3 (shapelet_l1_grouped_fwd.cu) run
// `l1_fwd_block`; K2 (shapelet_l1_bwd.cu) and K4 (shapelet_l1_grouped_bwd.cu)
// run `l1_bwd_block` and `l1_bwd_reduce_one`. A grouped kernel only decides
// which bank a block belongs to; the arithmetic of the block is this code,
// so a grouped launch gives the per-bank launches' results bit for bit.
// The sources of K1 and K2 say what bounds these bodies and why they are
// laid out as they are.

#pragma once

#include <cuda_runtime.h>

namespace shapelet {

constexpr int THREADS = 64;          // threads per block of every kernel
constexpr int NS_MAX = 16;           // shapelet rows per block at most

// ------------------------------------------------------------ forward (K1)
constexpr int WPT = 4;               // windows per thread
constexpr int WT = THREADS * WPT;    // windows per block
constexpr int LC = 256;              // taps staged per pass

template <bool SQ>
__device__ __forceinline__ float tap(float acc, float d) {
  return SQ ? fmaf(d, d, acc) : acc + fabsf(d);
}

// Windows [tile * WT, tile * WT + WT) of batch row b and channel c against
// shapelet rows [chunk * NS, chunk * NS + NS) of s (n, C, L); writes
// out[b, j, c, w] (out (B, n, C, W)). xs holds WT + LC floats and ss
// NS * LC floats (16-byte aligned), both in shared memory.
template <int NS, bool SQ>
__device__ __forceinline__ void l1_fwd_block(
    const float* __restrict__ x, const float* __restrict__ s,
    float* __restrict__ out, int C, int T, int n, int L, int W, int tile,
    int chunk, int b, int c, float* xs, float* ss) {
  const int n0 = chunk * NS;
  const int w0 = tile * WT;
  const int tid = threadIdx.x;
  const float* xrow = x + ((size_t)b * C + c) * T;

  float acc[NS][WPT];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int k = 0; k < WPT; ++k) acc[j][k] = 0.f;

  for (int l0 = 0; l0 < L; l0 += LC) {
    const int lc = min(LC, L - l0);
    __syncthreads();   // the previous pass is done with xs and ss
    for (int i = tid; i < WT + lc - 1; i += THREADS) {
      const int t = w0 + l0 + i;
      xs[i] = t < T ? xrow[t] : 0.f;
    }
    for (int i = tid; i < NS * LC; i += THREADS) {
      const int j = i / LC, l = i % LC;
      ss[i] = (n0 + j < n && l < lc)
                  ? s[((size_t)(n0 + j) * C + c) * L + l0 + l] : 0.f;
    }
    __syncthreads();

    const int l4 = lc & ~3;
    for (int l = 0; l < l4; l += 4) {
      float xv[WPT][4];
#pragma unroll
      for (int k = 0; k < WPT; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[k][q] = xs[tid + k * THREADS + l + q];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 sv = *reinterpret_cast<const float4*>(&ss[j * LC + l]);
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int k = 0; k < WPT; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][k] = tap<SQ>(acc[j][k], xv[k][q] - s4[q]);
      }
    }
    for (int l = l4; l < lc; ++l) {   // the last (lc % 4) taps
      float xv[WPT];
#pragma unroll
      for (int k = 0; k < WPT; ++k) xv[k] = xs[tid + k * THREADS + l];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float sv = ss[j * LC + l];
#pragma unroll
        for (int k = 0; k < WPT; ++k) acc[j][k] = tap<SQ>(acc[j][k], xv[k] - sv);
      }
    }
  }

  const float inv = 1.f / (float)L;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (n0 + j >= n) break;
    float* orow = out + (((size_t)b * n + n0 + j) * C + c) * W;
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      const int w = w0 + tid + k * THREADS;
      if (w < W) orow[w] = acc[j][k] * inv;
    }
  }
}

// ----------------------------------------------------------- backward (K2)
constexpr int WC = 256;              // windows staged per pass
constexpr int LPT_MAX = 4;           // taps per thread at most

// Floats of shared memory that l1_bwd_block's xs needs at LPT taps a thread
__host__ __device__ constexpr int bwd_xs_floats(int lpt) {
  return WC + THREADS * lpt + 4;
}

// Partial sums over batch rows [bc * bchunk, bc * bchunk + bchunk) of the
// gradient of shapelet rows [chunk * NS, chunk * NS + NS), channel c, taps
// [tile * THREADS * LPT, ...): writes ws[bc, j, c, l] (ws (parts, n, C, L))
// as 2 acc - G (L1) or s G - acc (sq), before the 1/L (2/L) scale. gs holds
// NS * WC floats (16-byte aligned), xs bwd_xs_floats(LPT) and gw
// NS * THREADS / 32, all in shared memory.
template <int NS, int LPT, bool SQ>
__device__ __forceinline__ void l1_bwd_block(
    const float* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ g, float* __restrict__ ws, int B, int C, int T,
    int n, int L, int W, int tile, int chunk, int bc, int bchunk, int c,
    float* gs, float* xs, float* gw) {
  constexpr int NWARP = THREADS / 32;
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

  // G of each row: warp sums, then the warps' sums in order
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float v = gsum[j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tid % 32 == 0) gw[j * NWARP + tid / 32] = v;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (n0 + j >= n) break;
    float G = 0.f;
#pragma unroll
    for (int i = 0; i < NWARP; ++i) G += gw[j * NWARP + i];
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
__device__ __forceinline__ void l1_bwd_reduce_one(const float* __restrict__ ws,
                                                  float* __restrict__ out,
                                                  int i, int count, int parts,
                                                  float scale) {
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += ws[(size_t)p * count + i];
  out[i] = acc * scale;
}

// ------------------------------------------------------ host-side tiling
// Shapelet rows per block of K1 for a bank of n >= 1 rows: balanced chunks
// of at most NS_MAX
inline int fwd_rows(int n) {
  const int chunks = (n + NS_MAX - 1) / NS_MAX;
  return (n + chunks - 1) / chunks;
}

// Shapelet rows per block of K2: K1's, rounded up to an even count
inline int bwd_rows(int n) { return (fwd_rows(n) + 1) & ~1; }

// Taps per thread of K2 for a bank of length L >= 1: enough for L up to
// 256 in one tile, else LPT_MAX a tile
inline int bwd_lpt(int L) {
  const int lpt = (L + THREADS - 1) / THREADS;
  return lpt < LPT_MAX ? lpt : LPT_MAX;
}

}  // namespace shapelet
