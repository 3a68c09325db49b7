// Per-block bodies shared by the shapelet-distance kernels: K1
// (shapelet_l1_fwd.cu) and K3 (shapelet_l1_grouped_fwd.cu) run
// `l1_fwd_block`; K2 (shapelet_l1_bwd.cu) and K4 (shapelet_l1_grouped_bwd.cu)
// run `l1_bwd_block` and `l1_bwd_reduce_one`. A grouped kernel only decides
// which bank a block belongs to, and takes each bank's tiling from the same
// host functions (`fwd_tiling`, `bwd_tiling`) as the per-bank launch; the
// arithmetic of the block is this code, so a grouped launch gives the
// per-bank launches' results bit for bit. The sources of K1 and K2 say what
// bounds these bodies and why they are laid out as they are.

#pragma once

#include <cuda_runtime.h>

namespace shapelet {

// ------------------------------------------------------------ cp.async
// 4-byte copies from device to shared memory that run under the compute of
// the previous pass; `valid` false writes 0 and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// dst[i] = src[i] for i < valid and 0 for valid <= i < count, by cp.async;
// the block's threads [0, threads) share the elements
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int valid, int count, int tid,
                                          int threads) {
  for (int i = tid; i < count; i += threads) {
    const bool in = i < valid;
    cp_async4(dst + i, src + (in ? i : 0), in);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most one group (the pass being loaded) is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <bool SQ>
__device__ __forceinline__ float tap(float acc, float d) {
  return SQ ? fmaf(d, d, acc) : acc + fabsf(d);
}

// ------------------------------------------------------------ forward (K1)
constexpr int FWD_THREADS = 128;     // threads per block
constexpr int NS_MAX = 16;           // shapelet rows per block at most
constexpr int WPT = 8;               // consecutive windows per thread
constexpr int LC = 128;              // taps staged per pass
constexpr int WT_MAX = 2048;         // windows of one row segment at most
static_assert(LC <= FWD_THREADS, "a pass stages one tap of s a thread");

// How K1 (and K3, per bank) cuts the work of one (shapelet chunk, channel):
// a row's W windows are split into `tiles` segments of at most `wt`
// windows; a segment is `tpr` items of WPT consecutive windows (the last
// item's windows past the segment are computed and never stored). Items
// are numbered row by row over the B * tiles segments, and block i takes
// items [i * FWD_THREADS, i * FWD_THREADS + FWD_THREADS), one a thread, so
// a block spans at most `rows` segments; their x is staged `xs` floats a
// segment. Padded taps are only the windows past each segment's end.
struct FwdTiling {
  int tiles, wt, tpr, rows, xs, blocks;
};

inline FwdTiling fwd_tiling(int B, int W) {
  FwdTiling t;
  t.tiles = (W + WT_MAX - 1) / WT_MAX;
  t.wt = (W + t.tiles - 1) / t.tiles;
  t.tpr = (t.wt + WPT - 1) / WPT;
  const int segs = B * t.tiles;
  const int span = (FWD_THREADS - 1 + t.tpr - 1) / t.tpr + 1;
  t.rows = span < segs ? span : segs;
  t.xs = (t.tpr * WPT + LC + 3) & ~3;
  t.blocks = (int)(((long long)segs * t.tpr + FWD_THREADS - 1) / FWD_THREADS);
  return t;
}

// Floats of dynamic shared memory a block of NS rows needs: two staging
// buffers (x segments and s), or the output tile, whichever is larger
inline int fwd_smem_floats(const FwdTiling& t, int ns) {
  const int stages = 2 * (t.rows * t.xs + ns * LC);
  const int outs = ns * FWD_THREADS * WPT;
  return stages > outs ? stages : outs;
}

// Block `blk` of shapelet chunk `chunk` and channel c: windows of items
// [blk * FWD_THREADS, ...) against shapelet rows [chunk * NS, chunk * NS +
// NS) of s (n, C, L); writes out[b, j, c, w] (out (B, n, C, W)). smem holds
// fwd_smem_floats(t, NS) floats, 16-byte aligned.
template <int NS, bool SQ>
__device__ __forceinline__ void l1_fwd_block(
    const float* __restrict__ x, const float* __restrict__ s,
    float* __restrict__ out, int B, int C, int T, int n, int L, int W,
    const FwdTiling& t, int blk, int chunk, int c, float* smem) {
  const int tid = threadIdx.x;
  const int n0 = chunk * NS;
  const int items = B * t.tiles * t.tpr;
  const int q0 = blk * FWD_THREADS;
  const int q1 = min(items, q0 + FWD_THREADS);   // one past the last item
  const int r0 = q0 / t.tpr;                     // first segment
  const int nr = (q1 - 1) / t.tpr + 1 - r0;      // segments spanned
  const int q = q0 + tid;
  const bool active = q < q1;
  const int rr = q / t.tpr - r0;                 // this item's segment
  const int w0 = (q % t.tpr) * WPT;              // its first window in it
  const int seg = t.tpr * WPT;
  const int stage = t.rows * t.xs + NS * LC;

  // pass l0 -> buf: x[b, c, tile * wt + l0 + i] of each spanned segment,
  // i < seg + lc (0 past T), and s[n0 + j, c, l0 + l] for l < lc
  auto load = [&](int l0, float* buf) {
    const int lc = min(LC, L - l0);
    for (int r = 0; r < nr; ++r) {
      const int sg = r0 + r;
      const float* xrow = x + ((size_t)(sg / t.tiles) * C + c) * T;
      const int t0 = (sg % t.tiles) * t.wt + l0;
      float* xs = buf + r * t.xs;
      for (int i = tid; i < seg + lc; i += FWD_THREADS) {
        const bool in = t0 + i < T;
        cp_async4(xs + i, xrow + (in ? t0 + i : 0), in);
      }
    }
    if (tid < lc) {   // LC <= FWD_THREADS: one tap of each row a thread
      float* ss = buf + t.rows * t.xs;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bool row = n0 + j < n;
        cp_async4(ss + j * LC + tid,
                  s + ((size_t)(row ? n0 + j : 0) * C + c) * L + l0 + tid,
                  row);
      }
    }
  };

  float acc[NS][WPT];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int k = 0; k < WPT; ++k) acc[j][k] = 0.f;

  const int passes = (L + LC - 1) / LC;
  load(0, smem);
  cp_async_commit();
  for (int p = 0; p < passes; ++p) {
    float* cur = smem + (p & 1) * stage;
    if (p + 1 < passes) load((p + 1) * LC, smem + ((p + 1) & 1) * stage);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // pass p is in shared memory for every thread
    if (active) {
      const int lc = min(LC, L - p * LC);
      const float* xs = cur + rr * t.xs + w0;
      const float* ss = cur + t.rows * t.xs;
      const int l4 = lc & ~3;
      for (int l = 0; l < l4; l += 4) {
        // the x values of WPT windows at 4 taps: one register window
        // that serves every shapelet row
        float xr[WPT + 4];
#pragma unroll
        for (int m = 0; m < (WPT + 4) / 4; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(xs + l + 4 * m);
          xr[4 * m] = v.x;
          xr[4 * m + 1] = v.y;
          xr[4 * m + 2] = v.z;
          xr[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 sv = *reinterpret_cast<const float4*>(ss + j * LC + l);
          const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int k = 0; k < WPT; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][k] = tap<SQ>(acc[j][k], xr[k + e] - s4[e]);
        }
      }
      for (int l = l4; l < lc; ++l) {   // the last (lc % 4) taps
        float xr[WPT];
#pragma unroll
        for (int k = 0; k < WPT; ++k) xr[k] = xs[l + k];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float sv = ss[j * LC + l];
#pragma unroll
          for (int k = 0; k < WPT; ++k)
            acc[j][k] = tap<SQ>(acc[j][k], xr[k] - sv);
        }
      }
    }
    __syncthreads();   // every thread is done with `cur`
  }

  // the block's outputs through shared memory, so that the stores run
  // along W: ob[j][(item - q0) * WPT + k]
  const float inv = 1.f / (float)L;
  constexpr int OW = FWD_THREADS * WPT;
  if (active) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int k = 0; k < WPT; k += 4)
        *reinterpret_cast<float4*>(smem + j * OW + tid * WPT + k) =
            make_float4(acc[j][k] * inv, acc[j][k + 1] * inv,
                        acc[j][k + 2] * inv, acc[j][k + 3] * inv);
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    const int sg = r0 + r;
    const int b = sg / t.tiles, tile = sg % t.tiles;
    const int qa = max(q0, sg * t.tpr);
    const int qb = min(q1, (sg + 1) * t.tpr);
    const int wa = (qa - sg * t.tpr) * WPT;   // first window in the segment
    const int nw = min((qb - qa) * WPT, min(t.wt, W - tile * t.wt) - wa);
    const float* src = smem + (qa - q0) * WPT;
    for (int j = 0; j < NS; ++j) {
      if (n0 + j >= n) break;
      float* orow = out + (((size_t)b * n + n0 + j) * C + c) * W +
                    tile * t.wt + wa;
      for (int i = tid; i < nw; i += FWD_THREADS) orow[i] = src[j * OW + i];
    }
  }
}

// ----------------------------------------------------------- backward (K2)
constexpr int TPT = 4;               // consecutive taps per thread
constexpr int NSB_MAX = 5;           // shapelet rows per block at most
constexpr int BWD_THREADS_MAX = 512; // threads per block at most
constexpr int QMAX = 256;            // window quads (4 windows) a pass
constexpr int BWD_TILES_MAX = 4;     // tap tiles L may be split into

// How K2 (and K4, per bank) cuts the work of one (shapelet chunk, channel,
// batch chunk): L's taps are `groups` = ceil(L / TPT) groups of TPT
// consecutive taps, split into `tiles` tiles of `tg` groups (a block
// each); a block has tg * wsh working threads, thread (g, ws) = (tid % tg,
// tid / tg) owning the taps of group g of its tile and the window quads
// ws, ws + wsh, ... of each pass. A row's ceil(W / 4) quads are `wpass`
// passes of at most `qp` quads. `bwd_tiling` picks tiles and wsh for the
// fewest issued taps: a warp runs as many quads as its busiest thread, and
// tap groups past L and windows past W are issued too.
struct BwdTiling {
  int tiles, tg, wsh, threads, block, wpass, qp, xs;
};

// tap slots (4 taps x 4 windows a thread a quad, idle lanes included) that
// one tile issues for one batch row
inline long long bwd_issued(int tg, int wsh, int w4, int wpass, int qp) {
  const int threads = tg * wsh;
  long long quads = 0;
  for (int p = 0; p < wpass; ++p) {
    const int qc = p + 1 < wpass ? qp : w4 - qp * (wpass - 1);
    for (int w = 0; w * 32 < threads; ++w) {
      const int ws = w * 32 / tg;   // a warp's first share is its busiest
      quads += qc > ws ? (qc - ws + wsh - 1) / wsh : 0;
    }
  }
  return quads * 32 * TPT * 4;
}

inline BwdTiling bwd_tiling(int L, int W) {
  const int groups = (L + TPT - 1) / TPT;
  const int w4 = (W + 3) / 4;
  BwdTiling best{};
  best.wpass = (w4 + QMAX - 1) / QMAX;
  best.qp = (w4 + best.wpass - 1) / best.wpass;
  long long best_cost = -1;
  for (int tiles = 1; tiles <= BWD_TILES_MAX && tiles <= groups; ++tiles) {
    const int tg = (groups + tiles - 1) / tiles;
    for (int wsh = 1; tg * wsh <= BWD_THREADS_MAX; ++wsh) {
      const long long cost =
          tiles * bwd_issued(tg, wsh, w4, best.wpass, best.qp);
      // ties: fewer tiles (each reads all of g), then the block nearest
      // 256 threads (more warps for its shared memory, below the register
      // limit of the largest blocks)
      const int d = tg * wsh > 256 ? tg * wsh - 256 : 256 - tg * wsh;
      const int db = best.threads > 256 ? best.threads - 256
                                        : 256 - best.threads;
      if (best_cost < 0 || cost < best_cost ||
          (cost == best_cost && tiles == best.tiles && d < db)) {
        best_cost = cost;
        best.tiles = tiles;
        best.tg = tg;
        best.wsh = wsh;
        best.threads = tg * wsh;
      }
    }
  }
  best.block = (best.threads + 31) & ~31;
  best.xs = 4 * best.qp + TPT * best.tg + 4;
  return best;
}

// Floats of dynamic shared memory a block of NS rows needs: the per-warp
// shares of G, then two staging buffers (g and x) or the partial sums of
// every window share, whichever is larger
__host__ __device__ inline int bwd_gw_floats(int ns) { return ns * (BWD_THREADS_MAX / 32); }
__host__ __device__ inline int bwd_stage_floats(const BwdTiling& t, int ns) {
  return ns * 4 * t.qp + t.xs;
}
inline int bwd_smem_floats(const BwdTiling& t, int ns) {
  const int stages = 2 * bwd_stage_floats(t, ns);
  const int red = t.wsh * ns * TPT * t.tg;
  return bwd_gw_floats(ns) + (stages > red ? stages : red);
}

// Partial sums over batch rows [bc * bchunk, bc * bchunk + bchunk) of the
// gradient of shapelet rows [chunk * NS, chunk * NS + NS), channel c, the
// taps of tile `tile`: writes ws[bc, j, c, l] (ws (parts, n, C, L)) as
// 2 acc - G (L1) or s G - acc (sq), before the 1/L (2/L) scale. smem holds
// bwd_smem_floats(t, NS) floats, 16-byte aligned; blockDim.x >= t.block,
// and threads past t.threads only take part in the barriers.
template <int NS, bool SQ>
__device__ __forceinline__ void l1_bwd_block(
    const float* __restrict__ x, const float* __restrict__ s,
    const float* __restrict__ g, float* __restrict__ ws, int B, int C, int T,
    int n, int L, int W, const BwdTiling& t, int tile, int chunk, int bc,
    int bchunk, int c, float* smem) {
  const int tid = threadIdx.x;
  const bool active = tid < t.threads;
  const int n0 = chunk * NS;
  const int tt = TPT * t.tg;                  // taps of a tile
  const int l0 = tile * tt;                   // the tile's first tap
  const int grp = tid % t.tg, share = tid / t.tg;
  const int b0 = bc * bchunk;
  const int rows = min(B, b0 + bchunk) - b0;
  const int w4 = (W + 3) / 4;
  const int stage = bwd_stage_floats(t, NS);
  float* gw = smem;                           // per-warp shares of G
  float* area = smem + bwd_gw_floats(NS);

  // pass p -> buf: g[b, n0 + j, c, 4 qa + i] for i < 4 qc (0 past W) at
  // buf[j * 4 qp + i], then x[b, c, 4 qa + l0 + i] for i < 4 qc + tt + 3
  auto load = [&](int p, float* buf) {
    const int b = b0 + p / t.wpass, qa = (p % t.wpass) * t.qp;
    const int qc = min(t.qp, w4 - qa);
    if (tid >= t.threads) return;
    // rows past n are never stored: their g is not staged
    for (int j = 0; j < NS && n0 + j < n; ++j)
      stage_row(buf + j * 4 * t.qp,
                g + (((size_t)b * n + n0 + j) * C + c) * W + 4 * qa,
                W - 4 * qa, 4 * qc, tid, t.threads);
    const int t0 = 4 * qa + l0;
    stage_row(buf + NS * 4 * t.qp, x + ((size_t)b * C + c) * T + t0, T - t0,
              4 * qc + tt + 3, tid, t.threads);
  };

  // sv: this thread's shapelet values; acc: sum g * [s > x] (L1) or
  // sum g * x (sq) over its windows; gsum: its share of G = sum g
  float sv[NS][TPT], acc[NS][TPT], gsum[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    gsum[j] = 0.f;
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int l = l0 + TPT * grp + k;
      sv[j][k] = (active && n0 + j < n && l < L)
                     ? s[((size_t)(n0 + j) * C + c) * L + l] : 0.f;
      acc[j][k] = 0.f;
    }
  }

  const int passes = rows * t.wpass;
  if (passes > 0) load(0, area);
  cp_async_commit();
  for (int p = 0; p < passes; ++p) {
    float* cur = area + (p & 1) * stage;
    if (p + 1 < passes) load(p + 1, area + ((p + 1) & 1) * stage);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // pass p is in shared memory for every thread
    if (active) {
      const int qc = min(t.qp, w4 - (p % t.wpass) * t.qp);
      const float* xs = cur + NS * 4 * t.qp + TPT * grp;
      // windows past W carry g = 0 and add nothing
      for (int q = share; q < qc; q += t.wsh) {
        float xr[TPT + 4];   // x at windows 4q + e, taps k: xr[e + k]
#pragma unroll
        for (int m = 0; m < (TPT + 4) / 4; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(xs + 4 * q + 4 * m);
          xr[4 * m] = v.x;
          xr[4 * m + 1] = v.y;
          xr[4 * m + 2] = v.z;
          xr[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 gv =
              *reinterpret_cast<const float4*>(cur + j * 4 * t.qp + 4 * q);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int k = 0; k < TPT; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][k] = fmaf(g4[e],
                               SQ ? xr[e + k]
                                  : (sv[j][k] > xr[e + k] ? 1.f : 0.f),
                               acc[j][k]);
        }
      }
      // this thread's share of G: quads tid, tid + threads, ... of g
#pragma unroll
      for (int j = 0; j < NS; ++j)
        for (int q = tid; q < qc; q += t.threads) {
          const float4 gv =
              *reinterpret_cast<const float4*>(cur + j * 4 * t.qp + 4 * q);
          gsum[j] += (gv.x + gv.y) + (gv.z + gv.w);
        }
    }
    __syncthreads();   // every thread is done with `cur`
  }

  // G of each row: warp sums, then the warps' sums in order; acc of every
  // window share, then the shares' sums in order
  const int nwarp = (int)blockDim.x / 32;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float v = gsum[j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tid % 32 == 0) gw[j * (BWD_THREADS_MAX / 32) + tid / 32] = v;
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int k = 0; k < TPT; k += 4)
        *reinterpret_cast<float4*>(area + (share * NS + j) * tt + TPT * grp +
                                   k) =
            make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2],
                        acc[j][k + 3]);
  }
  __syncthreads();
  for (int e = tid; e < NS * tt; e += (int)blockDim.x) {
    const int j = e / tt, i = e % tt, l = l0 + i;
    if (n0 + j >= n || l >= L) continue;
    float G = 0.f;
    for (int w = 0; w < nwarp; ++w) G += gw[j * (BWD_THREADS_MAX / 32) + w];
    float v = 0.f;
    for (int r = 0; r < t.wsh; ++r) v += area[(r * NS + j) * tt + i];
    const size_t o = ((size_t)(n0 + j) * C + c) * L + l;
    ws[(size_t)bc * n * C * L + o] = SQ ? s[o] * G - v : 2.f * v - G;
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

// Shapelet rows per block of K2: balanced chunks of at most NSB_MAX
inline int bwd_rows(int n) {
  const int chunks = (n + NSB_MAX - 1) / NSB_MAX;
  return (n + chunks - 1) / chunks;
}

// Opens a kernel to more than 48 KB of dynamic shared memory
template <typename K>
inline void allow_smem(K kernel, int bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
}

}  // namespace shapelet
