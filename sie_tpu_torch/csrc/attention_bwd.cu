// K6: backward of full softmax attention with optional dropout: from q, k,
// v, the forward's output o and row log-sum-exp lse (K5), and the output
// gradient dO, all (BH, T, dk) in bf16 or float32 (lse (BH, T) f32), it
// computes dQ, dK and dV in the input dtype.
//
// Replaces the Pallas kernel `_bwd_kernel` of
// sie_tpu/ops/pallas/attention_pallas.py (launched by `_attn_bwd_impl`,
// rule `_bwd_rule`), and at T > 4096 its kv-blocked backward
// (`_attn_bwd_blocked_impl` :308): pass 3 below is `_dq_kv_kernel` (K8a,
// :202), dQ over key blocks from the saved LSE, and pass 2 is
// `_dkv_kv_kernel` (K8b, :236), dK and dV over query blocks; both take
// delta = rowsum(dO * O), as those kernels do. Nothing here is sized by T:
// shared memory holds fixed tiles and every offset is a 64-bit product; the
// caller keeps BH * T within an int.
//
// Per query row, with a = softmax of the scaled, masked scores (bf16
// inputs: raw scores rounded to bf16 before the scale, as in
// `_score_block`) and keep the dropout mask of the forward:
//   ad = keep ? a / (1 - rate) : 0;          dV = ad^T dO  (ad in dO's type)
//   dA = keep ? (dO V^T) / (1 - rate) : 0;
//   dS = a * (dA - delta) * scale, rounded to q's type;
//   dQ = dS K;  dK = dS^T Q  (f32 accumulation, cast to the input type).
// The Pallas kernel takes delta = rowsum(dA * a) over the full key row it
// holds; here delta = rowsum(dO * O) from the forward's output, which is
// equal in exact arithmetic (sum_j dA_j a_j = dO . sum_j ad_j v_j) and
// differs by the rounding of O to bf16. Probabilities are recomputed per
// 64-key tile as exp(score - lse): exact, where the forward's online
// softmax was not.
//
// What bounds it on an H100: the Pallas cost estimate counts 10*BH*T^2*dk
// FLOP (five T x T x dk products); at the flagship (BH=512, T=845, dk=64)
// that is 2.3e11 FLOP, 0.24 ms at the bf16 tensor-core peak, against
// ~0.4 GB of inputs and outputs (0.12 ms at 3.35 TB/s): bound by
// operations. In f32 every product is three TF32 products (attention_
// common.cuh), so the bound is 3 * 2.3e11 FLOP at 495 TFLOP/s, 1.42 ms
// (3.5 ms at the FP32-FMA rate); at BH=64, T=17984: 80.3 ms. This design
// recomputes the scores and dO V^T in both of its passes, so it runs seven
// products, not five.
//
// Design (FlashAttention-2's backward, deterministic, no atomics): three
// launches on one stream.
//   1. delta[r] = sum_d dO[r, d] O[r, d] in f32, one warp per row.
//   2. dK, dV: a block is one warpgroup (4 warps) and owns 64 keys (16 per
//      warp); K and V stay in shared memory for the whole walk over the
//      64-query tiles, Q and dO staged two tiles deep, lse and delta beside
//      them; all tiles swizzled and loaded as in K5 (one thread by TMA, or
//      all threads element by element where TMA cannot take the shape).
//      S^T = K Q^T and dP^T = V dO^T are 64 x 64 wgmma tiles (A = K or V,
//      B = Q or dO, all K-major in shared memory), in two groups: P^T is
//      formed while dP^T runs. P_drop^T, from registers, is the A operand
//      of dV += P_drop^T dO, and dS^T is formed while that runs and is the
//      A operand of dK += dS^T Q; their B tiles are the same dO and Q tiles
//      read MN-major.
//   3. dQ: a block owns 64 query rows and walks the key tiles, K and V
//      staged two deep; S = Q K^T and dP = dO V^T by wgmma from shared
//      memory (P formed while dP runs), dQ += dS K with dS from registers
//      and K read MN-major.
// A wgmma reads each B tile once for all 64 rows of the warpgroup; what
// sets the pace is then the per-thread instruction count, as in K5, hence
// the same TMA loader and paired rounding (at the flagship shape on an H100
// 80GB HBM3 at 700 W: 1.56 ms with a cp.async loader, 1.03 with TMA, 0.93
// with paired rounding).
// Each output element is written by one thread, summed in a fixed order.
// f32 inputs take the same two passes in the mma.sync arrangement (4 warps
// of 16 rows) with f32 tiles (row stride dk + 4 words; 105 KB of shared
// memory at dk = 64) and every product as three
// mma.sync m16n8k8 TF32 products of split operands, accumulated in f32, as
// in K5's f32 path: K_w, V_w (pass 2) and Q_w, dO_w (pass 3) are split per
// k-step from their staged tiles, the B operands as they are read, P and
// dS after they are formed; the second products read their k-steps in
// K5's permuted order, and each tile's dV, dK or dQ is summed in its own
// accumulator and added to the running one in f32, as in K5. The FP32-FMA
// passes this replaces (3.0-3.6x their FP32 bound) read one shared word per
// FMA; here one word a lane feeds one and a half 16x8x8 TF32 products.
//
// K10b and K10a, the backward of the JAX package's stock flash attention
// (entries `flash_bwd_dkv` and `flash_bwd_dq` at the end of this file),
// are passes 1 + 2 and pass 3 of the bf16 design above, instantiated with
// RAW scores (not rounded to bf16), no dropout and TMA staging only, at dk
// 64, 128 or 256, and launched as two entries in the stock VJP's order.
// Bounds, bf16 tensor-core peak: K10b 8*BH*T^2*dk FLOP (S^T, dP^T, dV, dK),
// K10a 6*BH*T^2*dk (S, dP, dQ). At dk 256 dK and dV together would take
// 256 accumulator registers a thread, so each tile runs as two blocks, one
// a half of the output columns (`out_cols`), both recomputing the scores
// and dP over all of dk.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NWARP = 4;     // warps per f32 block
constexpr int BT = 64;       // rows per block and per tile

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *grad_q, *grad_k, *grad_v;
  const int* seed;
  int BH, T, dk;
  float scale;
  uint32_t thresh;
  float inv_keep;
  cudaStream_t stream;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------ pass 1: delta
template <typename E>
__global__ void attn_bwd_delta(const E* __restrict__ o,
                               const E* __restrict__ dout,
                               float* __restrict__ delta, int rows, int dk) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // whole warps return together
  const size_t off = (size_t)row * dk;
  float acc = 0.f;
  for (int d = lane; d < dk; d += 32)
    acc = fmaf(to_f(o[off + d]), to_f(dout[off + d]), acc);
#pragma unroll
  for (int s = 16; s > 0; s /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[row] = acc;
}

// --------------------------------------------------- pass 2, bf16: dK, dV
template <int DKP>
constexpr size_t dkv_smem_bytes() {
  // K, V, then Q and dO of two buffers, 1024 bytes of slack to align the
  // tiles; then lse2 and delta of two buffers
  return sizeof(bf16) * 6 * sw_tile_elems<DKP>() + 1024 +
         sizeof(float) * 4 * BT;
}

// RAW: f32 scores (K10b, the stock flash kernel's numerics), else rounded
// to bf16 before the scale (K6); TMA: the tiles are staged by TMA
// (`tma_fits`), else by all threads
template <int DKP, bool RAW, bool DROP, bool TMA>
__global__ void __launch_bounds__(128)
attn_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk_out,
                  bf16* __restrict__ dv_out, int T, int dk, float scale,
                  const int* __restrict__ seedp, uint32_t thresh,
                  float inv_keep, const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mo) {
  constexpr int TILE = sw_tile_elems<DKP>();
  constexpr uint32_t TB = sw_tile_bytes<DKP>();
  constexpr int NS = BT / 8;      // 8-query column chunks of S^T
  constexpr int DKO = out_cols<DKP>();   // columns of dK, dV of this block
  constexpr int ND = DKO / 8;     // 8-wide column chunks of dK, dV
  const int p0 = blockIdx.y * (DKO / 64);   // this block's first panel
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // TMA: K/V, Q/dO buffers 0, 1
  bf16* Ks = reinterpret_cast<bf16*>(sw_align(smem_raw));
  bf16* Vs = Ks + TILE;
  bf16* QD = Vs + TILE;           // Q, dO of buffer 0, then of buffer 1
  float* LD = reinterpret_cast<float*>(QD + 4 * TILE);  // lse2, delta x 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const TileRow tr = tile_row(T, BT);
  const int bh = tr.bh, kv0 = tr.t0;
  const size_t base = (size_t)bh * T * dk;
  const int ntiles = (T + BT - 1) / BT;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);

  // lse in log2 units and delta of query tile j into buffer j % 2; rows
  // past T get lse2 = +inf, so their probabilities are exactly 0
  auto stage_rows = [&](int j) {
    float* dst = LD + (j % 2) * 2 * BT;
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const int t = j * BT + i;
      dst[i] = t < T ? lse[(size_t)bh * T + t] * LOG2E : INFINITY;
      dst[BT + i] = t < T ? delta[(size_t)bh * T + t] : 0.f;
    }
  };
  // Q and dO of query tile j into buffer j % 2; its k-th fill completes
  // phase k of barrier 1 + j % 2
  auto stage_tile = [&](int j) {
    bf16* dst = QD + (j % 2) * 2 * TILE;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &bars[1 + j % 2];
        mbar_expect(bar, 2 * TB);
        tma_tile<DKP>(dst, mq, bar, j * BT, bh);
        tma_tile<DKP>(dst + TILE, mo, bar, j * BT, bh);
      }
    } else {
      load_tile_sw<DKP>(dst, q + base, j * BT, T, dk);
      load_tile_sw<DKP>(dst + TILE, dout + base, j * BT, T, dk);
    }
  };

  // K and V stay for the whole walk; with query tile 0 at once
  if constexpr (TMA) {
    mbar_init_all(bars, 3);
    if (threadIdx.x == 0) {
      mbar_expect(&bars[0], 2 * TB);
      tma_tile<DKP>(Ks, mk, &bars[0], kv0, bh);
      tma_tile<DKP>(Vs, mv, &bars[0], kv0, bh);
    }
  } else {
    load_tile_sw<DKP>(Ks, k + base, kv0, T, dk);
    load_tile_sw<DKP>(Vs, v + base, kv0, T, dk);
  }
  stage_tile(0);
  stage_rows(0);
  if constexpr (TMA) mbar_wait(&bars[0], 0);
  else tiles_ready();

  float acck[ND][4], accv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[dn][e] = accv[dn][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      stage_tile(j + 1);
      stage_rows(j + 1);
    }
    if constexpr (TMA) mbar_wait(&bars[1 + j % 2], (j / 2) & 1);
    // the tiles this block wrote; lse2 and delta of tile j
    tiles_ready();
    const bf16* Qs = QD + (j % 2) * 2 * TILE;
    const bf16* dOs = Qs + TILE;
    const float* lse2 = LD + (j % 2) * 2 * BT;
    const float* dlt = lse2 + BT;
    const int q0 = j * BT;

    // S^T = K Q^T and dP^T = V dO^T (rows: this warpgroup's 64 keys), A
    // and B staged K-major, in two wgmma groups: P^T is formed while the
    // tensor cores run dP^T, and dS^T while they run dV
    float st[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dp[nt][e] = 0.f;
    fence_regs<4 * NS>(&st[0][0]);
    fence_regs<4 * NS>(&dp[0][0]);
    wgmma_fence();
    mma_abt<DKP>(&st[0][0], Ks, Qs);
    wgmma_commit();
    mma_abt<DKP>(&dp[0][0], Vs, dOs);
    wgmma_commit();
    wgmma_wait_one();   // S^T is complete
    fence_regs<4 * NS>(&st[0][0]);

    // P^T (keys past T, in a ragged last block only, get 0; query rows
    // past T get 0 from lse2 = +inf), then its dropped form, packed: the A
    // operand of dV += P_drop^T dO (dO read MN-major); element 4 nt + e's
    // keep bit is bit 4 nt + e of `keep`
    if constexpr (!RAW) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) round_bf16_pair(st[nt][e], st[nt][e + 1]);
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = fast_exp2(fmaf(st[nt][e], sl2,
                                   -lse2[nt * 8 + i2 + (e & 1)]));
    if (kv0 + 64 > T) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + warp * 16 + g + 8 * (e / 2) >= T) st[nt][e] = 0.f;
    }
    float pd[NS][4];
    uint32_t keep = 0;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pd[nt][e] = st[nt][e];
        if (DROP) {
          const int key = kv0 + warp * 16 + g + 8 * (e / 2);
          const bool kb =
              dropout_keep(dkey, q0 + nt * 8 + i2 + (e & 1), key, thresh);
          keep |= (uint32_t)kb << (4 * nt + e);
          pd[nt][e] = kb ? st[nt][e] * inv_keep : 0.f;
        }
      }
    uint32_t pa[BT / 16][4], sa[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) pack_a(pa[kk], pd[2 * kk], pd[2 * kk + 1]);
    fence_regs<4 * ND>(&accv[0][0]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DKO / 64; ++p) mma_ab(&accv[8 * p][0], pa, dOs, p0 + p);
    wgmma_commit();
    wgmma_wait_one();   // dP^T is complete
    fence_regs<4 * NS>(&dp[0][0]);

    // dS^T, packed: the A operand of dK += dS^T Q (Q read MN-major)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float da = dp[nt][e];
        if (DROP) da = (keep >> (4 * nt + e)) & 1u ? da * inv_keep : 0.f;
        dp[nt][e] = st[nt][e] * (da - dlt[nt * 8 + i2 + (e & 1)]) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) pack_a(sa[kk], dp[2 * kk], dp[2 * kk + 1]);
    fence_regs<4 * ND>(&acck[0][0]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DKO / 64; ++p) mma_ab(&acck[8 * p][0], sa, Qs, p0 + p);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4 * ND>(&accv[0][0]);
    fence_regs<4 * ND>(&acck[0][0]);
    __syncthreads();   // every warp is done with this buffer before refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kv0 + warp * 16 + g + 8 * h;
    if (key >= T) continue;
    const size_t off = base + (size_t)key * dk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = p0 * 64 + dn * 8 + i2 + e;
        if (col < dk) {
          dk_out[off + col] = __float2bfloat16(acck[dn][2 * h + e]);
          dv_out[off + col] = __float2bfloat16(accv[dn][2 * h + e]);
        }
      }
  }
}

// ------------------------------------------------------- pass 3, bf16: dQ
template <int DKP>
constexpr size_t dq_smem_bytes() {
  // Q, dO, two K and V tiles; 1024 bytes of slack to align them
  return sizeof(bf16) * 6 * sw_tile_elems<DKP>() + 1024;
}

// RAW and TMA as in the dK/dV pass
template <int DKP, bool RAW, bool DROP, bool TMA>
__global__ void __launch_bounds__(128)
attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq_out,
                 int T, int dk, float scale, const int* __restrict__ seedp,
                 uint32_t thresh, float inv_keep,
                 const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mo) {
  constexpr int TILE = sw_tile_elems<DKP>();
  constexpr uint32_t TB = sw_tile_bytes<DKP>();
  constexpr int NS = BT / 8;      // 8-key column chunks of S
  constexpr int DKO = out_cols<DKP>();   // columns of dQ of this block
  constexpr int ND = DKO / 8;
  const int p0 = blockIdx.y * (DKO / 64);   // this block's first panel
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // TMA: Q/dO, K/V buffers 0, 1
  bf16* Qs = reinterpret_cast<bf16*>(sw_align(smem_raw));
  bf16* dOs = Qs + TILE;
  bf16* KVs = dOs + TILE;         // K, V of buffer 0, then of buffer 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const TileRow tr = tile_row(T, BT);
  const int bh = tr.bh, q0 = tr.t0;
  const size_t base = (size_t)bh * T * dk;
  const int ntiles = (T + BT - 1) / BT;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);

  // K and V of key tile j into buffer j % 2; its k-th fill completes
  // phase k of barrier 1 + j % 2
  auto stage_tile = [&](int j) {
    bf16* dst = KVs + (j % 2) * 2 * TILE;
    if constexpr (TMA) {
      if (threadIdx.x == 0) {
        uint64_t* bar = &bars[1 + j % 2];
        mbar_expect(bar, 2 * TB);
        tma_tile<DKP>(dst, mk, bar, j * BT, bh);
        tma_tile<DKP>(dst + TILE, mv, bar, j * BT, bh);
      }
    } else {
      load_tile_sw<DKP>(dst, k + base, j * BT, T, dk);
      load_tile_sw<DKP>(dst + TILE, v + base, j * BT, T, dk);
    }
  };

  // Q, dO and the first K/V tile at once
  if constexpr (TMA) {
    mbar_init_all(bars, 3);
    if (threadIdx.x == 0) {
      mbar_expect(&bars[0], 2 * TB);
      tma_tile<DKP>(Qs, mq, &bars[0], q0, bh);
      tma_tile<DKP>(dOs, mo, &bars[0], q0, bh);
    }
  } else {
    load_tile_sw<DKP>(Qs, q + base, q0, T, dk);
    load_tile_sw<DKP>(dOs, dout + base, q0, T, dk);
  }
  stage_tile(0);
  if constexpr (TMA) mbar_wait(&bars[0], 0);
  else tiles_ready();
  // rows g and g + 8 of this warp: lse in log2 units and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse2[h] = row < T ? lse[(size_t)bh * T + row] * LOG2E : 0.f;
    dlt[h] = row < T ? delta[(size_t)bh * T + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) stage_tile(j + 1);
    if constexpr (TMA) mbar_wait(&bars[1 + j % 2], (j / 2) & 1);
    else tiles_ready();   // tile j + 1 is staged for the next iteration
    const bf16* Ks = KVs + (j % 2) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = j * BT;

    // S = Q K^T and dP = dO V^T, staged K-major, in two wgmma groups: P
    // is formed while the tensor cores run dP
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    fence_regs<4 * NS>(&s[0][0]);
    fence_regs<4 * NS>(&dp[0][0]);
    wgmma_fence();
    mma_abt<DKP>(&s[0][0], Qs, Ks);
    wgmma_commit();
    mma_abt<DKP>(&dp[0][0], dOs, Vs);
    wgmma_commit();
    wgmma_wait_one();   // S is complete
    fence_regs<4 * NS>(&s[0][0]);

    // P (keys past T, in the last tile only, get 0), then dS into dp
    if constexpr (!RAW) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) round_bf16_pair(s[nt][e], s[nt][e + 1]);
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = fast_exp2(fmaf(s[nt][e], sl2, -lse2[e / 2]));
    if (k0 + BT > T) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + i2 + (e & 1) >= T) s[nt][e] = 0.f;
    }
    wgmma_wait_all();   // dP is complete
    fence_regs<4 * NS>(&dp[0][0]);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        float da = dp[nt][e];
        if (DROP) {
          const int row = q0 + warp * 16 + g + 8 * h;
          const int col = k0 + nt * 8 + i2 + (e & 1);
          da = dropout_keep(dkey, row, col, thresh) ? da * inv_keep : 0.f;
        }
        dp[nt][e] = s[nt][e] * (da - dlt[h]) * scale;
      }

    // dQ += dS K: A from registers, K read MN-major (rows are keys)
    uint32_t sa[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) pack_a(sa[kk], dp[2 * kk], dp[2 * kk + 1]);
    fence_regs<4 * ND>(&acc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DKO / 64; ++p) mma_ab(&acc[8 * p][0], sa, Ks, p0 + p);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4 * ND>(&acc[0][0]);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    bf16* orow = dq_out + base + (size_t)row * dk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = p0 * 64 + dn * 8 + i2 + e;
        if (col < dk) orow[col] = __float2bfloat16(acc[dn][2 * h + e]);
      }
  }
}

// ---------------------------------------------------- pass 2, f32: dK, dV
// The bf16 pass's arrangement with 3xTF32 products (attention_common.cuh):
// K_w's and V_w's A fragments are read and split per k-step, Q's and dO's B
// fragments split as they are read, P and dS split after they are formed;
// the query index of each 8-query k-step of dV and dK is read in the
// permuted order, so st / dp tiles are the A operands without shuffles.
template <int DKP>
constexpr size_t dkv_f32_smem_bytes() {
  // K, V, then Q and dO of two buffers; then lse2 and delta of two buffers
  return sizeof(float) * 6 * BT * (DKP + 4) + sizeof(float) * 4 * BT;
}

template <int DKP, bool DROP>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk_out,
                 float* __restrict__ dv_out, int T, int dk, float scale,
                 const int* __restrict__ seedp, uint32_t thresh,
                 float inv_keep) {
  constexpr int LDF = DKP + 4;
  constexpr int TILE = BT * LDF;
  constexpr int KD = DKP / 8;     // k-steps over dk
  constexpr int NS = BT / 8;      // 8-query column tiles of S^T
  constexpr int ND = DKP / 8;     // 8-wide column tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + TILE;
  float* QD = Vs + TILE;          // Q, dO of buffer 0, then of buffer 1
  float* LD = QD + 4 * TILE;      // lse2, delta x 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const TileRow tr = tile_row(T, BT);
  const int bh = tr.bh, kv0 = tr.t0;
  const size_t base = (size_t)bh * T * dk;
  const int ntiles = (T + BT - 1) / BT;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);

  // lse in log2 units and delta of query tile j into buffer j % 2; rows
  // past T get lse2 = +inf, so their probabilities are exactly 0
  auto stage_rows = [&](int j) {
    float* dst = LD + (j % 2) * 2 * BT;
    for (int i = threadIdx.x; i < BT; i += blockDim.x) {
      const int t = j * BT + i;
      dst[i] = t < T ? lse[(size_t)bh * T + t] * LOG2E : INFINITY;
      dst[BT + i] = t < T ? delta[(size_t)bh * T + t] : 0.f;
    }
  };

  load_tile_f32<DKP>(Ks, k + base, kv0, T, dk);
  load_tile_f32<DKP>(Vs, v + base, kv0, T, dk);
  cp_async_commit();
  load_tile_f32<DKP>(QD, q + base, 0, T, dk);
  load_tile_f32<DKP>(QD + TILE, dout + base, 0, T, dk);
  stage_rows(0);
  cp_async_commit();

  float acck[ND][4], accv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[dn][e] = accv[dn][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      float* nxt = QD + ((j + 1) % 2) * 2 * TILE;
      load_tile_f32<DKP>(nxt, q + base, (j + 1) * BT, T, dk);
      load_tile_f32<DKP>(nxt + TILE, dout + base, (j + 1) * BT, T, dk);
      stage_rows(j + 1);
    }
    cp_async_commit();
    cp_async_wait_one();   // K, V and query tile j have landed
    __syncthreads();
    const float* Qs = QD + (j % 2) * 2 * TILE;
    const float* dOs = Qs + TILE;
    const float* lse2 = LD + (j % 2) * 2 * BT;
    const float* dlt = lse2 + BT;
    const int q0 = j * BT;

    // S^T = K_w Q^T and dP^T = V_w dO^T (rows: this warp's 16 keys)
    float st[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      SplitA ka, va;
      load_a_f32<LDF>(ka, Ks, warp * 16, kk * 8);
      load_a_f32<LDF>(va, Vs, warp * 16, kk * 8);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        mma_bt_f32<LDF>(st[nt], ka, Qs, nt, kk * 8);
        mma_bt_f32<LDF>(dp[nt], va, dOs, nt, kk * 8);
      }
    }

    // P^T, its dropped form (into st), and dS^T (into dp)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + warp * 16 + g + 8 * (e / 2);
        const int qi = nt * 8 + i2 + (e & 1);
        const float x = key < T ? st[nt][e] * sl2 : NEG;
        const float p = exp2f(x - lse2[qi]);
        float da = dp[nt][e];
        float pd = p;
        if (DROP) {
          const bool keep = dropout_keep(dkey, q0 + qi, key, thresh);
          pd = keep ? p * inv_keep : 0.f;
          da = keep ? da * inv_keep : 0.f;
        }
        st[nt][e] = pd;
        dp[nt][e] = p * (da - dlt[qi]) * scale;
      }

    // dV_w += P_drop^T dO, then dK_w += dS^T Q, over this query tile; query
    // step kk reads rows of dO and Q in the permuted order. Each tile's
    // product is summed in `part` and added in f32, as K5 adds P V
    float part[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      SplitA pa;
      acc_a_f32(pa, st[kk]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) mma_b_f32<LDF>(part[dn], pa, dOs, kk, dn);
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accv[dn][e] += part[dn][e];
        part[dn][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      SplitA sa;
      acc_a_f32(sa, dp[kk]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) mma_b_f32<LDF>(part[dn], sa, Qs, kk, dn);
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acck[dn][e] += part[dn][e];
    __syncthreads();   // every warp is done with this buffer before refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kv0 + warp * 16 + g + 8 * h;
    if (key >= T) continue;
    const size_t off = base + (size_t)key * dk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + i2 + e;
        if (col < dk) {
          dk_out[off + col] = acck[dn][2 * h + e];
          dv_out[off + col] = accv[dn][2 * h + e];
        }
      }
  }
}

// -------------------------------------------------------- pass 3, f32: dQ
// Q_w's and dO_w's split A fragments are read per k-step from the staged
// tiles (held in registers they would take 128 at dk = 64); dS tiles are
// the A operand of dQ += dS K with K's rows read in the permuted order.
template <int DKP>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * 6 * BT * (DKP + 4);   // Q, dO, two K and V tiles
}

template <int DKP, bool DROP>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq_out,
                int T, int dk, float scale, const int* __restrict__ seedp,
                uint32_t thresh, float inv_keep) {
  constexpr int LDF = DKP + 4;
  constexpr int TILE = BT * LDF;
  constexpr int KD = DKP / 8;
  constexpr int NS = BT / 8;      // 8-key column tiles of S
  constexpr int ND = DKP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + TILE;
  float* KVs = dOs + TILE;        // K, V of buffer 0, then of buffer 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const TileRow tr = tile_row(T, BT);
  const int bh = tr.bh, q0 = tr.t0;
  const size_t base = (size_t)bh * T * dk;
  const int ntiles = (T + BT - 1) / BT;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);

  load_tile_f32<DKP>(Qs, q + base, q0, T, dk);
  load_tile_f32<DKP>(dOs, dout + base, q0, T, dk);
  cp_async_commit();
  load_tile_f32<DKP>(KVs, k + base, 0, T, dk);
  load_tile_f32<DKP>(KVs + TILE, v + base, 0, T, dk);
  cp_async_commit();
  // rows g and g + 8 of this warp: lse in log2 units and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    lse2[h] = row < T ? lse[(size_t)bh * T + row] * LOG2E : 0.f;
    dlt[h] = row < T ? delta[(size_t)bh * T + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      float* nxt = KVs + ((j + 1) % 2) * 2 * TILE;
      load_tile_f32<DKP>(nxt, k + base, (j + 1) * BT, T, dk);
      load_tile_f32<DKP>(nxt + TILE, v + base, (j + 1) * BT, T, dk);
    }
    cp_async_commit();
    cp_async_wait_one();   // Q, dO and key tile j have landed
    __syncthreads();
    const float* Ks = KVs + (j % 2) * 2 * TILE;
    const float* Vs = Ks + TILE;
    const int k0 = j * BT;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      SplitA qa, oa;
      load_a_f32<LDF>(qa, Qs, warp * 16, kk * 8);
      load_a_f32<LDF>(oa, dOs, warp * 16, kk * 8);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        mma_bt_f32<LDF>(s[nt], qa, Ks, nt, kk * 8);
        mma_bt_f32<LDF>(dp[nt], oa, Vs, nt, kk * 8);
      }
    }

    // dS into dp
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + i2 + (e & 1);
        const float x = col < T ? s[nt][e] * sl2 : NEG;
        const float p = exp2f(x - lse2[h]);
        float da = dp[nt][e];
        if (DROP) {
          const int row = q0 + warp * 16 + g + 8 * h;
          da = dropout_keep(dkey, row, col, thresh) ? da * inv_keep : 0.f;
        }
        dp[nt][e] = p * (da - dlt[h]) * scale;
      }

    // dQ_w += dS K: key step kk reads K's rows in the permuted order; the
    // tile's product is summed in `part` and added in f32
    float part[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      SplitA a;
      acc_a_f32(a, dp[kk]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) mma_b_f32<LDF>(part[dn], a, Ks, kk, dn);
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] += part[dn][e];
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    float* orow = dq_out + base + (size_t)row * dk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + i2 + e;
        if (col < dk) orow[col] = acc[dn][2 * h + e];
      }
  }
}

// --------------------------------------------------------------- launches
template <typename E>
int launch_delta(const Args& a) {
  const int rows = a.BH * a.T;
  const int per_block = 8;   // warps, one row each
  attn_bwd_delta<E><<<(rows + per_block - 1) / per_block, 32 * per_block, 0,
                      a.stream>>>(static_cast<const E*>(a.o),
                                  static_cast<const E*>(a.dout), a.delta,
                                  rows, a.dk);
  return (int)cudaGetLastError();
}

// the tensor maps of q, k, v and dO (they hold the pointers: per call)
struct Maps {
  CUtensorMap q, k, v, o;
};

inline int encode_maps(Maps& m, const Args& a) {
  int err = encode_tile_map(&m.q, a.q, a.BH, a.T, a.dk);
  if (!err) err = encode_tile_map(&m.k, a.k, a.BH, a.T, a.dk);
  if (!err) err = encode_tile_map(&m.v, a.v, a.BH, a.T, a.dk);
  if (!err) err = encode_tile_map(&m.o, a.dout, a.BH, a.T, a.dk);
  return err;
}

// pass 2 (dK, dV) of a bf16 backward, after the delta pass
template <int DKP, bool RAW, bool DROP, bool TMA>
int launch_dkv(const Args& a, const Maps& m) {
  const size_t bytes = dkv_smem_bytes<DKP>();
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkv_bf16<DKP, RAW, DROP, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkv_bf16<DKP, RAW, DROP, TMA>
      <<<tile_grid(a.BH, a.T, BT, DKP / out_cols<DKP>()), 128, bytes,
         a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          a.lse, a.delta, static_cast<bf16*>(a.grad_k),
          static_cast<bf16*>(a.grad_v), a.T, a.dk, a.scale, a.seed, a.thresh,
          a.inv_keep, m.q, m.k, m.v, m.o);
  return (int)cudaGetLastError();
}

// pass 3 (dQ) of a bf16 backward, after pass 2
template <int DKP, bool RAW, bool DROP, bool TMA>
int launch_dq(const Args& a, const Maps& m) {
  const size_t bytes = dq_smem_bytes<DKP>();
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dq_bf16<DKP, RAW, DROP, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_bf16<DKP, RAW, DROP, TMA>
      <<<tile_grid(a.BH, a.T, BT, DKP / out_cols<DKP>()), 128, bytes,
         a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          a.lse, a.delta, static_cast<bf16*>(a.grad_q), a.T, a.dk, a.scale,
          a.seed, a.thresh, a.inv_keep, m.q, m.k, m.v, m.o);
  return (int)cudaGetLastError();
}

template <int DKP, bool DROP, bool TMA>
int launch_bf16_as(const Args& a) {
  int err = launch_delta<bf16>(a);
  if (err) return err;
  Maps m{};
  if (TMA && (err = encode_maps(m, a))) return err;
  err = launch_dkv<DKP, false, DROP, TMA>(a, m);
  return err ? err : launch_dq<DKP, false, DROP, TMA>(a, m);
}

template <int DKP, bool DROP>
int launch_bf16(const Args& a) {
  return tma_fits(a.q, a.dk) && tma_fits(a.k, a.dk) && tma_fits(a.v, a.dk) &&
                 tma_fits(a.dout, a.dk)
             ? launch_bf16_as<DKP, DROP, true>(a)
             : launch_bf16_as<DKP, DROP, false>(a);
}

template <int DKP, bool DROP>
int launch_f32(const Args& a) {
  int err = launch_delta<float>(a);
  if (err) return err;
  const dim3 grid = tile_grid(a.BH, a.T, BT);
  const size_t b1 = dkv_f32_smem_bytes<DKP>(), b2 = dq_f32_smem_bytes<DKP>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkv_f32<DKP, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_dq_f32<DKP, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)b2);
  if (e != cudaSuccess) return (int)e;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout);
  attn_bwd_dkv_f32<DKP, DROP><<<grid, NWARP * 32, b1, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.grad_k),
      static_cast<float*>(a.grad_v), a.T, a.dk, a.scale, a.seed, a.thresh,
      a.inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_f32<DKP, DROP><<<grid, NWARP * 32, b2, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.grad_q), a.T, a.dk,
      a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <bool DROP>
int dispatch(const Args& a, bool is_bf16) {
  if (is_bf16)   // swizzled tiles of 64 or 128 columns (zero-padded)
    return a.dk <= 64 ? launch_bf16<64, DROP>(a) : launch_bf16<128, DROP>(a);
  const int dkp = a.dk <= 16 ? 16 : a.dk <= 32 ? 32 : a.dk <= 64 ? 64 : 128;
  switch (dkp) {
    case 16: return launch_f32<16, DROP>(a);
    case 32: return launch_f32<32, DROP>(a);
    case 64: return launch_f32<64, DROP>(a);
    default: return launch_f32<128, DROP>(a);
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv (BH, T, dk) contiguous on the device, bf16
// when is_bf16 else float32; lse (the forward's, natural log) and the
// workspace delta (BH, T) float32. Dropout arguments as attention_fwd's.
// The caller checks 1 <= dk <= 128 and BH * T < 2^31.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv,
                             const void* seed, int BH, int T, int dkdim,
                             float scale, int dropout, unsigned int thresh,
                             float inv_keep, int is_bf16, void* stream) {
  if (dkdim < 1 || dkdim > 128) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv,
               static_cast<const int*>(seed), BH, T, dkdim, scale, thresh,
               inv_keep, static_cast<cudaStream_t>(stream)};
  return dropout ? dispatch<true>(a, is_bf16 != 0)
                 : dispatch<false>(a, is_bf16 != 0);
}

namespace {

// the flash instantiations: f32 scores, no dropout, TMA only
bool flash_args_ok(const Args& a) {
  return (a.dk == 64 || a.dk == 128 || a.dk == 256) && tma_fits(a.q, a.dk) &&
         tma_fits(a.k, a.dk) && tma_fits(a.v, a.dk) &&
         tma_fits(a.dout, a.dk);
}

template <int DKP>
int flash_dkv_as(const Args& a) {
  int err = launch_delta<bf16>(a);
  if (err) return err;
  Maps m{};
  if ((err = encode_maps(m, a))) return err;
  return launch_dkv<DKP, true, false, true>(a, m);
}

template <int DKP>
int flash_dq_as(const Args& a) {
  Maps m{};
  const int err = encode_maps(m, a);
  return err ? err : launch_dq<DKP, true, false, true>(a, m);
}

}  // namespace

// The backward of the JAX package's stock flash attention (its custom VJP,
// jax/experimental/pallas/ops/tpu/flash_attention.py:254-315), in the
// stock kernels' numerics: scores in f32, not rounded; p = exp(s - lse) in
// f32 from K9's row log-sum-exp (the stock kernels read m and l: exp(s -
// m) / l); dV += bf16(p)^T dO; dS = (dO V^T - di) p scale; dK += bf16(dS)^T
// Q; dQ += bf16(dS) K; f32 sums, bf16 outputs. Two entries, launched in the
// VJP's order. All tensors (BH, T, dk) bf16, contiguous and 16-byte
// aligned, dk in {64, 128, 256}; lse and delta (BH, T) f32. At dk 256 each
// tile runs as two blocks, one a half of the output columns (`out_cols`).
// The caller checks BH * T < 2^31.
//
// K10b (`_flash_attention_bwd_dkv` :941, launched at :1121, body
// `_flash_attention_dkv_kernel` :796): di = sum(o * dO) of each row into
// delta (the VJP's jnp.sum; the delta pass), then dK and dV (pass 2).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* delta, void* dk,
                             void* dv, int BH, int T, int dkdim, float scale,
                             void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), nullptr, dk, dv, nullptr, BH, T,
               dkdim, scale, 0u, 1.f, static_cast<cudaStream_t>(stream)};
  if (!flash_args_ok(a)) return (int)cudaErrorInvalidValue;
  switch (dkdim) {
    case 64: return flash_dkv_as<64>(a);
    case 128: return flash_dkv_as<128>(a);
    default: return flash_dkv_as<256>(a);
  }
}

// K10a (`_flash_attention_bwd_dq`, launched at :1456, body
// `_flash_attention_dq_kernel` :1146): dQ (pass 3), from the delta that
// K10b wrote.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BH, int T,
                            int dkdim, float scale, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), dq,
               nullptr, nullptr, nullptr, BH, T, dkdim, scale, 0u, 1.f,
               static_cast<cudaStream_t>(stream)};
  if (!flash_args_ok(a)) return (int)cudaErrorInvalidValue;
  switch (dkdim) {
    case 64: return flash_dq_as<64>(a);
    case 128: return flash_dq_as<128>(a);
    default: return flash_dq_as<256>(a);
  }
}
