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
//   2. dK, dV: a block of 4 warps owns 64 keys (16 per warp) and walks all
//      64-query tiles, Q and dO staged in shared memory two tiles deep by
//      cp.async, lse and delta beside them. Each warp computes its 16 x 64
//      transposed score tile S^T = K_w Q^T and dP^T = V_w dO^T with
//      mma.sync (bf16 in, f32 out), turns them into P^T and dS^T in
//      registers, and accumulates dV_w += P_drop^T dO and dK_w += dS^T Q
//      in registers: the accumulator layout of the score tiles is the A
//      operand of the next product, as in K5.
//   3. dQ: a block owns 64 query rows and walks the key tiles, K and V
//      staged two deep; each warp computes S = Q_w K^T and dP = dO_w V^T
//      and accumulates dQ_w += dS K.
// Each output element is written by one thread, summed in a fixed order.
// f32 inputs take the same two passes with f32 tiles (row stride dk + 4
// words; 105 KB of shared memory at dk = 64) and every product as three
// mma.sync m16n8k8 TF32 products of split operands, accumulated in f32, as
// in K5's f32 path: K_w, V_w (pass 2) and Q_w, dO_w (pass 3) are split per
// k-step from their staged tiles, the B operands as they are read, P and
// dS after they are formed; the second products read their k-steps in
// K5's permuted order, and each tile's dV, dK or dQ is summed in its own
// accumulator and added to the running one in f32, as in K5. The FP32-FMA
// passes this replaces (3.0-3.6x their FP32 bound) read one shared word per
// FMA; here one word a lane feeds one and a half 16x8x8 TF32 products.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NWARP = 4;     // warps per block
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
  // K, V, then Q and dO of two buffers; then lse2 and delta of two buffers
  return sizeof(bf16) * 6 * BT * (DKP + 8) + sizeof(float) * 4 * BT;
}

template <int DKP, bool DROP>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk_out,
                  bf16* __restrict__ dv_out, int T, int dk, float scale,
                  const int* __restrict__ seedp, uint32_t thresh,
                  float inv_keep) {
  constexpr int LDH = DKP + 8;
  constexpr int TILE = BT * LDH;
  constexpr int KD = DKP / 16;    // k-steps over dk
  constexpr int NS = BT / 8;      // 8-query column tiles of S^T
  constexpr int ND = DKP / 8;     // 8-wide column tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* QD = Vs + TILE;           // Q, dO of buffer 0, then of buffer 1
  float* LD = reinterpret_cast<float*>(QD + 4 * TILE);  // lse2, delta x 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * T * dk;
  const int kv0 = blockIdx.x * BT;
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

  load_tile<DKP>(Ks, k + base, kv0, T, dk);
  load_tile<DKP>(Vs, v + base, kv0, T, dk);
  cp_async_commit();
  load_tile<DKP>(QD, q + base, 0, T, dk);
  load_tile<DKP>(QD + TILE, dout + base, 0, T, dk);
  stage_rows(0);
  cp_async_commit();

  float acck[ND][4], accv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[dn][e] = accv[dn][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      bf16* nxt = QD + ((j + 1) % 2) * 2 * TILE;
      load_tile<DKP>(nxt, q + base, (j + 1) * BT, T, dk);
      load_tile<DKP>(nxt + TILE, dout + base, (j + 1) * BT, T, dk);
      stage_rows(j + 1);
    }
    cp_async_commit();
    cp_async_wait_one();   // K, V and query tile j have landed
    __syncthreads();
    const bf16* Qs = QD + (j % 2) * 2 * TILE;
    const bf16* dOs = Qs + TILE;
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
      uint32_t ka[4], va[4];
      load_a<LDH>(ka, Ks, warp * 16, kk);
      load_a<LDH>(va, Vs, warp * 16, kk);
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
        uint32_t b[4];
        load_bt<LDH>(b, Qs, nt, kk);
        mma_bf16(st[nt], ka, b[0], b[1]);
        mma_bf16(st[nt + 1], ka, b[2], b[3]);
        load_bt<LDH>(b, dOs, nt, kk);
        mma_bf16(dp[nt], va, b[0], b[1]);
        mma_bf16(dp[nt + 1], va, b[2], b[3]);
      }
    }

    // P^T, its dropped form (into st), and dS^T (into dp)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + warp * 16 + g + 8 * (e / 2);
        const int qi = nt * 8 + i2 + (e & 1);
        const float x = key < T ? round_bf16(st[nt][e]) * sl2 : NEG;
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

    // dV_w += P_drop^T dO and dK_w += dS^T Q, both over this query tile
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pack_a(pa, st[2 * kk], st[2 * kk + 1]);
      pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t b[4];
        load_b<LDH>(b, dOs, dn, kk);
        mma_bf16(accv[dn], pa, b[0], b[1]);
        mma_bf16(accv[dn + 1], pa, b[2], b[3]);
        load_b<LDH>(b, Qs, dn, kk);
        mma_bf16(acck[dn], sa, b[0], b[1]);
        mma_bf16(acck[dn + 1], sa, b[2], b[3]);
      }
    }
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
          dk_out[off + col] = __float2bfloat16(acck[dn][2 * h + e]);
          dv_out[off + col] = __float2bfloat16(accv[dn][2 * h + e]);
        }
      }
  }
}

// ------------------------------------------------------- pass 3, bf16: dQ
template <int DKP>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 6 * BT * (DKP + 8);   // Q, dO, two K and V tiles
}

template <int DKP, bool DROP>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq_out,
                 int T, int dk, float scale, const int* __restrict__ seedp,
                 uint32_t thresh, float inv_keep) {
  constexpr int LDH = DKP + 8;
  constexpr int TILE = BT * LDH;
  constexpr int KD = DKP / 16;
  constexpr int NS = BT / 8;      // 8-key column tiles of S
  constexpr int ND = DKP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE;
  bf16* KVs = dOs + TILE;         // K, V of buffer 0, then of buffer 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * T * dk;
  const int q0 = blockIdx.x * BT;
  const int ntiles = (T + BT - 1) / BT;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);

  load_tile<DKP>(Qs, q + base, q0, T, dk);
  load_tile<DKP>(dOs, dout + base, q0, T, dk);
  cp_async_commit();
  load_tile<DKP>(KVs, k + base, 0, T, dk);
  load_tile<DKP>(KVs + TILE, v + base, 0, T, dk);
  cp_async_commit();
  cp_async_wait_one();   // Q and dO have landed
  __syncthreads();

  uint32_t qf[KD][4], of[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    load_a<LDH>(qf[kk], Qs, warp * 16, kk);
    load_a<LDH>(of[kk], dOs, warp * 16, kk);
  }
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
      bf16* nxt = KVs + ((j + 1) % 2) * 2 * TILE;
      load_tile<DKP>(nxt, k + base, (j + 1) * BT, T, dk);
      load_tile<DKP>(nxt + TILE, v + base, (j + 1) * BT, T, dk);
    }
    cp_async_commit();
    cp_async_wait_one();   // key tile j has landed
    __syncthreads();
    const bf16* Ks = KVs + (j % 2) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = j * BT;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; nt += 2)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        load_bt<LDH>(b, Ks, nt, kk);
        mma_bf16(s[nt], qf[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
        load_bt<LDH>(b, Vs, nt, kk);
        mma_bf16(dp[nt], of[kk], b[0], b[1]);
        mma_bf16(dp[nt + 1], of[kk], b[2], b[3]);
      }

    // dS into dp
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int col = k0 + nt * 8 + i2 + (e & 1);
        const float x = col < T ? round_bf16(s[nt][e]) * sl2 : NEG;
        const float p = exp2f(x - lse2[h]);
        float da = dp[nt][e];
        if (DROP) {
          const int row = q0 + warp * 16 + g + 8 * h;
          da = dropout_keep(dkey, row, col, thresh) ? da * inv_keep : 0.f;
        }
        dp[nt][e] = p * (da - dlt[h]) * scale;
      }

    // dQ_w += dS K: K fragments by ldmatrix.trans (rows are keys)
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t b[4];
        load_b<LDH>(b, Ks, dn, kk);
        mma_bf16(acc[dn], a, b[0], b[1]);
        mma_bf16(acc[dn + 1], a, b[2], b[3]);
      }
    }
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
        const int col = dn * 8 + i2 + e;
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
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * T * dk;
  const int kv0 = blockIdx.x * BT;
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
  const int bh = blockIdx.y;
  const size_t base = (size_t)bh * T * dk;
  const int q0 = blockIdx.x * BT;
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

template <int DKP, bool DROP>
int launch_bf16(const Args& a) {
  int err = launch_delta<bf16>(a);
  if (err) return err;
  const dim3 grid((a.T + BT - 1) / BT, a.BH);
  const size_t b1 = dkv_smem_bytes<DKP>(), b2 = dq_smem_bytes<DKP>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkv_bf16<DKP, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_dq_bf16<DKP, DROP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)b2);
  if (e != cudaSuccess) return (int)e;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *dout = static_cast<const bf16*>(a.dout);
  attn_bwd_dkv_bf16<DKP, DROP><<<grid, NWARP * 32, b1, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.grad_k),
      static_cast<bf16*>(a.grad_v), a.T, a.dk, a.scale, a.seed, a.thresh,
      a.inv_keep);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_bf16<DKP, DROP><<<grid, NWARP * 32, b2, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.grad_q), a.T, a.dk,
      a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <int DKP, bool DROP>
int launch_f32(const Args& a) {
  int err = launch_delta<float>(a);
  if (err) return err;
  const dim3 grid((a.T + BT - 1) / BT, a.BH);
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
  const int dkp = a.dk <= 16 ? 16 : a.dk <= 32 ? 32 : a.dk <= 64 ? 64 : 128;
  if (is_bf16) {
    switch (dkp) {
      case 16: return launch_bf16<16, DROP>(a);
      case 32: return launch_bf16<32, DROP>(a);
      case 64: return launch_bf16<64, DROP>(a);
      default: return launch_bf16<128, DROP>(a);
    }
  }
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
// The caller checks 1 <= dk <= 128 and BH <= 65535.
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
