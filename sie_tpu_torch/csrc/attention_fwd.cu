// K5: forward of full softmax attention, out = softmax(scale * Q K^T) V,
// for q, k, v of shape (BH, T, dk), dk <= 128, in bf16 or float32, with
// optional attention dropout and an optional row log-sum-exp output.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// sie_tpu/ops/pallas/attention_pallas.py (launched by `_attn_fwd_impl`,
// entry `fused_attention`), and at T > 4096 its kv-blocked variant
// `_fwd_kv_kernel` (K7, attention_pallas.py:163, launched by
// `_attn_fwd_blocked_impl` :279): this kernel already streams key tiles
// with an online softmax, drops after the row-sum update as K7 does, and
// writes the row log-sum-exp that K7 emits for its backward. Nothing here is
// sized by T: shared memory holds fixed 64-row tiles, the grid is (T / 64,
// BH), and every offset into q, k, v, o and lse is a 64-bit product.
//
// Numerics follow that kernel's `_score_block`: Q K^T accumulates in f32;
// with bf16 inputs the raw scores are rounded to bf16 before the scale;
// keys at or past T are masked with -1e30; the softmax runs in f32; the
// probabilities are rounded to v's type for the P V product, which
// accumulates in f32. One difference: the softmax here is online (running
// max and sum over key tiles), so the bf16 probabilities are rounded before
// the division by the row sum, not after it.
//
// Dropout uses the Pallas kernels' counter hash of (seed, bh,
// global row, global column) (attention_common.cuh), applied as the
// kv-blocked Pallas kernel `_fwd_kv_kernel` applies it: the running row sum
// takes the undropped probabilities, then the dropped ones are zeroed and
// the kept ones scaled by 1/(1 - rate) before the P V product. The result
// is the full-row kernel's where(keep, a/(1 - rate), 0) V. Rate 0 is a
// separate instantiation with no hash code in it.
//
// With `lse` given, the kernel also writes each row's natural log-sum-exp
// of the scaled, masked scores (f32, (BH, T)): the backward K6 recomputes
// exact probabilities from it. The serving path passes none, and runs an
// instantiation without dropout or log-sum-exp code.
//
// What bounds it on an H100: the two products are 4*BH*T^2*dk FLOP against
// 4*BH*T*dk elements of q, k, v and output, so it is bound by arithmetic.
// At the flagship shape (BH=512, T=845, dk=64) that is 9.4e10 FLOP: 0.095
// ms at the bf16 tensor-core peak (989 TFLOP/s). In f32 each product is
// three TF32 products (below), so the bound is 3 * 9.4e10 FLOP at the TF32
// peak (495 TFLOP/s), 0.567 ms, under the FP32-FMA bound of 1.40 ms; at
// BH=64, T=17984 (the EigenWorms-shaped model) 32.1 ms against 79.1 ms.
// The TPU kernel held one whole 845-key score row per query block in VMEM;
// on Hopper a 64 x 896 f32 score tile alone exceeds a block's 227 KB of
// shared memory, so this kernel walks 64-key tiles with an online softmax.
//
// Design, bf16 (the FlashAttention-2 arrangement): a block of 4 warps owns
// 64 query rows, each warp 16 of them. The block stages Q once and each
// 64-key tile of K and V in shared memory (dk padded with zeros to the next
// of 16, 32, 64, 128 there only), two K/V buffers deep: cp.async fills one
// while the warps read the other. Each warp keeps everything else in
// registers: its Q fragments, its 16 x 64 score tile, computed with
// mma.sync m16n8k16 (bf16 in, f32 out) on K fragments read by ldmatrix; the
// online-softmax state of its rows (each row is spread over four lanes,
// reduced by two shuffles; exponentials as exp2 of log2-scaled scores); and
// its 16 x dk f32 output accumulator. The score tile's accumulator layout
// is the layout of the A operand of the P V product, so the probabilities
// go from the softmax to the tensor cores without leaving registers; V
// fragments come from ldmatrix.trans.
//
// Design, f32 (3xTF32): the same arrangement, tiles and pipeline, with f32
// tiles (row stride dk + 4 words, 87 KB of shared memory at dk = 64) and
// every product taken as three mma.sync m16n8k8 TF32 products, big*big +
// big*small + small*big of each operand's split (attention_common.cuh),
// accumulated in f32: f32 accuracy on the tensor cores. Q's split
// fragments are made once per warp and held in registers (64 at dk = 64;
// read per k-step from the staged tile at dk = 128), K's and V's are split
// as they are read, P after the softmax. The scores stay f32 (no rounding
// before the scale). The accumulator of an 8-key score tile becomes P V's A
// operand by reading that k-step's keys in a permuted order (and V's rows
// in the same order; attention_common.cuh), with no shuffles. Each key
// tile's P V is summed in its own accumulator and added to the output in
// f32 (acc * alpha + pv), so no chain of tensor-core sums spans more than
// one tile. The FP32-FMA kernel this replaces read one shared word per FMA
// and was held at the shared-memory rate (4.8x its FP32 bound); here one
// f32 word a lane feeds one and a half TF32 products of 16x8x8, so the
// tensor cores, and not shared memory, set the pace.

#include "attention_common.cuh"

namespace {

using namespace attn;

// ------------------------------------------------- tiles of both paths
constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int NWARP = 4;    // warps per block, 16 query rows each

// ---------------------------------------------------------------- bf16 path
template <int DKP>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * 5 * 64 * (DKP + 8);   // Q, and two K and V tiles
}

template <int DKP, bool DROP, bool LSE>
__global__ void __launch_bounds__(NWARP * 32)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int T, int dk, float scale,
              const int* __restrict__ seedp, uint32_t thresh, float inv_keep) {
  constexpr int LDH = DKP + 8;
  constexpr int TILE = 64 * LDH;  // elements of one staged tile
  constexpr int KD = DKP / 16;    // k-steps of Q K^T
  constexpr int NS = BK / 8;      // 8-key column tiles of the scores
  constexpr int ND = DKP / 8;     // 8-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + TILE;          // K, V of buffer 0, then K, V of buffer 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  // scores in log2 units: exp(x * scale - m) = exp2(x * sl2 - m2)
  const float sl2 = scale * LOG2E;

  const size_t base = (size_t)blockIdx.y * T * dk;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (T + BK - 1) / BK;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, blockIdx.y);
  load_tile<DKP>(Qs, q + base, q0, T, dk);
  cp_async_commit();
  load_tile<DKP>(KVs, k + base, 0, T, dk);
  load_tile<DKP>(KVs + TILE, v + base, 0, T, dk);
  cp_async_commit();
  cp_async_wait_one();   // Q has landed
  __syncthreads();

  // this warp's Q rows as A fragments
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a<LDH>(qf[kk], Qs, warp * 16, kk);

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // online-softmax state of rows g and g + 8; l is this lane's share
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    // copy tile j + 1 into the other buffer while tile j is used
    if (j + 1 < ntiles) {
      bf16* nxt = KVs + ((j + 1) % 2) * 2 * TILE;
      load_tile<DKP>(nxt, k + base, (j + 1) * BK, T, dk);
      load_tile<DKP>(nxt + TILE, v + base, (j + 1) * BK, T, dk);
    }
    cp_async_commit();
    cp_async_wait_one();   // tile j has landed
    __syncthreads();
    const bf16* Ks = KVs + (j % 2) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = j * BK;

    // scores: B = K^T, so B fragments are rows of K
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; nt += 2)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t b[4];
        load_bt<LDH>(b, Ks, nt, kk);
        mma_bf16(s[nt], qf[kk], b[0], b[1]);
        mma_bf16(s[nt + 1], qf[kk], b[2], b[3]);
      }

    // raw score rounded to bf16, then scaled; keys past T masked
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + i2 + (e & 1);
        const float x = col < T ? round_bf16(s[nt][e]) * sl2 : NEG;
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);   // 0 on the first tile
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;
      }
    if (DROP) {   // after the row sum: it is over the undropped probabilities
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + warp * 16 + g + 8 * (e / 2);
          const int col = k0 + nt * 8 + i2 + (e & 1);
          s[nt][e] = dropout_keep(dkey, row, col, thresh)
                         ? s[nt][e] * inv_keep : 0.f;
        }
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e / 2];

    // P V: the accumulators of score tiles 2kk and 2kk+1 are the A operand
    // of key step kk; V fragments by ldmatrix.trans (rows are keys)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t b[4];
        load_b<LDH>(b, Vs, dn, kk);
        mma_bf16(acc[dn], a, b[0], b[1]);
        mma_bf16(acc[dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer before refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    const float inv = 1.f / l[h];
    bf16* orow = o + base + (size_t)row * dk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + i2 + e;
        if (col < dk) orow[col] = __float2bfloat16(acc[dn][2 * h + e] * inv);
      }
    if (LSE && i2 == 0)
      lse[(size_t)blockIdx.y * T + row] = (m[h] + log2f(l[h])) * LN2;
  }
}

// ----------------------------------------------------------------- f32 path
template <int DKP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * 5 * 64 * (DKP + 4);  // Q, and two K and V tiles
}

template <int DKP, bool DROP, bool LSE>
__global__ void __launch_bounds__(NWARP * 32)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int T, int dk, float scale,
             const int* __restrict__ seedp, uint32_t thresh, float inv_keep) {
  constexpr int LDF = DKP + 4;
  constexpr int TILE = 64 * LDF;
  constexpr int KD = DKP / 8;     // k-steps of Q K^T
  constexpr int NS = BK / 8;      // 8-key column tiles of the scores
  constexpr int ND = DKP / 8;     // 8-wide column tiles of the output
  // this warp's split Q fragments stay in registers up to dk = 64 (64 of
  // them there); at 128 they are read from the staged Q tile per k-step
  constexpr bool QREG = DKP <= 64;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KVs = Qs + TILE;         // K, V of buffer 0, then K, V of buffer 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;

  const size_t base = (size_t)blockIdx.y * T * dk;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (T + BK - 1) / BK;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, blockIdx.y);
  load_tile_f32<DKP>(Qs, q + base, q0, T, dk);
  cp_async_commit();
  load_tile_f32<DKP>(KVs, k + base, 0, T, dk);
  load_tile_f32<DKP>(KVs + TILE, v + base, 0, T, dk);
  cp_async_commit();
  cp_async_wait_one();   // Q has landed
  __syncthreads();

  SplitA qf[QREG ? KD : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) load_a_f32<LDF>(qf[kk], Qs, warp * 16, kk * 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // online-softmax state of rows g and g + 8; l is this lane's share
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      float* nxt = KVs + ((j + 1) % 2) * 2 * TILE;
      load_tile_f32<DKP>(nxt, k + base, (j + 1) * BK, T, dk);
      load_tile_f32<DKP>(nxt + TILE, v + base, (j + 1) * BK, T, dk);
    }
    cp_async_commit();
    cp_async_wait_one();   // tile j has landed
    __syncthreads();
    const float* Ks = KVs + (j % 2) * 2 * TILE;
    const float* Vs = Ks + TILE;
    const int k0 = j * BK;

    // scores: B = K^T, so B fragments are rows of K
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      SplitA a;
      if constexpr (QREG) a = qf[kk];
      else load_a_f32<LDF>(a, Qs, warp * 16, kk * 8);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) mma_bt_f32<LDF>(s[nt], a, Ks, nt, kk * 8);
    }

    // f32 scores, scaled into log2 units; keys past T masked
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + i2 + (e & 1);
        const float x = col < T ? s[nt][e] * sl2 : NEG;
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);   // 0 on the first tile
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;
      }
    if (DROP) {   // after the row sum: it is over the undropped probabilities
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + warp * 16 + g + 8 * (e / 2);
          const int col = k0 + nt * 8 + i2 + (e & 1);
          s[nt][e] = dropout_keep(dkey, row, col, thresh)
                         ? s[nt][e] * inv_keep : 0.f;
        }
    }

    // P V: score tile kk, split, is the A operand of key step kk in the
    // permuted order; V rows are read in the same order. The tile's product
    // is summed in its own accumulator and added to acc in f32: chained
    // tensor-core sums into C are not rounded to nearest, and one chain
    // over the 281 tiles of T = 17984 drifted past the f32 limit (error
    // 1.1e-5 at max|want| 0.094 on an H100)
    float pv[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[dn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      SplitA a;
      acc_a_f32(a, s[kk]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) mma_b_f32<LDF>(pv[dn], a, Vs, kk, dn);
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[dn][e] = fmaf(acc[dn][e], alpha[e / 2], pv[dn][e]);
    __syncthreads();   // every warp is done with this buffer before refill
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    const float inv = 1.f / l[h];
    float* orow = o + base + (size_t)row * dk;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dn * 8 + i2 + e;
        if (col < dk) orow[col] = acc[dn][2 * h + e] * inv;
      }
    if (LSE && i2 == 0)
      lse[(size_t)blockIdx.y * T + row] = (m[h] + log2f(l[h])) * LN2;
  }
}

struct Args {
  const void *q, *k, *v;
  void *o;
  float* lse;
  const int* seed;
  int BH, T, dk;
  float scale;
  uint32_t thresh;
  float inv_keep;
  cudaStream_t stream;
};

template <int DKP, bool DROP, bool LSE>
int launch_bf16(const Args& a) {
  const size_t bytes = bf16_smem_bytes<DKP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<DKP, DROP, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + BQ - 1) / BQ, a.BH);
  attn_fwd_bf16<DKP, DROP, LSE><<<grid, NWARP * 32, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.T,
      a.dk, a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <int DKP, bool DROP, bool LSE>
int launch_f32(const Args& a) {
  const size_t bytes = f32_smem_bytes<DKP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32<DKP, DROP, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + BQ - 1) / BQ, a.BH);
  attn_fwd_f32<DKP, DROP, LSE><<<grid, NWARP * 32, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.T,
      a.dk, a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <bool DROP, bool LSE>
int dispatch(const Args& a, bool is_bf16) {
  const int dkp = a.dk <= 16 ? 16 : a.dk <= 32 ? 32 : a.dk <= 64 ? 64 : 128;
  if (is_bf16) {
    switch (dkp) {
      case 16: return launch_bf16<16, DROP, LSE>(a);
      case 32: return launch_bf16<32, DROP, LSE>(a);
      case 64: return launch_bf16<64, DROP, LSE>(a);
      default: return launch_bf16<128, DROP, LSE>(a);
    }
  }
  switch (dkp) {
    case 16: return launch_f32<16, DROP, LSE>(a);
    case 32: return launch_f32<32, DROP, LSE>(a);
    case 64: return launch_f32<64, DROP, LSE>(a);
    default: return launch_f32<128, DROP, LSE>(a);
  }
}

}  // namespace

// q, k, v, o (BH, T, dk) contiguous on the device, bf16 when is_bf16 else
// float32; lse (BH, T) float32 or null. With `dropout` set: seed is one
// int32 on the device, thresh = min(rate * 2^32, 2^32 - 1) and inv_keep =
// 1 / (1 - rate); without, those three are not read. The caller checks
// 1 <= dk <= 128 and BH <= 65535.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* seed, int BH,
                             int T, int dk, float scale, int dropout,
                             unsigned int thresh, float inv_keep, int is_bf16,
                             void* stream) {
  if (dk < 1 || dk > 128) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse),
               static_cast<const int*>(seed), BH, T, dk, scale, thresh,
               inv_keep, static_cast<cudaStream_t>(stream)};
  const bool bf = is_bf16 != 0;
  if (lse != nullptr)
    return dropout ? dispatch<true, true>(a, bf) : dispatch<false, true>(a, bf);
  return dropout ? dispatch<true, false>(a, bf) : dispatch<false, false>(a, bf);
}
