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
// sized by T: shared memory holds fixed 64-row tiles, the grid is T / 64
// tiles times BH (`tile_grid`), and every offset into q, k, v, o and lse
// is a 64-bit product.
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
// Design, bf16 (warpgroup MMA): a block is one warpgroup (4 warps, 128
// threads) and owns 64 query rows, warp w rows 16w .. 16w + 15. The block
// stages Q once and each 64-key tile of K and V in shared memory as
// swizzled tiles (attention_common.cuh: 128-byte swizzle, dk zero-padded to
// 64 or 128), two K/V buffers deep: one thread loads them by TMA (Q and
// the first K/V tile together, tile j + 1 while tile j is used, each
// buffer's fills counted on its mbarrier), or, where TMA cannot take the
// shape, all threads element by element. S = Q K^T is one 64 x 64 wgmma
// tile per key tile (m64n64k16, A = Q and B = K both read from shared
// memory through K-major descriptors); the online softmax runs on its
// accumulators in registers (each row spread over four lanes, reduced by
// two shuffles; exponentials as one FFMA and ex2.approx of the raw score);
// O += P V is wgmma with A = P from registers (the score accumulators,
// packed to bf16, are wgmma's register A fragments) and B = the V tile read
// MN-major (transposed); O accumulates in f32 registers.
// With the tensor-core work per tile down to a few wgmma instructions, the
// softmax's per-score instructions and the loader's per-thread copies set
// the pace, so the design spends none it can avoid: TMA in place of a
// cp.async per 16 bytes and thread, one conversion per pair of scores,
// masking only in the tile that reaches past T (at the flagship shape on an
// H100 80GB HBM3 at 700 W: 0.57 ms with a cp.async loader, 0.33 with TMA,
// 0.30 with paired rounding).
//
// Design, f32 (3xTF32): the mma.sync arrangement (4 warps, 16 query rows
// each, 64-row tiles two deep by cp.async), with f32 tiles (row stride
// dk + 4 words, 87 KB of shared memory at dk = 64) and every product taken
// as three mma.sync m16n8k8 TF32 products, big*big +
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
//
#include "attention_common.cuh"

namespace {

using namespace attn;

// ------------------------------------------------- tiles of both paths
constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int NWARP = 4;    // warps per f32 block, 16 query rows each

// ---------------------------------------------------------------- bf16 path
template <int DKP>
constexpr size_t bf16_smem_bytes() {
  // Q, and two K and V tiles; 1024 bytes of slack to align the tiles
  return sizeof(bf16) * 5 * sw_tile_elems<DKP>() + 1024;
}

// TMA: the tiles are staged by TMA (`tma_fits`), else by all threads
template <int DKP, bool DROP, bool LSE, bool TMA>
__global__ void __launch_bounds__(128)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int T, int dk, float scale,
              const int* __restrict__ seedp, uint32_t thresh, float inv_keep,
              const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv) {
  constexpr int TILE = sw_tile_elems<DKP>();
  constexpr uint32_t TB = sw_tile_bytes<DKP>();
  constexpr int NS = BK / 8;      // 8-key column chunks of the scores
  constexpr int ND = DKP / 8;     // 8-wide column chunks of the output
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];   // TMA: Q, K/V buffers 0, 1
  bf16* Qs = reinterpret_cast<bf16*>(sw_align(smem_raw));
  bf16* KVs = Qs + TILE;          // K, V of buffer 0, then K, V of buffer 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  // scores in log2 units: exp(x * scale - m) = exp2(x * sl2 - m2)
  const float sl2 = scale * LOG2E;

  const TileRow tr = tile_row(T, BQ);
  const int bh = tr.bh, q0 = tr.t0;
  const size_t base = (size_t)bh * T * dk;
  const int ntiles = (T + BK - 1) / BK;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);
  // Q and the first K/V tile at once: their loads overlap
  if constexpr (TMA) {
    mbar_init_all(bars, 3);
    if (threadIdx.x == 0) {
      mbar_expect(&bars[0], TB);
      tma_tile<DKP>(Qs, mq, &bars[0], q0, bh);
      mbar_expect(&bars[1], 2 * TB);
      tma_tile<DKP>(KVs, mk, &bars[1], 0, bh);
      tma_tile<DKP>(KVs + TILE, mv, &bars[1], 0, bh);
    }
    mbar_wait(&bars[0], 0);
  } else {
    load_tile_sw<DKP>(Qs, q + base, q0, T, dk);
    load_tile_sw<DKP>(KVs, k + base, 0, T, dk);
    load_tile_sw<DKP>(KVs + TILE, v + base, 0, T, dk);
    tiles_ready();
  }

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // online-softmax state of rows g and g + 8; l is this lane's share
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    // copy tile j + 1 into the other buffer while tile j is used; buffer
    // b's k-th fill completes phase k of barrier 1 + b
    bf16* nxt = KVs + ((j + 1) % 2) * 2 * TILE;
    if constexpr (TMA) {
      if (j + 1 < ntiles && threadIdx.x == 0) {
        uint64_t* bar = &bars[1 + (j + 1) % 2];
        mbar_expect(bar, 2 * TB);
        tma_tile<DKP>(nxt, mk, bar, (j + 1) * BK, bh);
        tma_tile<DKP>(nxt + TILE, mv, bar, (j + 1) * BK, bh);
      }
      mbar_wait(&bars[1 + j % 2], (j / 2) & 1);
    } else {
      if (j + 1 < ntiles) {
        load_tile_sw<DKP>(nxt, k + base, (j + 1) * BK, T, dk);
        load_tile_sw<DKP>(nxt + TILE, v + base, (j + 1) * BK, T, dk);
      }
      tiles_ready();   // tile j + 1 is staged for the next iteration
    }
    const bf16* Ks = KVs + (j % 2) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = j * BK;

    // scores S = Q K^T: both tiles K-major, one 64 x 64 wgmma tile
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    fence_regs<4 * NS>(&s[0][0]);
    wgmma_fence();
    mma_abt<DKP>(&s[0][0], Qs, Ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4 * NS>(&s[0][0]);

    // raw scores rounded to bf16; keys past T (in the last tile only)
    // masked; the scale goes into the exponent's FMA (max of r * sl2 is
    // sl2 * max of r, as sl2 > 0)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) round_bf16_pair(s[nt][e], s[nt][e + 1]);
    if (k0 + BK > T) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + i2 + (e & 1) >= T) s[nt][e] = NEG;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * sl2);
      alpha[h] = fast_exp2(m[h] - m_new);   // 0 on the first tile
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[nt][e], sl2, -m[e / 2]));
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

    // O += P V: the score accumulators of chunks 2kk, 2kk + 1 are the A
    // operand of key step kk (registers); V is read MN-major
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
    fence_regs<4 * ND>(&acc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DKP / 64; ++p) mma_ab(&acc[8 * p][0], pa, Vs, p);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4 * ND>(&acc[0][0]);
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
      lse[(size_t)bh * T + row] = (m[h] + log2f(l[h])) * LN2;
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

  const TileRow tr = tile_row(T, BQ);
  const int bh = tr.bh, q0 = tr.t0;
  const size_t base = (size_t)bh * T * dk;
  const int ntiles = (T + BK - 1) / BK;
  uint32_t dkey = 0;
  if (DROP) dkey = dropout_key(*seedp, bh);
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
      lse[(size_t)bh * T + row] = (m[h] + log2f(l[h])) * LN2;
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

template <int DKP, bool DROP, bool LSE, bool TMA>
int launch_bf16_as(const Args& a) {
  const size_t bytes = bf16_smem_bytes<DKP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<DKP, DROP, LSE, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq{}, mk{}, mv{};   // the maps hold the pointers: per call
  if (TMA) {
    int e = encode_tile_map(&mq, a.q, a.BH, a.T, a.dk);
    if (!e) e = encode_tile_map(&mk, a.k, a.BH, a.T, a.dk);
    if (!e) e = encode_tile_map(&mv, a.v, a.BH, a.T, a.dk);
    if (e) return e;
  }
  const dim3 grid = tile_grid(a.BH, a.T, BQ);
  attn_fwd_bf16<DKP, DROP, LSE, TMA><<<grid, 128, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.T,
      a.dk, a.scale, a.seed, a.thresh, a.inv_keep, mq, mk, mv);
  return (int)cudaGetLastError();
}

template <int DKP, bool DROP, bool LSE>
int launch_bf16(const Args& a) {
  return tma_fits(a.q, a.dk) && tma_fits(a.k, a.dk) && tma_fits(a.v, a.dk)
             ? launch_bf16_as<DKP, DROP, LSE, true>(a)
             : launch_bf16_as<DKP, DROP, LSE, false>(a);
}

template <int DKP, bool DROP, bool LSE>
int launch_f32(const Args& a) {
  const size_t bytes = f32_smem_bytes<DKP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32<DKP, DROP, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = tile_grid(a.BH, a.T, BQ);
  attn_fwd_f32<DKP, DROP, LSE><<<grid, NWARP * 32, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.T,
      a.dk, a.scale, a.seed, a.thresh, a.inv_keep);
  return (int)cudaGetLastError();
}

template <bool DROP, bool LSE>
int dispatch(const Args& a, bool is_bf16) {
  if (is_bf16)   // swizzled tiles of 64 or 128 columns (zero-padded)
    return a.dk <= 64 ? launch_bf16<64, DROP, LSE>(a)
                      : launch_bf16<128, DROP, LSE>(a);
  const int dkp = a.dk <= 16 ? 16 : a.dk <= 32 ? 32 : a.dk <= 64 ? 64 : 128;
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
// 1 <= dk <= 128 and BH * T < 2^31.
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
