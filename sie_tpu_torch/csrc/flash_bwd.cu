// K10b and K10a: the backward of the JAX package's stock flash attention,
// in its custom VJP's order (jax/experimental/pallas/ops/tpu/
// flash_attention.py:254-315): K10b (`_flash_attention_bwd_dkv` :941,
// launched at :1121, body `_flash_attention_dkv_kernel` :796) takes each
// row's di = sum(o * dO) (the VJP's jnp.sum; a delta pass) and dK, dV;
// K10a (`_flash_attention_bwd_dq`, launched at :1456, body
// `_flash_attention_dq_kernel` :1146) takes dQ from that di.
// sie_tpu/models/layers.py:119 (`FullAttentionLayer._flash`) reaches them
// under `use_flash_attention`. q, k, v, o, dO (BH, T, dk) bf16, dk in {64,
// 128, 256}, any T; lse (K9's row log-sum-exp) and di (BH, T) f32.
//
// Numerics, the stock kernels': s = Q K^T accumulates in f32 from bf16 and
// is scaled in f32, never rounded to bf16; p = exp(s - lse) in f32 (the
// stock kernels read K9's m and l: exp(s - m) / l); dV += bf16(p)^T dO; dS
// = (dO V^T - di) p scale; dK += bf16(dS)^T Q; dQ += bf16(dS) K; every sum
// in f32 over 64-row tiles in row order, each gradient rounded to bf16
// once. Keys and rows at or past T give p = 0. No atomics: each output
// element is summed by one thread in a fixed order, so two runs are equal
// bit for bit.
//
// What bounds them on an H100: K10b's four products (S^T, dP^T, dV, dK)
// are 8*BH*T^2*dk FLOP, K10a's three (S, dP, dQ) 6*BH*T^2*dk, on the bf16
// tensor cores (989 TFLOP/s): 0.1893 and 0.1419 ms at BH 512, T 845, dk 64
// (and at BH 256 dk 128, BH 128 dk 256), 10.72 and 8.04 ms at BH 64, T
// 17984. At PatchTST's chunk (BH 15616, T 105, dk 64) the bytes bound:
// 0.4425 and 0.3172 ms.
//
// Design: K9's (flash_fwd.cu). A block has a producer warpgroup
// (`setmaxnreg` lowers it to 24 registers; one thread issues every TMA
// load into a ring, each stage with a full and an empty mbarrier) and
// consumer warpgroups of 64 rows or keys each: three at dk 64 (512
// threads, consumers raised to 160 registers), two above (384, 240). No
// __syncthreads runs in the streaming loop; a consumer with no keys or
// rows below T returns at once, and the empty barriers count only the
// consumers that run.
// - K10b at dk 64 and 128: a block owns 64 keys a consumer, each consumer
//   all dk columns of its dK and dV in f32 registers (128 a thread at dk
//   128). K and V load once; the producer streams each 64-row query tile's
//   Q and dO by TMA and, by its first warp, the tile's lse (log2 units;
//   +inf past T, so p = 0 there) and di into the stage (4 stages), so Q
//   and dO are read once per 192 or 128 keys, and at T <= 192 (dk 64) or
//   128 a head is read once. A consumer runs S^T = K Q^T and dP^T = V dO^T
//   (A and B from shared memory), forms P^T while dP^T runs, dV += P^T dO
//   (A = bf16(P^T) from registers, dO read MN-major) while it forms dS^T,
//   then dK += dS^T Q.
// - K10b at dk 256: a block owns 64 keys, and each score is computed once:
//   the two consumers split each query tile's 64 columns of S^T and dP^T,
//   32 each (m64n32k16 chains), and write their halves of bf16 P^T and
//   dS^T to shared memory (two buffers, so one named barrier over the
//   consumers a tile orders the writes and the reads). Each consumer then
//   accumulates its own 128 columns of dV and dK (128 registers), with A =
//   P^T or dS^T read from shared memory. Shared memory: K, V 64 KB, two
//   stages of Q and dO 128 KB, P^T and dS^T 32 KB (226 KB).
// - K10a: a block owns 64 query rows a consumer, each consumer all dk
//   columns of dQ in registers (128 a thread at dk 256, beside 32 of S, 32
//   of dP and 16 of packed dS). Q and dO load once; the producer streams V
//   and K of each 64-key tile as two items of a ring of one-tile slots (V
//   first: dP frees it before dQ frees K), 3 slots at dk 256 (Q and dO take
//   128 KB), 8 below. Each score is computed once at every dk, and K and V
//   are read once per 192 or 128 rows. At dk 64 and T <= 2048 two blocks
//   of two consumers share an SM (80 registers at launch, consumers at
//   104), each taking a key tile in two halves of 32 keys (m64n32k16 S and
//   dP, dQ over the half's two k-steps), so S and dP need 16 registers
//   each: 16 consumer warps an SM, and at T <= 128 a block covers a head.
// The choices, measured (ms, CUDA events, four turns in one call, on an
// NVIDIA H100 80GB HBM3 at 700 W; scripts/port_flash_bwd_variants.py,
// which builds every variant from this file; PERF.md section 6):
// - three consumers at dk 64 (K10b; K10a past T 2048): K10b at BH 512, T
//   845 0.563-0.568 against 0.669-0.673 with two, at BH 64, T 17984
//   18.5-19.7 against 21.0-21.4; K10a at T 17984 14.8-15.1 against
//   16.6-17.1.
// - K10a at dk 64, two blocks of two halved consumers against three whole
//   ones: T 105 (BH 15616) 0.377-0.381 against 0.509-0.516, T 845 (BH
//   512) 0.336-0.346 against 0.351-0.368; at BH 64, T 1024 0.064-0.070
//   against 0.070-0.076, T 2048 0.216-0.229 against 0.221-0.235, T 4096
//   0.890-0.910 against 0.816-0.854, T 8192 3.48-3.52 against 3.10-3.28,
//   T 17984 16.3-17.2 against 15.0-15.5 (there the halves' extra waits
//   cost more than the warps gain). Four consumers (640 threads, 112
//   registers) spill and serialise their wgmma over whole tiles (T 845
//   0.594) and lose over halves (0.382-0.393 against 0.366-0.378).
// - each consumer waits for its products in turn. Issuing tile j + 1's
//   scores before tile j's last product (dK, dQ), measured with an earlier
//   form of this file, lost or tied, and is not built: K10b dk 128 (BH
//   256) 0.565 against 0.473 (ptxas serialised its wgmma for want of
//   registers), K10a dk 256 (BH 128) 0.379-0.381 against 0.309-0.313,
//   K10a at T 105 0.672-0.674 against 0.511; so did two blocks of two
//   consumers over whole tiles (spills of 384-896 bytes at 104 registers;
//   K10b 1.66, K10a 0.61 at T 845).
// - the rings: K10b at dk 256 with one stage 0.725-0.776 against
//   0.527-0.582 with two; at dk 64 two stages against four 0.574-0.583
//   against 0.563-0.568 at T 845, 19.6-20.8 against 18.5-19.7 at T 17984;
//   K10a at dk 256 with two slots 0.339-0.364 against 0.302-0.326 with
//   three; four slots against eight below dk 256 tie.
//
// What the design does about the kernels K10b and K10a were before, K6's
// bf16 bodies (attention_bwd.cu) with f32 scores: there a block was one
// warpgroup over 64 keys or rows, every thread waited on each wgmma, and
// every tile ended in a __syncthreads before thread 0 refilled two buffers,
// so loads, products and exponentials ran in turn; at dk 256 each tile ran
// as two blocks, one a half of the output columns, which both recomputed S
// and dP over all 256 columns and took every exponential (K10b 6 units of
// tensor work for 4, K10a 8 for 6); and each block streamed the other
// operand once per 64 rows.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int BT = 64;     // rows of a staged tile: keys or query rows

// consumer warpgroups a block: three at dk 64 (consumers at 160
// registers, 512 threads), else two (240, 384 threads); K10a at dk 64 and
// T <= DQ_HALF_MAX_T runs two, two blocks an SM
template <int DKP>
__host__ __device__ constexpr int consumers() { return DKP == 64 ? 3 : 2; }

// ------------------------------------------------------------- K10b: dK, dV
// keys a block owns: 64 a consumer at dk 64 and 128; 64 at dk 256, where
// the two consumers split each tile's query columns
template <int DKP, int NCONS>
__host__ __device__ constexpr int dkv_keys() {
  return DKP == 256 ? 64 : 64 * NCONS;
}

// stages of Q and dO: dk 256, 64 KB a stage, 2 (with K, V and P^T, dS^T
// 226 KB of the 227 KB); dk 128, 32 KB a stage; dk 64, 16 KB
template <int DKP>
__host__ __device__ constexpr int dkv_stages() { return DKP == 256 ? 2 : 4; }

template <int DKP, int NST, int NCONS>
constexpr size_t dkv_smem_bytes() {
  // K and V of the block's keys, NST stages of Q and dO, at dk 256 two
  // buffers of P^T and dS^T (64 x 64 each), then NST stages of the tile's
  // lse2 and di; 1024 bytes of slack to align the tiles
  return sw_tile_bytes<DKP>() * (2 * (dkv_keys<DKP, NCONS>() / 64) + 2 * NST) +
         (DKP == 256 ? 4 * sw_tile_bytes<64>() : 0) +
         sizeof(float) * 2 * BT * NST + 1024;
}

// K10b's two consumer warpgroups at dk 256 (256 threads) meet on named
// barrier 1
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One block: the keys of `dkv_keys` (the note at the head of the file)
template <int DKP, int NST, int NCONS>
__global__ void __launch_bounds__(128 * (1 + NCONS), 1)
attn_flash_bwd_dkv(bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int T, float scale,
                   const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mo) {
  constexpr bool SPLIT = DKP == 256;   // the consumers split query columns
  static_assert(!SPLIT || NCONS == 2, "dk 256 splits a tile in two halves");
  constexpr int KEYS = dkv_keys<DKP, NCONS>();
  constexpr int TILE = sw_tile_elems<DKP>();
  constexpr uint32_t TB = sw_tile_bytes<DKP>();
  constexpr int PT = sw_tile_elems<64>();   // a 64 x 64 P^T or dS^T tile
  constexpr int NS = (SPLIT ? 32 : 64) / 8;   // 8-query chunks of S^T
  constexpr int DKO = SPLIT ? 128 : DKP;  // columns of a consumer's dK, dV
  constexpr int ND = DKO / 8;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST], kvbar;
  bf16* Ks = reinterpret_cast<bf16*>(sw_align(smem_raw));  // KEYS / 64 tiles
  bf16* Vs = Ks + (KEYS / 64) * TILE;
  bf16* QD = Vs + (KEYS / 64) * TILE;   // Q, dO of stage 0, then stage 1 ...
  bf16* PS = QD + 2 * NST * TILE;       // P^T, dS^T of buffer 0, then 1
  float* LD = reinterpret_cast<float*>(PS + (SPLIT ? 4 * PT : 0));

  const TileRow tr = tile_row(T, KEYS);
  const int bh = tr.bh, kv0 = tr.t0;
  const int ntiles = (T + BT - 1) / BT;
  // consumers with keys below T
  const int nact = SPLIT ? 2 : min(NCONS, (T - kv0 + 63) / 64);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 33);   // the TMA thread's expect, 32 row writers
      bar_init(&empty[s], 4 * nact);   // one arrival a consumer warp
    }
    bar_init(&kvbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {   // ------------------------------------------- producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        const int nkt = SPLIT ? 1 : nact;   // K/V tiles below T
        mbar_expect(&kvbar, 2 * nkt * TB);
        for (int c = 0; c < nkt; ++c) {
          tma_tile<DKP>(Ks + c * TILE, mk, &kvbar, kv0 + 64 * c, bh);
          tma_tile<DKP>(Vs + c * TILE, mv, &kvbar, kv0 + 64 * c, bh);
        }
      }
      const float* lrow = lse + (size_t)bh * T;
      const float* drow = delta + (size_t)bh * T;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NST;
        // a refill waits for the consumers' release of tile j - NST
        if (j >= NST) mbar_wait(&empty[s], ((j / NST) + 1) & 1);
        if (lane == 0) {
          bf16* qd = QD + s * 2 * TILE;
          mbar_expect(&full[s], 2 * TB);
          tma_tile<DKP>(qd, mq, &full[s], j * BT, bh);
          tma_tile<DKP>(qd + TILE, mo, &full[s], j * BT, bh);
        }
        float* ld = LD + s * 2 * BT;
        for (int i = lane; i < BT; i += 32) {
          const int t = j * BT + i;
          ld[i] = t < T ? lrow[t] * LOG2E : INFINITY;
          ld[BT + i] = t < T ? drow[t] : 0.f;
        }
        bar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_inc<consumer_regs(1, NCONS)>();
  const int cw = wg - 1;
  if (cw >= nact) return;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  // S^T's rows (keys) and first query column of this consumer; its first
  // column panel of dK and dV
  const int key0 = SPLIT ? kv0 : kv0 + 64 * cw;
  const int qc0 = SPLIT ? 32 * cw : 0;
  const int p0 = SPLIT ? 2 * cw : 0;
  const bf16* Kc = Ks + (SPLIT ? 0 : cw * TILE);
  const bf16* Vc = Vs + (SPLIT ? 0 : cw * TILE);

  float acck[ND][4], accv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[dn][e] = accv[dn][e] = 0.f;
  float st[NS][4], dp[NS][4];

  auto qtile = [&](int j) -> const bf16* { return QD + (j % NST) * 2 * TILE; };
  // S^T = K Q^T and dP^T = V dO^T of query tile j, two wgmma groups
  auto issue_scores = [&](int j) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dp[nt][e] = 0.f;
    fence_regs<4 * NS>(&st[0][0]);
    fence_regs<4 * NS>(&dp[0][0]);
    mbar_wait(&full[j % NST], (j / NST) & 1);
    wgmma_fence();
    const bf16* Qs = qtile(j);
    if constexpr (SPLIT) {   // this consumer's 32 query rows of the tile
      mma_abt_n32<DKP>(&st[0][0], Kc, Qs + qc0 * 64);
      wgmma_commit();
      mma_abt_n32<DKP>(&dp[0][0], Vc, Qs + TILE + qc0 * 64);
    } else {
      mma_abt<DKP>(&st[0][0], Kc, Qs);
      wgmma_commit();
      mma_abt<DKP>(&dp[0][0], Vc, Qs + TILE);
    }
    wgmma_commit();
  };
  // P^T into st: keys past T (a ragged last block only) get 0, query rows
  // past T get 0 from lse2 = +inf
  auto make_p = [&](int j) {
    const float* lse2 = LD + (j % NST) * 2 * BT + qc0;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = fast_exp2(fmaf(st[nt][e], sl2,
                                   -lse2[nt * 8 + i2 + (e & 1)]));
    if (key0 + 64 > T) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + warp * 16 + g + 8 * (e / 2) >= T) st[nt][e] = 0.f;
    }
  };
  // dS^T into dp
  auto make_ds = [&](int j) {
    const float* dlt = LD + (j % NST) * 2 * BT + BT + qc0;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = st[nt][e] * (dp[nt][e] - dlt[nt * 8 + i2 + (e & 1)]) * scale;
  };
  // this warp is done with query tile j's stage
  auto release = [&](int j) {
    if (lane == 0) bar_arrive(&empty[j % NST]);
  };

  mbar_wait(&kvbar, 0);
  if constexpr (SPLIT) {
    for (int j = 0; j < ntiles; ++j) {
      bf16* Pb = PS + (j & 1) * 2 * PT;   // P^T, then dS^T, of buffer j % 2
      bf16* Sb = Pb + PT;
      issue_scores(j);
      wgmma_wait<1>();   // S^T is complete
      fence_regs<4 * NS>(&st[0][0]);
      make_p(j);
      // rows of P^T are keys, its columns this consumer's queries
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(Pb, warp * 16 + g + 8 * h, qc0 + nt * 8 + i2,
                     st[nt][2 * h], st[nt][2 * h + 1]);
      wgmma_wait<0>();   // dP^T is complete
      fence_regs<4 * NS>(&dp[0][0]);
      make_ds(j);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(Sb, warp * 16 + g + 8 * h, qc0 + nt * 8 + i2,
                     dp[nt][2 * h], dp[nt][2 * h + 1]);
      // both halves written and visible to wgmma; buffer j % 2 was last
      // read by tile j - 2's products, complete before either consumer
      // reached tile j - 1's barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();
      const bf16* Qs = qtile(j);
      fence_regs<4 * ND>(&accv[0][0]);
      fence_regs<4 * ND>(&acck[0][0]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < DKO / 64; ++p)
        mma_sab(&accv[8 * p][0], Pb, Qs + TILE, p0 + p);
      wgmma_commit();
#pragma unroll
      for (int p = 0; p < DKO / 64; ++p)
        mma_sab(&acck[8 * p][0], Sb, Qs, p0 + p);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<4 * ND>(&accv[0][0]);
      fence_regs<4 * ND>(&acck[0][0]);
      release(j);
    }
  } else {
    // dV += P^T dO and dK += dS^T Q with A = bf16(P^T), bf16(dS^T) from
    // registers, dO and Q read MN-major
    uint32_t pa[BT / 16][4], sa[BT / 16][4];
    auto pack = [&](uint32_t(&a)[BT / 16][4], float(&x)[NS][4]) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) pack_a(a[kk], x[2 * kk], x[2 * kk + 1]);
    };
    auto issue_dv = [&](int j) {
      fence_regs<4 * ND>(&accv[0][0]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < DKP / 64; ++p)
        mma_ab(&accv[8 * p][0], pa, qtile(j) + TILE, p);
      wgmma_commit();
    };
    auto issue_dk = [&](int j) {
      fence_regs<4 * ND>(&acck[0][0]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < DKP / 64; ++p)
        mma_ab(&acck[8 * p][0], sa, qtile(j), p);
      wgmma_commit();
    };
    for (int j = 0; j < ntiles; ++j) {
      issue_scores(j);
      wgmma_wait<1>();   // S^T is complete
      fence_regs<4 * NS>(&st[0][0]);
      make_p(j);
      pack(pa, st);
      issue_dv(j);
      wgmma_wait<1>();   // dP^T is complete; dV may run
      fence_regs<4 * NS>(&dp[0][0]);
      make_ds(j);
      pack(sa, dp);
      issue_dk(j);
      wgmma_wait<0>();
      fence_regs<4 * ND>(&accv[0][0]);
      fence_regs<4 * ND>(&acck[0][0]);
      release(j);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + warp * 16 + g + 8 * h;
    if (key >= T) continue;
    const size_t off = ((size_t)bh * T + key) * DKP + p0 * 64;
    uint32_t* krow = reinterpret_cast<uint32_t*>(dk_out + off);
    uint32_t* vrow = reinterpret_cast<uint32_t*>(dv_out + off);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {   // columns 8 dn + i2, + 1 as one word
      krow[(dn * 8 + i2) / 2] = pack_bf16(acck[dn][2 * h], acck[dn][2 * h + 1]);
      vrow[(dn * 8 + i2) / 2] = pack_bf16(accv[dn][2 * h], accv[dn][2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------ K10a: dQ
// one-tile slots of the K/V ring: dk 256, 3 (Q and dO of 128 rows take 128
// KB; 224 KB in all), the fewest that load V and K of tile j + 1 while
// tile j's dQ reads K of tile j; dk 128 and 64, 8
template <int DKP>
__host__ __device__ constexpr int dq_slots() { return DKP == 256 ? 3 : 8; }

// K10a at dk 64 up to this T: two blocks an SM of two consumers, each
// 64-key tile in two halves of 32 keys (consumers at 104 registers); past
// it, one block of three consumers over whole tiles
constexpr int DQ_HALF_MAX_T = 2048;

template <int DKP, int NSL, int NCONS>
constexpr size_t dq_smem_bytes() {
  // Q and dO of the block's rows, then the slots; 1024 bytes of slack
  return sw_tile_bytes<DKP>() * (2 * NCONS + NSL) + 1024;
}

// One block: 64 query rows a consumer (the note at the head of the file)
template <int DKP, int NSL, int NCONS, int MINB = 1, bool HALF = false>
__global__ void __launch_bounds__(128 * (1 + NCONS), MINB)
attn_flash_bwd_dq(bf16* __restrict__ dq_out, const float* __restrict__ lse,
                  const float* __restrict__ delta, int T, float scale,
                  const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mo) {
  constexpr int TILE = sw_tile_elems<DKP>();
  constexpr uint32_t TB = sw_tile_bytes<DKP>();
  constexpr int KH = HALF ? 32 : BT;   // keys of a score chunk
  constexpr int NS = KH / 8;      // 8-key column chunks of S
  constexpr int ND = DKP / 8;     // 8-wide column chunks of dQ
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NSL], empty[NSL], qbar;
  bf16* Qs = reinterpret_cast<bf16*>(sw_align(smem_raw));   // NCONS Q tiles
  bf16* dOs = Qs + NCONS * TILE;  // NCONS dO tiles
  bf16* KV = dOs + NCONS * TILE;  // the slots: item 2j V, 2j + 1 K of tile j

  const TileRow tr = tile_row(T, 64 * NCONS);
  const int bh = tr.bh, q0 = tr.t0;
  const int ntiles = (T + BT - 1) / BT;
  // consumers with rows below T
  const int nact = min(NCONS, (T - q0 + 63) / 64);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSL; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * nact);   // one arrival a consumer warp
    }
    bar_init(&qbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {   // ------------------------------------------- producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect(&qbar, 2 * nact * TB);
      for (int c = 0; c < nact; ++c) {
        tma_tile<DKP>(Qs + c * TILE, mq, &qbar, q0 + 64 * c, bh);
        tma_tile<DKP>(dOs + c * TILE, mo, &qbar, q0 + 64 * c, bh);
      }
      for (int n = 0; n < 2 * ntiles; ++n) {
        const int s = n % NSL;
        // a refill waits for the consumers' release of item n - NSL
        if (n >= NSL) mbar_wait(&empty[s], ((n / NSL) + 1) & 1);
        mbar_expect(&full[s], TB);
        tma_tile<DKP>(KV + s * TILE, (n & 1) ? mk : mv, &full[s], (n / 2) * BT,
                      bh);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_inc<consumer_regs(MINB, NCONS)>();
  const int cw = wg - 1;          // this consumer's 64 rows: q0 + 64 cw
  if (cw >= nact) return;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  const float sl2 = scale * LOG2E;
  const bf16* Qc = Qs + cw * TILE;
  const bf16* dOc = dOs + cw * TILE;
  // rows g and g + 8 of this warp: lse in log2 units and di
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * cw + warp * 16 + g + 8 * h;
    lse2[h] = row < T ? lse[(size_t)bh * T + row] * LOG2E : 0.f;
    dlt[h] = row < T ? delta[(size_t)bh * T + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float s[NS][4], dp[NS][4];
  uint32_t sa[KH / 16][4];

  auto slot = [&](int n) -> const bf16* { return KV + (n % NSL) * TILE; };
  // this warp is done with item n
  auto release = [&](int n) {
    if (lane == 0) bar_arrive(&empty[n % NSL]);
  };
  // S = Q K^T and dP = dO V^T of keys KH h .. KH h + KH - 1 of key tile j,
  // two wgmma groups
  auto issue_scores = [&](int j, int h) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    fence_regs<4 * NS>(&s[0][0]);
    fence_regs<4 * NS>(&dp[0][0]);
    mbar_wait(&full[(2 * j + 1) % NSL], ((2 * j + 1) / NSL) & 1);
    mbar_wait(&full[(2 * j) % NSL], ((2 * j) / NSL) & 1);
    wgmma_fence();
    if constexpr (HALF) {
      mma_abt_n32<DKP>(&s[0][0], Qc, slot(2 * j + 1) + h * KH * 64);
      wgmma_commit();
      mma_abt_n32<DKP>(&dp[0][0], dOc, slot(2 * j) + h * KH * 64);
    } else {
      mma_abt<DKP>(&s[0][0], Qc, slot(2 * j + 1));
      wgmma_commit();
      mma_abt<DKP>(&dp[0][0], dOc, slot(2 * j));
    }
    wgmma_commit();
  };
  // P into s: keys past T (the last tile only) get 0
  auto make_p = [&](int j, int h) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = fast_exp2(fmaf(s[nt][e], sl2, -lse2[e / 2]));
    const int k0 = j * BT + h * KH;
    if (k0 + KH > T) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + i2 + (e & 1) >= T) s[nt][e] = 0.f;
    }
  };
  // dS into dp
  auto make_ds = [&]() {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[nt][e] = s[nt][e] * (dp[nt][e] - dlt[e / 2]) * scale;
  };
  // dS packed to bf16: dQ's A operand
  auto pack_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < KH / 16; ++kk) pack_a(sa[kk], dp[2 * kk], dp[2 * kk + 1]);
  };
  // dQ += dS K: A from registers, K read MN-major (rows are keys)
  auto issue_dq = [&](int j, int h) {
    fence_regs<4 * ND>(&acc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < DKP / 64; ++p)
      mma_ab(&acc[8 * p][0], sa, slot(2 * j + 1), p, h * KH / 16);
    wgmma_commit();
  };

  mbar_wait(&qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
#pragma unroll
    for (int h = 0; h < BT / KH; ++h) {
      issue_scores(j, h);
      wgmma_wait<1>();   // S is complete
      fence_regs<4 * NS>(&s[0][0]);
      make_p(j, h);
      wgmma_wait<0>();   // dP is complete
      fence_regs<4 * NS>(&dp[0][0]);
      if (h == BT / KH - 1) release(2 * j);   // V of tile j
      make_ds();
      pack_ds();
      issue_dq(j, h);
      wgmma_wait<0>();
      fence_regs<4 * ND>(&acc[0][0]);
    }
    release(2 * j + 1);   // K of tile j
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * cw + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    uint32_t* orow =
        reinterpret_cast<uint32_t*>(dq_out + ((size_t)bh * T + row) * DKP);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)   // columns 8 dn + i2, + 1 as one word
      orow[(dn * 8 + i2) / 2] = pack_bf16(acc[dn][2 * h], acc[dn][2 * h + 1]);
  }
}

// ------------------------------------------------------------------ launches
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int BH, T, dkdim;
  float scale;
  cudaStream_t stream;
};

// the tensor maps of q, k, v and dO (they hold the pointers: per call)
struct Maps {
  CUtensorMap q, k, v, o;
};

int encode_maps(Maps& m, const Args& a) {
  int err = encode_tile_map(&m.q, a.q, a.BH, a.T, a.dkdim);
  if (!err) err = encode_tile_map(&m.k, a.k, a.BH, a.T, a.dkdim);
  if (!err) err = encode_tile_map(&m.v, a.v, a.BH, a.T, a.dkdim);
  if (!err) err = encode_tile_map(&m.o, a.dout, a.BH, a.T, a.dkdim);
  return err;
}

// the delta pass, then K10b
template <int DKP, int NST = dkv_stages<DKP>(), int NCONS = consumers<DKP>()>
int launch_dkv(const Args& a) {
  int err = launch_delta<bf16>(a.o, a.dout, a.delta, a.BH * a.T, DKP,
                               a.stream);
  if (err) return err;
  Maps m{};
  if ((err = encode_maps(m, a))) return err;
  const size_t bytes = dkv_smem_bytes<DKP, NST, NCONS>();
  const cudaError_t e = cudaFuncSetAttribute(
      attn_flash_bwd_dkv<DKP, NST, NCONS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attn_flash_bwd_dkv<DKP, NST, NCONS>
      <<<tile_grid(a.BH, a.T, dkv_keys<DKP, NCONS>()), 128 * (1 + NCONS),
         bytes, a.stream>>>(static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
                     a.lse, a.delta, a.T, a.scale, m.q, m.k, m.v, m.o);
  return (int)cudaGetLastError();
}

template <int DKP, int NSL = dq_slots<DKP>(), int NCONS = consumers<DKP>(),
          int MINB = 1, bool HALF = false>
int launch_dq(const Args& a) {
  Maps m{};
  const int err = encode_maps(m, a);
  if (err) return err;
  const size_t bytes = dq_smem_bytes<DKP, NSL, NCONS>();
  const cudaError_t e = cudaFuncSetAttribute(
      attn_flash_bwd_dq<DKP, NSL, NCONS, MINB, HALF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attn_flash_bwd_dq<DKP, NSL, NCONS, MINB, HALF>
      <<<tile_grid(a.BH, a.T, 64 * NCONS), 128 * (1 + NCONS), bytes,
         a.stream>>>(
          static_cast<bf16*>(a.dq), a.lse, a.delta, a.T, a.scale, m.q, m.k,
          m.v, m.o);
  return (int)cudaGetLastError();
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

// dk in {64, 128, 256}; q, k, v, dO 16-byte aligned (TMA stages every
// tile); the outputs, written a bf16 pair at a time, 4-byte aligned
bool takes(const Args& a) {
  return (a.dkdim == 64 || a.dkdim == 128 || a.dkdim == 256) &&
         tma_fits(a.q, a.dkdim) && tma_fits(a.k, a.dkdim) &&
         tma_fits(a.v, a.dkdim) && tma_fits(a.dout, a.dkdim) &&
         (a.dq == nullptr || aligned4(a.dq)) &&
         (a.dk == nullptr || aligned4(a.dk)) &&
         (a.dv == nullptr || aligned4(a.dv));
}

Args dkv_args(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dk,
              void* dv, int BH, int T, int dkdim, float scale, void* stream) {
  return Args{q, k, v, o, dout, static_cast<const float*>(lse),
              static_cast<float*>(delta), nullptr, dk, dv, BH, T, dkdim,
              scale, static_cast<cudaStream_t>(stream)};
}

Args dq_args(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int BH, int T,
             int dkdim, float scale, void* stream) {
  return Args{q, k, v, nullptr, dout, static_cast<const float*>(lse),
              const_cast<float*>(static_cast<const float*>(delta)), dq,
              nullptr, nullptr, BH, T, dkdim, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// All tensors (BH, T, dk) bf16, contiguous, dk in {64, 128, 256}; q, k, v,
// dout 16-byte aligned; lse and delta (BH, T) f32. The caller checks BH * T
// < 2^31.
//
// K10b: di = sum(o * dO) of each row into delta, then dK and dV.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* delta, void* dk,
                             void* dv, int BH, int T, int dkdim, float scale,
                             void* stream) {
  const Args a = dkv_args(q, k, v, o, dout, lse, delta, dk, dv, BH, T, dkdim,
                          scale, stream);
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  switch (dkdim) {
    case 64: return launch_dkv<64>(a);
    case 128: return launch_dkv<128>(a);
    default: return launch_dkv<256>(a);
  }
}

// K10a: dQ, from the delta that K10b wrote.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BH, int T,
                            int dkdim, float scale, void* stream) {
  const Args a = dq_args(q, k, v, dout, lse, delta, dq, BH, T, dkdim, scale,
                         stream);
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  switch (dkdim) {
    case 64:
      return a.T <= DQ_HALF_MAX_T ? launch_dq<64, 8, 2, 2, true>(a)
                                  : launch_dq<64>(a);
    case 128: return launch_dq<128>(a);
    default: return launch_dq<256>(a);
  }
}

#ifdef FLASH_BWD_VARIANTS
// The design's other choices, for scripts/port_flash_bwd_variants.py
// (built with -DFLASH_BWD_VARIANTS=1 for K10b's, =2 for K10a's, never into
// the package's library): the stages (K10b) or slots (K10a) of the ring,
// and the consumer warpgroups a block at dk 64. A combination not listed
// returns cudaErrorInvalidValue.
#define FLASH_BWD_CASE(L, D, S, C) \
  if (a.dkdim == D && ring == S && ncons == C) return L<D, S, C>(a);
#if FLASH_BWD_VARIANTS == 1
extern "C" int flash_bwd_dkv_variant(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* delta, void* dk, void* dv, int BH,
                                     int T, int dkdim, float scale,
                                     void* stream, int ring, int ncons) {
  const Args a = dkv_args(q, k, v, o, dout, lse, delta, dk, dv, BH, T, dkdim,
                          scale, stream);
  if (!takes(a)) return (int)cudaErrorInvalidValue;
  FLASH_BWD_CASE(launch_dkv, 64, 4, 2)
  FLASH_BWD_CASE(launch_dkv, 64, 4, 3)
  FLASH_BWD_CASE(launch_dkv, 64, 2, 3)
  FLASH_BWD_CASE(launch_dkv, 128, 4, 2)
  FLASH_BWD_CASE(launch_dkv, 128, 2, 2)
  FLASH_BWD_CASE(launch_dkv, 256, 2, 2)
  FLASH_BWD_CASE(launch_dkv, 256, 1, 2)
  return (int)cudaErrorInvalidValue;
}
#else
extern "C" int flash_bwd_dq_variant(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int BH, int T, int dkdim,
                                    float scale, void* stream, int ring,
                                    int ncons, int blocks, int half) {
  const Args a = dq_args(q, k, v, dout, lse, delta, dq, BH, T, dkdim, scale,
                         stream);
  if (!takes(a)) return (int)cudaErrorInvalidValue;
#define FLASH_DQ_CASE(D, S, C, B, H)                                   \
  if (a.dkdim == D && ring == S && ncons == C && blocks == B && half == H) \
    return launch_dq<D, S, C, B, (H != 0)>(a);
  FLASH_DQ_CASE(64, 8, 2, 1, 0)
  FLASH_DQ_CASE(64, 8, 3, 1, 0)
  FLASH_DQ_CASE(64, 4, 3, 1, 0)
  FLASH_DQ_CASE(64, 8, 3, 1, 1)
  FLASH_DQ_CASE(64, 8, 2, 2, 1)
  FLASH_DQ_CASE(64, 8, 4, 1, 1)
  if (blocks != 1 || half) return (int)cudaErrorInvalidValue;
  FLASH_BWD_CASE(launch_dq, 128, 8, 2)
  FLASH_BWD_CASE(launch_dq, 128, 4, 2)
  FLASH_BWD_CASE(launch_dq, 256, 3, 2)
  FLASH_BWD_CASE(launch_dq, 256, 2, 2)
  return (int)cudaErrorInvalidValue;
}
#endif
#endif
