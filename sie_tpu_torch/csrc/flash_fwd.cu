// K9: the forward of the JAX package's stock flash attention,
// out = softmax(scale * Q K^T) V and its row log-sum-exp, for q, k, v of
// shape (BH, T, dk) in bf16, dk in {64, 128, 256}, any T.
//
// Replaces jax/experimental/pallas/ops/tpu/flash_attention.py:758
// (`_flash_attention_impl` :589, body `_flash_attention_kernel_single_batch`
// :342), which sie_tpu/models/layers.py:119 (`FullAttentionLayer._flash`)
// calls under `use_flash_attention`.
//
// Numerics, the stock kernel's: s = Q K^T accumulates in f32 from bf16 and
// is scaled in f32, never rounded to bf16; the softmax is online over
// 64-key tiles (running max m and sum l in f32), each tile's unnormalised
// p = exp(s - m) rounded to bf16 for P V, which accumulates in f32; the
// output is divided by l and rounded to bf16 once. Keys at or past T are
// masked in the last key tile only. In place of the stock kernel's m and l
// it writes each row's natural log-sum-exp (BH, T) f32, which K10b and
// K10a (flash_bwd.cu) read.
//
// What bounds it on an H100: the two products are 4*BH*T^2*dk FLOP on the
// bf16 tensor cores (989 TFLOP/s) against 4*BH*T*dk*2 bytes of q, k, v and
// out and 4*BH*T of the log-sum-exp (3.35 TB/s). Past T ~ 128 (dk 64) the
// operations bound: 0.0946 ms at BH 512, T 845, dk 64, at BH 256 dk 128 and
// at BH 128 dk 256; 5.358 ms at BH 64, T 17984. At PatchTST's chunk (BH
// 15616, T 105, dk 64) the bytes bound: 0.2526 ms.
//
// Design. A block has three warpgroups and owns 128 query rows of one
// head; the grid is BH x ceil(T / 128) blocks (`tile_grid`).
// - Warpgroup 0 is the producer: `setmaxnreg` lowers it to 24 registers a
//   thread, and one of its threads issues every TMA load: the block's two
//   64-row Q tiles once, then K and V of each 64-key tile into a ring of
//   NST stages (attention_common.cuh's 128-byte-swizzled tiles, one TMA
//   box a 64-column panel: four a tile at dk 256). Each stage has a "full"
//   mbarrier, on which TMA counts the stage's bytes, and an "empty" one, on
//   which each consumer warp arrives once its P V wgmma on that stage has
//   completed; the producer refills a stage after it empties. Rows and keys
//   past T are TMA's zero fill; rows past T are never written.
// - Warpgroups 1 and 2 are the consumers, 64 query rows each. Each keeps
//   all dk columns of its 64 rows of O in f32 registers (128 a thread at dk
//   256, beside 32 of scores and 16 of packed probabilities: `setmaxnreg`
//   raises them to 240, to 104 at dk 64 below), so every score is computed once at every dk: S =
//   Q K^T is one m64n64k16 wgmma chain a tile (A = Q, B = K, both from
//   shared memory), O += P V a chain with A = P from registers and B = V
//   read MN-major. No __syncthreads runs in the key loop. A consumer whose
//   rows all lie past T (the last block, T - q0 <= 64) returns at once, and
//   the empty barriers count only the consumers that run.
// - dk 64: two blocks an SM, the consumers at 104 registers. One block an
//   SM leaves 8 consumer warps to hide the softmax's latency
//   (exponentials, shuffles, the wait on each wgmma), where K5's body runs
//   16 (four 64-row blocks): 0.350 ms at the flagship's attention (BH
//   512, T 845) against 0.260 with two blocks, 0.470 against 0.311 at
//   PatchTST's chunk, 14.0-14.5 against 11.3-11.6 at BH 64, T 17984.
// - dk 128: a consumer issues tile j + 1's S = Q K^T before tile j's P V,
//   waits for the scores only (wgmma.wait_group 1) and runs tile j + 1's
//   softmax while the tensor cores work on tile j's P V: 0.234 ms against
//   0.242 without (BH 256, T 845). At dk 256 the overlap loses, 0.292 ms
//   against 0.201 (BH 128): with two stages, tile j + 1's load can start
//   only once tile j - 1's P V is done, inside tile j's softmax. At dk 64
//   its live registers spill at 104 (48 bytes; 0.286 ms against 0.260).
//   (Times: scripts/port_flash_variants.py, which builds every variant from
//   this file, on an NVIDIA H100 80GB HBM3 at 700 W.)
//
// What the design does about the kernel K9 was before, K5's bf16 body (one
// warpgroup over 64 rows, two K/V buffers): there every thread waited on
// each wgmma and every tile ended in a __syncthreads, so loads, QK^T,
// softmax and P V ran in turn; here the producer keeps NST stages in flight,
// and at dk 128 the softmax overlaps the previous tile's P V. There a block
// held at most 128 output columns, so at dk 256 each 64-row tile ran as two
// blocks that both computed the whole row of scores (1.5x the tensor work);
// here one block holds all 256. There K and V were read once per 64 query
// rows; here once per 128, so at T <= 128 (PatchTST's T 105) one block
// covers the head and every byte of Q, K and V is read once. The old
// kernel against this one, ms, two runs each in one call on an NVIDIA
// H100 80GB HBM3 at 700 W (scripts/port_profile_kernels.py --kernels
// flash): BH 512, T 845, dk 64 0.275-0.282 against 0.259-0.260; dk 128
// (BH 256) 0.292-0.294 against 0.235-0.237; dk 256 (BH 128) 0.528-0.529
// against 0.205-0.209; PatchTST's chunk 0.470-0.471 against 0.310; BH 64,
// T 17984 11.35-11.57 against 11.41-11.57 (48 % of the bf16 peak). PERF.md
// section 6 has the newest.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int BQ = 128;       // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 384; // producer warpgroup + two consumers

// K/V stages of the ring: dk 256, Q 64 KB + 64 KB a stage, 2 stages (192
// KB of the 227 KB); dk 128, 32 KB + 32 KB a stage; dk 64, 16 + 16 KB
template <int DKP>
__host__ __device__ constexpr int stages() { return DKP == 256 ? 2 : 4; }

// blocks an SM: two at dk 64 (81 KB of shared memory each; 80 registers a
// thread at launch), else one (168 at launch)
template <int DKP>
__host__ __device__ constexpr int blocks_per_sm() { return DKP == 64 ? 2 : 1; }

// tile j + 1's S issued before tile j's P V: only where it measured faster
// (dk 128). At dk 256 the two stages starve (the stage of tile j is freed
// only after tile j + 1's scores are issued), at dk 64 the overlap's live
// registers spill at 104
template <int DKP>
__host__ __device__ constexpr bool overlap() { return DKP == 128; }

template <int DKP>
constexpr size_t smem_bytes() {
  // two Q tiles, then K and V of each stage; 1024 bytes of slack to align
  return sw_tile_bytes<DKP>() * (2 + 2 * stages<DKP>()) + 1024;
}

// Online softmax of one 64 x 64 score tile in a consumer's registers (rows
// g and g + 8 of each warp's 16, columns 8 nt + i2 + e): masks keys at or
// past T, updates m (log2 units of the scaled scores) and this lane's
// share of l, leaves p = exp2(s sl2 - m) in s and the factor of the old
// rows in alpha
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], int k0, int T,
                                             int i2, float sl2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // the scale goes into the exponent's FMA: max of s sl2 is sl2 max s
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
}

// One block: 128 query rows of one head (the note at the head of the
// file); OVERLAP and MINB as `overlap` and `blocks_per_sm` choose them
template <int DKP, bool LSE, bool OVERLAP, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB)
attn_flash_fwd(bf16* __restrict__ o, float* __restrict__ lse, int T,
               float scale, const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv) {
  constexpr int NST = stages<DKP>();
  constexpr int TILE = sw_tile_elems<DKP>();
  constexpr uint32_t TB = sw_tile_bytes<DKP>();
  constexpr int NS = BK / 8;      // 8-key column chunks of the scores
  constexpr int ND = DKP / 8;     // 8-wide column chunks of the output
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST], qbar;
  bf16* Qs = reinterpret_cast<bf16*>(sw_align(smem_raw));   // two Q tiles
  bf16* KVs = Qs + 2 * TILE;      // K, V of stage 0, then of stage 1, ...

  const TileRow tr = tile_row(T, BQ);
  const int bh = tr.bh, q0 = tr.t0;
  const int ntiles = (T + BK - 1) / BK;
  const int nact = T - q0 > 64 ? 2 : 1;   // consumers with rows below T
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
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
      mbar_expect(&qbar, nact * TB);
      for (int c = 0; c < nact; ++c)
        tma_tile<DKP>(Qs + c * TILE, mq, &qbar, q0 + 64 * c, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NST;
        // a refill waits for the consumers' release of tile j - NST
        if (j >= NST) mbar_wait(&empty[s], ((j / NST) + 1) & 1);
        bf16* kv = KVs + s * 2 * TILE;
        mbar_expect(&full[s], 2 * TB);
        tma_tile<DKP>(kv, mk, &full[s], j * BK, bh);
        tma_tile<DKP>(kv + TILE, mv, &full[s], j * BK, bh);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  regs_inc<consumer_regs(MINB)>();
  const int cw = wg - 1;          // this consumer's 64 rows: q0 + 64 cw
  if (cw >= nact) return;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, i2 = (lane % 4) * 2;
  // scores in log2 units: exp(x * scale - m) = exp2(x * sl2 - m2)
  const float sl2 = scale * LOG2E;
  const bf16* Qc = Qs + cw * TILE;

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float s[NS][4];
  uint32_t pa[BK / 16][4];

  // S = Q K^T of tile j, into zeroed score registers
  auto issue_s = [&](int j) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    fence_regs<4 * NS>(&s[0][0]);
    mbar_wait(&full[j % NST], (j / NST) & 1);
    wgmma_fence();
    mma_abt<DKP>(&s[0][0], Qc, KVs + (j % NST) * 2 * TILE);
    wgmma_commit();
  };
  // O += P V of tile j, all dk columns
  auto issue_pv = [&](int j) {
#pragma unroll
    for (int p = 0; p < DKP / 64; ++p)
      mma_ab(&acc[8 * p][0], pa, KVs + (j % NST) * 2 * TILE + TILE, p);
    wgmma_commit();
  };
  // this warp is done with tile j's stage
  auto release = [&](int j) {
    if (lane == 0) bar_arrive(&empty[j % NST]);
  };
  // the old rows scaled by alpha; P packed to bf16 as P V's A operand
  auto rescale_pack = [&]() {
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e / 2];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
  };

  mbar_wait(&qbar, 0);
  if (!OVERLAP) {
    for (int j = 0; j < ntiles; ++j) {
      issue_s(j);
      wgmma_wait_all();
      fence_regs<4 * NS>(&s[0][0]);
      softmax_tile(s, j * BK, T, i2, sl2, m, l, alpha);
      rescale_pack();
      fence_regs<4 * ND>(&acc[0][0]);
      wgmma_fence();
      issue_pv(j);
      wgmma_wait_all();
      fence_regs<4 * ND>(&acc[0][0]);
      release(j);
    }
  } else {
    issue_s(0);
    wgmma_wait_all();
    fence_regs<4 * NS>(&s[0][0]);
    softmax_tile(s, 0, T, i2, sl2, m, l, alpha);
    rescale_pack();
    for (int j = 1; j < ntiles; ++j) {
      fence_regs<4 * ND>(&acc[0][0]);
      issue_s(j);         // tile j's scores, then tile j - 1's P V
      issue_pv(j - 1);
      wgmma_wait_one();   // the scores have landed; P V may still run
      fence_regs<4 * NS>(&s[0][0]);
      softmax_tile(s, j * BK, T, i2, sl2, m, l, alpha);
      wgmma_wait_all();
      fence_regs<4 * ND>(&acc[0][0]);
      release(j - 1);
      rescale_pack();
    }
    fence_regs<4 * ND>(&acc[0][0]);
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_wait_all();
    fence_regs<4 * ND>(&acc[0][0]);
    release(ntiles - 1);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t base = (size_t)bh * T * DKP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * cw + warp * 16 + g + 8 * h;
    if (row >= T) continue;
    const float inv = 1.f / l[h];
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + base + (size_t)row * DKP);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)   // columns 8 dn + i2, + 1 as one word
      orow[(dn * 8 + i2) / 2] =
          pack_bf16(acc[dn][2 * h] * inv, acc[dn][2 * h + 1] * inv);
    if (LSE && i2 == 0)
      lse[(size_t)bh * T + row] = (m[h] + log2f(l[h])) * LN2;
  }
}

template <int DKP, bool LSE, bool OVERLAP = overlap<DKP>(),
          int MINB = blocks_per_sm<DKP>()>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int T, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DKP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_flash_fwd<DKP, LSE, OVERLAP, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq{}, mk{}, mv{};   // the maps hold the pointers: per call
  int e = encode_tile_map(&mq, q, BH, T, DKP);
  if (!e) e = encode_tile_map(&mk, k, BH, T, DKP);
  if (!e) e = encode_tile_map(&mv, v, BH, T, DKP);
  if (e) return e;
  attn_flash_fwd<DKP, LSE, OVERLAP, MINB>
      <<<tile_grid(BH, T, BQ), NTHREADS, bytes, stream>>>(
          static_cast<bf16*>(o), lse, T, scale, mq, mk, mv);
  return (int)cudaGetLastError();
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int BH, int T, int dk, float scale,
             cudaStream_t st) {
  switch (dk) {
    case 64: return launch<64, LSE>(q, k, v, o, lse, BH, T, scale, st);
    case 128: return launch<128, LSE>(q, k, v, o, lse, BH, T, scale, st);
    default: return launch<256, LSE>(q, k, v, o, lse, BH, T, scale, st);
  }
}

bool takes(const void* q, const void* k, const void* v, const void* o,
           int dk) {
  return (dk == 64 || dk == 128 || dk == 256) && tma_fits(q, dk) &&
         tma_fits(k, dk) && tma_fits(v, dk) &&
         reinterpret_cast<uintptr_t>(o) % 4 == 0;
}

}  // namespace

// q, k, v, o (BH, T, dk) bf16, contiguous, q, k, v 16-byte aligned (TMA
// stages every tile), dk in {64, 128, 256}; lse (BH, T) f32 or null. The
// caller checks BH * T < 2^31.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int BH, int T, int dk,
                         float scale, void* stream) {
  if (!takes(q, k, v, o, dk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return l != nullptr ? dispatch<true>(q, k, v, o, l, BH, T, dk, scale, st)
                      : dispatch<false>(q, k, v, o, l, BH, T, dk, scale, st);
}

#ifdef FLASH_FWD_VARIANTS
// The design's other choices, with the log-sum-exp, for
// scripts/port_flash_variants.py (built with -DFLASH_FWD_VARIANTS, never
// into the package's library): overlap on or off, and at dk 64 one block
// an SM (consumers at 240 registers) or two. Overlap off and one block at
// every dk is the design without either step.
extern "C" int flash_fwd_variant(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int BH, int T, int dk,
                                 float scale, void* stream, int overlap_on,
                                 int two_blocks) {
  if (!takes(q, k, v, o, dk) || lse == nullptr || (two_blocks && dk != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int key = dk * 4 + (overlap_on ? 2 : 0) + (two_blocks ? 1 : 0);
  switch (key) {
    case 256: return launch<64, true, false, 1>(q, k, v, o, l, BH, T, scale, st);
    case 258: return launch<64, true, true, 1>(q, k, v, o, l, BH, T, scale, st);
    case 257: return launch<64, true, false, 2>(q, k, v, o, l, BH, T, scale, st);
    case 259: return launch<64, true, true, 2>(q, k, v, o, l, BH, T, scale, st);
    case 512: return launch<128, true, false, 1>(q, k, v, o, l, BH, T, scale, st);
    case 514: return launch<128, true, true, 1>(q, k, v, o, l, BH, T, scale, st);
    case 1024: return launch<256, true, false, 1>(q, k, v, o, l, BH, T, scale, st);
    default: return launch<256, true, true, 1>(q, k, v, o, l, BH, T, scale, st);
  }
}
#endif
