// K5: forward of full softmax attention, out = softmax(scale * Q K^T) V,
// for q, k, v of shape (BH, T, dk), dk <= 128, in bf16 or float32.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// sie_tpu/ops/pallas/attention_pallas.py (launched by `_attn_fwd_impl`,
// entry `fused_attention`), without dropout (rate 0).
//
// Numerics follow that kernel's `_score_block`: Q K^T accumulates in f32;
// with bf16 inputs the raw scores are rounded to bf16 before the scale;
// keys at or past T are masked with -1e30; the softmax runs in f32; the
// probabilities are rounded to v's type for the P V product, which
// accumulates in f32. One difference: the softmax here is online (running
// max and sum over key tiles), so the bf16 probabilities are rounded before
// the division by the row sum, not after it.
//
// What bounds it on an H100: at the flagship shape (BH=512, T=845, dk=64)
// the two products are 4*BH*T^2*dk = 9.4e10 FLOP against ~0.2 GB of q, k,
// v and output, so it is bound by the tensor cores' arithmetic. The TPU
// kernel held one whole 845-key score row per query block in VMEM; on
// Hopper a 64 x 896 f32 score tile alone exceeds a block's 227 KB of shared
// memory, so this kernel walks 64-key tiles with an online softmax.
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
// Design, f32: tensor cores would give TF32, not f32, so the f32 kernel
// uses FP32 FMAs: four threads per query row split dk, reduce each score
// with two shuffles, and run the same online softmax over 32-key tiles held
// in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------- bf16 path
constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // keys per tile
constexpr int NWARP = 4;    // warps per block, 16 query rows each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without a register round trip; src_bytes 0
// zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// c (16x8, f32) += a (16x16, bf16, row-major) * b (16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [t0, t0 + 64) of a (T, dk) matrix into a 64 x DKP tile with row
// stride DKP + 8 (16-byte rows, and ldmatrix's eight row reads of a phase
// fall in distinct banks); zero past T and past dk. When dk == DKP and the
// matrix is 16-byte aligned the copy is asynchronous (cp.async, 8 bf16 at
// a time; the caller commits and waits), else it is done here.
template <int DKP>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int t0,
                          int T, int dk) {
  constexpr int LDH = DKP + 8;
  const bool vec = dk == DKP && (reinterpret_cast<uintptr_t>(src) % 16) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < 64 * DKP / 8; i += blockDim.x) {
      const int rr = i / (DKP / 8), cc = (i % (DKP / 8)) * 8;
      const int t = t0 + rr;
      cp_async16(dst + rr * LDH + cc, src + (size_t)min(t, T - 1) * dk + cc,
                 t < T ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * DKP; i += blockDim.x) {
      const int rr = i / DKP, cc = i % DKP;
      const int t = t0 + rr;
      dst[rr * LDH + cc] = (t < T && cc < dk) ? src[(size_t)t * dk + cc]
                                              : __float2bfloat16(0.f);
    }
  }
}

template <int DKP>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * 5 * 64 * (DKP + 8);   // Q, and two K and V tiles
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + i. The f32
// accumulator c of a 16 x 8 tile holds (row g, cols 2i, 2i+1) in c[0..1]
// and (row g + 8, same cols) in c[2..3]. The A operand (16 x 16) holds
// (row g, cols 2i..2i+1), (row g + 8, cols 2i..), (row g, cols 2i+8..),
// (row g + 8, cols 2i+8..); the B operand (16 x 8) holds (rows 2i..2i+1,
// col g) and (rows 2i+8.., col g).
template <int DKP>
__global__ void __launch_bounds__(NWARP * 32)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int T, int dk,
              float scale) {
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
  const float sl2 = scale * 1.4426950408889634f;

  const size_t base = (size_t)blockIdx.y * T * dk;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (T + BK - 1) / BK;
  load_tile<DKP>(Qs, q + base, q0, T, dk);
  cp_async_commit();
  load_tile<DKP>(KVs, k + base, 0, T, dk);
  load_tile<DKP>(KVs + TILE, v + base, 0, T, dk);
  cp_async_commit();
  cp_async_wait_one();   // Q has landed
  __syncthreads();

  // this warp's Q rows as A fragments: matrix r of the x4 load is rows
  // (r % 2) * 8 .. +7, cols (r / 2) * 8 .. +7 of the 16 x 16 k-step
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + lane % 16) * LDH + kk * 16 + (lane / 16) * 8);

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

    // scores: B = K^T, so B fragments are rows of K; one x4 load gives
    // those of key tiles nt and nt + 1 for one k-step
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
        ldsm_x4(b, Ks + ((nt + lane / 16) * 8 + lane % 8) * LDH + kk * 16 + ((lane / 8) % 2) * 8);
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
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e / 2];

    // P V: the accumulators of score tiles 2kk and 2kk+1 are the A operand
    // of key step kk; V fragments by ldmatrix.trans (rows are keys), one
    // x4 load for output tiles dn and dn + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (kk * 16 + lane % 16) * LDH + (dn + lane / 16) * 8);
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
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int FQ = 64;         // query rows per block
constexpr int FK = 32;         // keys per tile
constexpr int FTHREADS = 4 * FQ;

template <int DKP>
__global__ void __launch_bounds__(FTHREADS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int T, int dk,
             float scale) {
  constexpr int DS = DKP / 4;           // dims per thread: part + 4 * i
  __shared__ float Ks[FK][DKP];
  __shared__ float Vs[FK][DKP];
  const int part = threadIdx.x & 3;
  const int row = blockIdx.x * FQ + (threadIdx.x >> 2);
  const size_t base = (size_t)blockIdx.y * T * dk;

  float qr[DS], acc[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const int d = part + 4 * i;
    qr[i] = (row < T && d < dk) ? q[base + (size_t)row * dk + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += FK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FK * DKP; i += FTHREADS) {
      const int rr = i / DKP, cc = i % DKP;
      const int t = k0 + rr;
      const bool ok = t < T && cc < dk;
      Ks[rr][cc] = ok ? k[base + (size_t)t * dk + cc] : 0.f;
      Vs[rr][cc] = ok ? v[base + (size_t)t * dk + cc] : 0.f;
    }
    __syncthreads();

    float sc[FK];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DS; ++i) dot = fmaf(qr[i], Ks[j][part + 4 * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      sc[j] = (k0 + j < T) ? dot * scale : NEG;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DS; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = expf(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < DS; ++i) acc[i] = fmaf(p, Vs[j][part + 4 * i], acc[i]);
    }
    m = m_new;
  }

  if (row < T) {
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const int d = part + 4 * i;
      if (d < dk) o[base + (size_t)row * dk + d] = acc[i] / l;
    }
  }
}

template <int DKP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int T, int dk, float scale, cudaStream_t stream) {
  const size_t bytes = bf16_smem_bytes<DKP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16<DKP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, BH);
  attn_fwd_bf16<DKP><<<grid, NWARP * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), T, dk, scale);
  return (int)cudaGetLastError();
}

template <int DKP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int T, int dk, float scale, cudaStream_t stream) {
  const dim3 grid((T + FQ - 1) / FQ, BH);
  attn_fwd_f32<DKP><<<grid, FTHREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), T, dk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (BH, T, dk) contiguous on the device, bf16 when is_bf16 else
// float32. The caller checks 1 <= dk <= 128 and BH <= 65535.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int BH, int T, int dk, float scale,
                             int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dkp = dk <= 16 ? 16 : dk <= 32 ? 32 : dk <= 64 ? 64 : 128;
  if (dk < 1 || dk > 128) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (dkp) {
      case 16: return launch_bf16<16>(q, k, v, o, BH, T, dk, scale, st);
      case 32: return launch_bf16<32>(q, k, v, o, BH, T, dk, scale, st);
      case 64: return launch_bf16<64>(q, k, v, o, BH, T, dk, scale, st);
      default: return launch_bf16<128>(q, k, v, o, BH, T, dk, scale, st);
    }
  }
  switch (dkp) {
    case 16: return launch_f32<16>(q, k, v, o, BH, T, dk, scale, st);
    case 32: return launch_f32<32>(q, k, v, o, BH, T, dk, scale, st);
    case 64: return launch_f32<64>(q, k, v, o, BH, T, dk, scale, st);
    default: return launch_f32<128>(q, k, v, o, BH, T, dk, scale, st);
  }
}
