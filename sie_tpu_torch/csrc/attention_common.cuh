// Pieces shared by the fused-attention kernels K5 (attention_fwd.cu) and K6
// (attention_bwd.cu): the mma.sync / ldmatrix / cp.async wrappers of the
// bf16 paths and their tile loader, the 3xTF32 pieces of the f32 paths and
// their tile loader, and the dropout hash.
//
// The dropout hash is the Pallas kernels' `_dropout_mask`
// (sie_tpu/ops/pallas/attention_pallas.py:73-94), bit for bit: a murmur3
// finaliser of (seed, bh, global query row, global key column) in uint32
// arithmetic, kept when the hash is >= min(rate * 2^32, 2^32 - 1). Keyed on
// global indices, the forward and the backward regenerate the same mask
// whatever their tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;   // score of a key at or past T
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------ dropout hash
__device__ __forceinline__ uint32_t dropout_key(int seed, int bh) {
  return (uint32_t)seed * 0x9E3779B9u ^ (uint32_t)bh * 0x85EBCA6Bu;
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, int row, int col,
                                             uint32_t thresh) {
  uint32_t x = ((uint32_t)row * 0x27D4EB2Fu + (uint32_t)col) ^ key;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x = x ^ (x >> 16);
  return x >= thresh;
}

// ------------------------------------------------------- bf16 mma helpers
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

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * g + i. The f32
// accumulator c of a 16 x 8 tile holds (row g, cols 2i, 2i+1) in c[0..1]
// and (row g + 8, same cols) in c[2..3]. The A operand (16 x 16) holds
// (row g, cols 2i..2i+1), (row g + 8, cols 2i..), (row g, cols 2i+8..),
// (row g + 8, cols 2i+8..); the B operand (16 x 8) holds (rows 2i..2i+1,
// col g) and (rows 2i+8.., col g). So the accumulators of two adjacent
// 16 x 8 tiles, packed to bf16, are the A operand of one 16-deep k-step.

// A fragment of k-step kk from rows r0..r0+15 of a staged tile
template <int LDH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (r0 + lane % 16) * LDH + kk * 16 + (lane / 16) * 8);
}

// B fragments of column tiles nt and nt + 1 for k-step kk, when B = M^T and
// M is staged row-major (rows are the B columns): b[0..1] for nt, b[2..3]
// for nt + 1
template <int LDH>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int nt, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + ((nt + lane / 16) * 8 + lane % 8) * LDH + kk * 16 +
                 ((lane / 8) % 2) * 8);
}

// B fragments of column tiles dn and dn + 1 for k-step kk, when B = M and M
// is staged row-major (rows are the k index)
template <int LDH>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int dn, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (kk * 16 + lane % 16) * LDH + (dn + lane / 16) * 8);
}

// A operand of k-step kk from the f32 accumulators of tiles 2kk, 2kk + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ------------------------------------------------- f32 paths: 3xTF32 mma
// An f32 product a*b is taken on the tensor cores as three TF32 products,
// big_a*big_b + big_a*small_b + small_a*big_b, where big is x rounded to
// TF32 and small is x - big (exact in f32) cut to TF32; the dropped
// small_a*small_b and the cut of small are ~2^-21 of |a*b|, so the sums
// keep f32 accuracy where one TF32 product keeps ~3 decimal digits.

// big: round half away from zero to 10 mantissa bits, as cvt.rna.tf32.f32,
// in two integer ops (ptxas lowers the cvt to a longer compare-and-select
// sequence: the f32 backward ran 1.24-1.35x slower with it on an H100);
// small: truncated, |x - big - small| <= 2^-10 |x - big| <= 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xFFFFE000u;
}

// c (16x8, f32) += a (16x8, tf32, row-major) * b (8x8, tf32, col-major)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand split once into its big and small TF32 parts
struct SplitA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void split_a(SplitA& a, float x0, float x1,
                                        float x2, float x3) {
  split_tf32(x0, a.big[0], a.small[0]);
  split_tf32(x1, a.big[1], a.small[1]);
  split_tf32(x2, a.big[2], a.small[2]);
  split_tf32(x3, a.big[3], a.small[3]);
}

// c += a * (b0, b1) at f32 accuracy: the B fragment is split here, the
// small products go first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, a.small, bb0, bb1);
  mma_tf32(c, a.big, bs0, bs1);
  mma_tf32(c, a.big, bb0, bb1);
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 * g + i. A (16 x
// 8) holds (g, i), (g + 8, i), (g, i + 4), (g + 8, i + 4); B (8 x 8) holds
// (row i, col g), (row i + 4, col g); the accumulator C holds (g, 2i),
// (g, 2i + 1), (g + 8, 2i), (g + 8, 2i + 1), as in m16n8k16.
//
// So a score accumulator is not the A operand of the next product as it is
// in bf16. Instead the 8 keys of a k-step are read in the order
// pi = [0, 2, 4, 6, 1, 3, 5, 7]: k-index i is key 2i and k-index i + 4 is
// key 2i + 1, so the accumulator (c0, c1, c2, c3) of an 8-key tile is the A
// fragment (c0, c2, c1, c3), and the B rows are read in the same order
// (rows 2i and 2i + 1 of the staged tile). The accumulator's own columns,
// and so the dropout hash's key index, stay the true ones.
//
// Staged f32 tiles have the row stride LDF = DKP + 4 = 4 x odd words: the
// reads at g * LDF + i (A fragments, B = M^T) and at 2i * LDF + g (the
// permuted B = M) fall in 32 distinct banks.

// A fragment of rows r0..r0+15, columns c0..c0+7 of a staged f32 tile
template <int LDF>
__device__ __forceinline__ void load_a_f32(SplitA& a, const float* tile,
                                           int r0, int c0) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (r0 + lane / 4) * LDF + c0 + lane % 4;
  split_a(a, p[0], p[8 * LDF], p[4], p[8 * LDF + 4]);
}

// A fragment of an 8-column step from a 16 x 8 f32 accumulator tile, in the
// permuted k order
__device__ __forceinline__ void acc_a_f32(SplitA& a, const float (&c)[4]) {
  split_a(a, c[0], c[2], c[1], c[3]);
}

// c += A * B^T over columns c0..c0+7, for column tile nt of B^T, where M =
// B^T is staged row-major (rows are the B columns: Q K^T reads K so)
template <int LDF>
__device__ __forceinline__ void mma_bt_f32(float (&c)[4], const SplitA& a,
                                           const float* tile, int nt, int c0) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (nt * 8 + lane / 4) * LDF + c0 + lane % 4;
  mma_3xtf32(c, a, p[0], p[4]);
}

// c += A * B for k-step kk (rows 8kk.. of M = B, in the permuted order) and
// column tile dn, where M is staged row-major (P V reads V so)
template <int LDF>
__device__ __forceinline__ void mma_b_f32(float (&c)[4], const SplitA& a,
                                          const float* tile, int kk, int dn) {
  const int lane = threadIdx.x % 32;
  const float* p = tile + (kk * 8 + 2 * (lane % 4)) * LDF + dn * 8 + lane / 4;
  mma_3xtf32(c, a, p[0], p[LDF]);
}

// rows [t0, t0 + 64) of a (T, dk) f32 matrix into a 64 x DKP tile with row
// stride DKP + 4; zero past T and past dk. When dk is a multiple of 4 and
// the matrix 16-byte aligned the copy is asynchronous (cp.async, 4 floats
// at a time, zero-filled where out of range; the caller commits and
// waits), else it is done here.
template <int DKP>
__device__ void load_tile_f32(float* dst, const float* __restrict__ src,
                              int t0, int T, int dk) {
  constexpr int LDF = DKP + 4;
  const bool vec = dk % 4 == 0 && (reinterpret_cast<uintptr_t>(src) % 16) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < 64 * DKP / 4; i += blockDim.x) {
      const int rr = i / (DKP / 4), cc = (i % (DKP / 4)) * 4;
      const int t = t0 + rr;
      const bool ok = t < T && cc < dk;
      cp_async16(dst + rr * LDF + cc, src + (ok ? (size_t)t * dk + cc : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * DKP; i += blockDim.x) {
      const int rr = i / DKP, cc = i % DKP;
      const int t = t0 + rr;
      dst[rr * LDF + cc] = (t < T && cc < dk) ? src[(size_t)t * dk + cc] : 0.f;
    }
  }
}

}  // namespace attn
