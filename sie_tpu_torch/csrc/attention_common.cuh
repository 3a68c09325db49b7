// Pieces shared by the fused-attention kernels K5 (attention_fwd.cu) and K6
// (attention_bwd.cu), and by the flash-attention kernels K9, K10b and K10a
// built from the same bf16 bodies: for the bf16 paths the swizzled tiles,
// their two
// loaders (TMA, and element by element for the shapes TMA cannot take) and
// the wgmma wrappers; for the f32 paths the 3xTF32 mma.sync pieces and the
// cp.async tile loader; and the dropout hash.
//
// The dropout hash is the Pallas kernels' `_dropout_mask`
// (sie_tpu/ops/pallas/attention_pallas.py:73-94), bit for bit: a murmur3
// finaliser of (seed, bh, global query row, global key column) in uint32
// arithmetic, kept when the hash is >= min(rate * 2^32, 2^32 - 1). Keyed on
// global indices, the forward and the backward regenerate the same mask
// whatever their tiles.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;   // score of a key at or past T
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------------ grid
// A launch's grid is one-dimensional: block x = bh * tiles + tile, the
// tiles of `rows` query (or key) rows of one (batch, head) row side by
// side. gridDim.x takes 2^31 - 1 blocks, so BH is bounded only by the
// caller's BH * T < 2^31 (gridDim.y would stop it at 65535).
struct TileRow {
  int bh, t0;
};

__device__ __forceinline__ TileRow tile_row(int T, int rows) {
  const unsigned tiles = (unsigned)((T + rows - 1) / rows);
  return {(int)(blockIdx.x / tiles), (int)(blockIdx.x % tiles) * rows};
}

// halves: the column halves of each tile (DKP / out_cols<DKP>()), on y
inline dim3 tile_grid(int BH, int T, int rows, int halves = 1) {
  return dim3((unsigned)(((size_t)T + rows - 1) / rows * (size_t)BH),
              (unsigned)halves);
}

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

// ------------------------------------------------ shared-memory helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a and b rounded to bf16 (to nearest even) by one conversion of the pair;
// a conversion of each alone made K5 and K6 10-11 % slower on an H100
__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
  const uint32_t p = pack_bf16(a, b);   // a in the low half
  a = __uint_as_float(p << 16);
  b = __uint_as_float(p & 0xFFFF0000u);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0 (exp2f
// adds a rescale around it for them)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------- bf16 paths: swizzled tiles
// A staged bf16 tile holds 64 rows of a (T, dk) matrix, dk zero-padded to
// DKP in {64, 128} (256 for the flash kernels), in the layout that wgmma
// reads with its 128-byte
// swizzle: panels of 64 columns (panel p at byte p * SW_PANEL_BYTES), each
// row of a panel 128 bytes, and the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8). The swizzle acts on address bits (bits 4-6 XOR bits
// 7-9), so tiles start on 1024-byte boundaries. Eight rows (1024 bytes)
// are the swizzle's period: the descriptors' stride byte offset.
// tests/test_torch_port_wgmma.py reads these constants and emulates, in
// numpy, the loader and what every descriptor below addresses.
constexpr uint32_t SW_ROW_BYTES = 128;        // one row of a panel
constexpr uint32_t SW_ATOM_BYTES = 1024;      // 8 rows: SBO of every operand
constexpr uint32_t SW_PANEL_BYTES = 8192;     // 64 rows: LBO of MN-major B
constexpr uint32_t KSTEP_KMAJOR_BYTES = 32;   // 16 columns of a K-major row
constexpr uint32_t KSTEP_MNMAJOR_BYTES = 2048;  // 16 rows of an MN-major tile
constexpr uint32_t KMAJOR_LBO_BYTES = 16;     // unused by K-major swizzled
                                              // operands; CUTLASS writes 1

template <int DKP>
__host__ __device__ constexpr int sw_tile_elems() { return 64 * DKP; }

// Output columns a bf16 block accumulates: all DKP up to 128. At 256 one
// warpgroup's f32 accumulators of a 64 x 256 output would take 128
// registers a thread (dK and dV together 256), so a block computes one
// half of the columns (gridDim.y = 2, half blockIdx.y) from the whole rows
// of scores, which both halves recompute.
template <int DKP>
__host__ __device__ constexpr int out_cols() { return DKP < 128 ? DKP : 128; }

// element offset of (row, col) in a staged tile
__device__ __forceinline__ int sw_index(int row, int col) {
  return (col >> 6) * (int)(SW_PANEL_BYTES / 2) + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// the first 1024-byte boundary at or after p, in shared memory (dynamic
// shared memory is allocated with 1024 bytes of slack for it)
__device__ __forceinline__ unsigned char* sw_align(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// rows [t0, t0 + 64) of a (T, dk) bf16 matrix into a staged tile, zero
// past T and past dk, element by element by all threads of the block: the
// loader of the shapes TMA cannot stage (`tma_fits`: dk not a multiple of
// 8, or a tensor not 16-byte aligned, where 16-byte copies cannot go
// either); the caller then runs `tiles_ready`
template <int DKP>
__device__ void load_tile_sw(bf16* dst, const bf16* __restrict__ src, int t0,
                             int T, int dk) {
  for (int i = threadIdx.x; i < 64 * DKP; i += blockDim.x) {
    const int rr = i / DKP, cc = i % DKP;
    const int t = t0 + rr;
    dst[sw_index(rr, cc)] = (t < T && cc < dk) ? src[(size_t)t * dk + cc]
                                               : __float2bfloat16(0.f);
  }
}

// The tiles this block wrote with `load_tile_sw` are visible to wgmma:
// the writes are ordered before the async proxy that wgmma reads
// through, then the block meets.
__device__ __forceinline__ void tiles_ready() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ------------------------------------------------ bf16: the TMA loader
// Where dk is a multiple of 8 (TMA needs 16-byte global strides) and the
// tensors are 16-byte aligned, one thread stages a whole tile: a 3-D
// tensor map (dk, T, BH) cut in 64 x 64 boxes in the 128-byte swizzle, so
// that the hardware writes the layout above and zero-fills past dk and
// past T of each head. Completion is counted in bytes on an mbarrier. The
// cp.async loader costs each thread ~15 instructions a 16-byte chunk, 8
// chunks a tile, in kernels whose softmax already keeps every warp's issue
// slots busy: on an H100 K5 ran 0.50 ms with it and 0.34 ms with TMA, so
// the element loader above is left only for what TMA cannot take.

// a tensor map of a bf16 (BH, T, dk) tensor for `tma_tile`; the driver's
// encoder is reached through the runtime (no -lcuda). Returns 0, or 1000
// plus the driver's error code
inline int encode_tile_map(CUtensorMap* m, const void* p, int BH, int T,
                           int dk) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult qr;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &qr);
    if (e != cudaSuccess || qr != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return e != cudaSuccess ? (int)e : (int)cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[3] = {(cuuint64_t)dk, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dk * 2, (cuuint64_t)T * dk * 2};
  const cuuint32_t box[3] = {64, 64, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// whether a bf16 (BH, T, dk) tensor can be staged by TMA
inline bool tma_fits(const void* p, int dk) {
  return dk % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(b)));
}

// inits n barriers (one arrival each) in thread 0, visible to the block
__device__ __forceinline__ void mbar_init_all(uint64_t* b, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(&b[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the issuing thread's arrival, and the bytes the phase waits for
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(b)), "r"(bytes) : "memory");
}

// spins until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
  } while (!done);
}

// rows [t0, t0 + 64) of head bh into a staged tile, one box a panel;
// counted on bar (whose expected bytes the caller has set)
template <int DKP>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap& m,
                                         uint64_t* bar, int t0, int bh) {
#pragma unroll
  for (int p = 0; p < DKP / 64; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_addr(dst + p * (SW_PANEL_BYTES / 2))),
           "l"(reinterpret_cast<uint64_t>(&m)), "r"(smem_addr(bar)),
           "r"(64 * p), "r"(t0), "r"(bh)
        : "memory");
}

template <int DKP>
__host__ __device__ constexpr uint32_t sw_tile_bytes() {
  return 2 * sw_tile_elems<DKP>();
}

// ------------------------------------------------------- bf16: wgmma
// wgmma.mma_async m64n64k16, bf16 in, f32 accumulators. A warpgroup (four
// warps, 128 threads) computes a 64 x 64 tile. Accumulator layout (PTX
// ISA, wgmma .m64nNk16 D): warp w of the warpgroup, lane = 4 * g + i, holds
// in d[4 * j + e] the element (row 16w + g + 8 * (e / 2), column 8j + 2i +
// (e & 1)): per 8-column chunk j the layout of an mma.m16n8 accumulator.
// A from registers: warp w holds rows 16w.. 16w + 15 of a 64 x 16 k-step
// as an mma.m16n8k16 A fragment, so the accumulators of chunks 2kk and
// 2kk + 1, packed to bf16 by `pack_a`, are the A operand of k-step kk.

// matrix descriptor of a staged-tile operand at byte address p: start
// address >> 4, leading byte offset, stride byte offset (8 rows), 128-byte
// swizzle (layout type 1), base offset 0 (tiles are 1024-byte aligned)
__device__ __forceinline__ uint64_t sw_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(SW_ATOM_BYTES >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// waits until at most the last committed wgmma group is in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of n accumulator
// registers across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A B^T: A and B both K-major descriptors (rows of A and rows of B
// run along k); scale-d is a predicate, set: accumulate
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B: A from registers, B an MN-major descriptor (a row of the
// staged tile is one k, its columns run along n): transpose bit set
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A B^T over DKP columns, A and B staged tiles (S = Q K^T,
// dP = dO V^T, S^T = K Q^T, dP^T = V dO^T): k-step kk reads bytes
// 32 * (kk % 4) of each row of panel kk / 4
template <int DKP>
__device__ __forceinline__ void mma_abt(float* d, const bf16* a,
                                        const bf16* b) {
  const uint64_t da = sw_desc(a, KMAJOR_LBO_BYTES);
  const uint64_t db = sw_desc(b, KMAJOR_LBO_BYTES);
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) {
    // a byte offset moves the start address field (16-byte units); shared
    // addresses stay below 2^18, so the 14-bit field does not carry
    const uint32_t off = (kk / 4) * SW_PANEL_BYTES + (kk % 4) * KSTEP_KMAJOR_BYTES;
    wgmma_ss(d, da + (off >> 4), db + (off >> 4));
  }
}

// d (64 x columns [64 p, 64 p + 64) of the result) += A B with A (64 x 64)
// in registers, a[kk] the fragment of k-step kk, and B a staged tile whose
// 64 rows are the k index (P V, dS K, P^T dO, dS^T Q): k-step kk starts at
// row 16 kk of panel p
__device__ __forceinline__ void mma_ab(float* d, const uint32_t (&a)[4][4],
                                       const bf16* b, int p) {
  const uint64_t db = sw_desc(b, SW_PANEL_BYTES);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[kk],
             db + ((p * SW_PANEL_BYTES + kk * KSTEP_MNMAJOR_BYTES) >> 4));
}

// A operand of k-step kk from the f32 accumulators of chunks 2kk, 2kk + 1
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
