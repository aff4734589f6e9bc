// Hopper (sm_90a) building blocks of the multi-head attention kernels #3
// (attention_fwd.cu) and #4 (attention_bwd.cu), also used by the
// attention-block forward #1 (attn_block_fwd.cu) and the GroupNorm forward
// #8 (gn_strip.cuh): 64-row bf16 tiles loaded by TMA into 128-byte-swizzled
// shared memory and signalled on mbarriers, and the warpgroup products wgmma
// m64n64k16 and m64n128k16 (bf16 operands, f32 accumulators) on those
// tiles, with A read from shared memory or from registers; tensor maps of
// rank 2 and 3, and the thread-block-cluster barrier and distributed
// shared-memory reads.
//
// A tile holds 64 rows (queries or keys) of one (item, head) and all D
// columns, as D / 64 panels of 64 rows x 128 bytes, each the box of one TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B. A wgmma operand reads such a tile
// either K-major (the product's k runs along the row: q k^T, do v^T) or
// MN-major (k runs down the rows: w v, ds k, w^T do, ds^T q), so no tile is
// ever transposed in memory.
//
// Accumulator layout of m64n64 (f32, 32 a thread): warp w of the warpgroup
// owns rows 16 w + g and 16 w + g + 8 (g = lane / 4, t = lane % 4); element
// i of the thread is row 16 w + g + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 t + (i & 1). The A fragment of a register-A product over
// k = 16 c .. 16 c + 15 is then the bf16 pairs of elements 8 c .. 8 c + 7,
// so a tile of weights feeds the next product without a shuffle.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                      // rows of a tile
constexpr int kPanel = 64;                     // bf16 columns of a swizzled panel
constexpr int kPanelElems = kRows * kPanel;    // 4096
constexpr int kPanelBytes = 2 * kPanelElems;   // 8 KB

template <int D> __host__ __device__ constexpr int tile_elems() { return kRows * D; }
template <int D> __host__ __device__ constexpr int tile_bytes() { return 2 * kRows * D; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

constexpr int kWarpgroup = 128;  // threads of a warpgroup

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Dynamic shared memory rounded up to 1024 bytes: the 128-byte swizzle's
// pattern repeats every 8 rows of 128 bytes, and TMA and wgmma both take it
// from the address bits, so every tile starts on a 1024-byte boundary (the
// launch asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity. A load
// that never lands (a fault in a tensor map or an expected byte count) traps
// after about ten seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col), "r"(row)
      : "memory");
}

// A box of a rank-3 tensor map at (c0, c1, c2), innermost first. Elements
// out of the tensor's bounds arrive as zeros and count toward the bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// ``bytes`` (a multiple of 16) of contiguous global memory into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// Rows row .. row + 63 of a (rows, D) tensor into a tile: one box a panel.
// The caller has told ``bar`` to expect the tile's bytes.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row) {
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p) tma_load(dst + p * kPanelElems, map, bar, p * kPanel, row);
}

// A tiled tensor map of rank 2 or 3: ``dims`` elements innermost first,
// ``strides`` the bytes between steps of dims 1 and 2, ``box`` the elements
// of one TMA box. cuTensorMapEncodeTiled is a driver function; it is looked
// up through the runtime, so the library needs no link to libcuda.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tensor map of a contiguous bf16 (rows, D) matrix in 64 x 64 boxes with
// the 128-byte swizzle.
inline int make_tile_map(CUtensorMap* map, const void* base, int D, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(bf16)};
  const cuuint32_t box[2] = {kPanel, kRows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// 64 x 64 swizzled boxes over the rank-3 bf16 tensor (items, rows, cols),
// contiguous: a box never crosses from one item's rows into the next's, so
// rows past ``rows`` load as zeros and are not stored.
inline int make_item_map(CUtensorMap* map, const void* base, int cols, int rows, int items) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(bf16),
                                 (cuuint64_t)cols * rows * sizeof(bf16)};
  const cuuint32_t box[3] = {kPanel, kRows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The epilogue: a 64-row output tile is rounded to bf16 into a free tile of
// shared memory, in the swizzled layout TMA reads, and one thread stores it
// with one TMA box a panel, whole 128-byte rows at a time, where each
// thread's accumulators would reach device memory 4 bytes to a row.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(col), "r"(row)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Make every thread's staged tile visible to TMA and store it; the block
// waits until TMA has read shared memory, which may be reused or freed after.
template <int D>
__device__ __forceinline__ void store_tile(const bf16* tile, const CUtensorMap* map, int row) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < D / kPanel; ++p) tma_store(map, tile + p * kPanelElems, p * kPanel, row);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  __syncthreads();
}

// Element (r, c) of a 64-row swizzled tile, c < D.
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c >> 6) * kPanelElems + r * kPanel + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: the tile's rows are the product's m (or n) and its
// columns its k; step kk covers columns 16 kk .. 16 kk + 15, which lie in
// panel kk / 4 at byte 32 (kk % 4) of the row (the hardware swizzles the
// address as TMA did). Eight-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return make_desc(tile + (kk / 4) * kPanelElems + (kk % 4) * 16, 16, 1024);
}

// MN-major operand: the tile's rows are the product's k and panel p's 64
// columns its n; step kk covers rows 16 kk .. 16 kk + 15.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int p) {
  return make_desc(tile + p * kPanelElems + kk * 16 * kPanel, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulators across an
// issue or a wait of the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

#define SM90_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_OUT32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

// d (+)= A B, A and B in shared memory, both K-major. With accumulate = 0
// the product overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define SM90_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_OUT64(d)                                                                       \
  SM90_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B over 128 columns (m64n128k16), A and B in shared memory: A read
// K-major (TA = 0) or MN-major (TA = 1, the tile's rows are k and its 64
// columns m), B MN-major (TB = 1, two 64-column panels kPanelBytes apart:
// the descriptor's leading offset) or K-major (TB = 0, 128 rows of k
// columns, 1024 bytes an 8-row group). Element i of the thread is column
// 8 (i >> 2) + 2 t + (i & 1): the first 32 are panel 0's m64n64 layout, the
// next 32 panel 1's.
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SM90_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef SM90_D64
#undef SM90_OUT64

// d (+)= A B, A from registers (four bf16 pairs a thread, the layout above),
// B in shared memory, MN-major.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef SM90_D32
#undef SM90_OUT32

// acc = A B^T over D: A and B 64-row tiles read K-major (q k^T, do v^T,
// k q^T, v do^T).
template <int D>
__device__ __forceinline__ void issue_nt(float (&acc)[32], const bf16* A, const bf16* B,
                                         int accumulate = 0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss(acc, desc_k(A, kk), desc_k(B, kk), accumulate || kk > 0);
}

// acc[p] (+)= X B over 64 k: X as A fragments, B a tile read MN-major.
template <int D>
__device__ __forceinline__ void issue_nn(float (&acc)[D / 64][32], const uint32_t (&frag)[16],
                                         const bf16* B, int accumulate) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      mma_rs(acc[p], &frag[4 * c], desc_mn(B, c, p), accumulate || c);
}

// ---------------------------------------------------------------------------
// Row arithmetic on accumulators
// ---------------------------------------------------------------------------

// The softmax's exponentials. The logits are scaled by ls = scale * log2 e
// and exponentiated in base 2: e = 2^(acc ls - m), one fused multiply-add
// and one MUFU.EX2, where acc is q . k and m the row maximum of the scaled
// logits. For scale > 0 that maximum is the scaled maximum of acc (rounding
// is monotonic), so rows are reduced on acc and scaled once. Maxima and
// sums are of the scaled logits in every kernel that shares them.
__device__ __forceinline__ float logit_scale(float scale) {
  return __fmul_rn(scale, 1.4426950408889634f);
}
__device__ __forceinline__ float softmax_exp(float acc, float ls, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(acc, ls, -m)));
  return y;
}
// 2^x for the rescale of a running sum.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Reductions over the four threads (t = 0..3) that share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator element i lies in row half (i >> 1) & 1 (g or g + 8) and
// column 8 (i >> 2) + 2 t + (i & 1).
__device__ __forceinline__ constexpr int half_of(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ constexpr int col_of(int i, int t) { return 8 * (i >> 2) + 2 * t + (i & 1); }

// The bf16 A fragments of a 64 x 64 tile of values: frag[4 c .. 4 c + 3]
// feeds the product over k = 16 c .. 16 c + 15.
__device__ __forceinline__ void to_frags(const float (&v)[32], uint32_t (&frag)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) frag[i] = pack2(v[2 * i], v[2 * i + 1]);
}

// Accumulators in the wgmma layout (D / 64 panels of m64n64), rounded to
// bf16, into a swizzled tile: a warp's 4-byte stores fall in 32 banks.
template <int D>
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&acc)[D / 64][32]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<uint32_t*>(tile + swizzled(16 * warp + g + 8 * half_of(i),
                                                   64 * p + col_of(i, t))) =
          pack2(acc[p][i], acc[p][i + 1]);
}

// f32 x split exactly into bf16 hi + mid + lo (each step rounds to nearest
// and the remainder is exact in f32; after two steps at most 8 significant
// bits are left, which bf16 holds), as A fragments. A packed pair's bf16
// halves read back as f32 by a shift and a mask.
__device__ __forceinline__ void unpack2(uint32_t v, float& lo, float& hi) {
  lo = __uint_as_float(v << 16);
  hi = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ void to_split_frags(const float (&v)[32], uint32_t (&hi)[16],
                                               uint32_t (&mid)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float a0, a1, b0, b1;
    hi[i] = pack2(v[2 * i], v[2 * i + 1]);
    unpack2(hi[i], a0, a1);
    const float r0 = v[2 * i] - a0, r1 = v[2 * i + 1] - a1;
    mid[i] = pack2(r0, r1);
    unpack2(mid[i], b0, b1);
    lo[i] = pack2(r0 - b0, r1 - b1);
  }
}

// ---------------------------------------------------------------------------
// Thread-block clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster; orders shared-memory writes
// before it against reads of any block's shared memory after it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// ``*p`` in the shared memory of the cluster's block ``rank``.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

}  // namespace sm90
