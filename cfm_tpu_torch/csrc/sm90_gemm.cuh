// The TMA + wgmma GEMM of the attention block (sm_90a), shared by the
// forward #1 (attn_block_fwd.cu: the qkv and out products) and the backward
// #2 (attn_block_bwd.cu: qkv, dattn, dwo, dwq, dtokens):
//   out (M x Nc) = A (M x K) B (K x Nc), bf16 operands, f32 accumulate.
//
// A block computes 128 x 128 with two consumer warpgroups (64 rows each,
// wgmma m64n128k16) and one producer warp that keeps a ring of three
// 64-deep K stages full by TMA (128-byte swizzle), full and empty mbarriers
// between them. Two m64n64 products instead of one m64n128, or one group of
// products kept in flight while the next stage is waited for, measured no
// faster on an H100 (PERF.md). Two blocks an SM. The operands are read as
// they lie, nothing transposed in memory: A K-major (a row-major (M, K)
// matrix) or MN-major (a row-major (K, M) one, the transposed operand of a
// weight gradient such as tokens^T dqkv); B MN-major (a row-major (K, Nc)
// matrix: a weight as it lies, or the rows of an activation) or K-major (a
// row-major (Nc, K) one: a weight read transposed, as wo in dy wo^T). Rows
// past M or K arrive as zeros.
//
// One launch may run up to P products (a grouped GEMM): the grid is flat,
// problem p's blocks follow problem p - 1's, and within a problem the
// column tiles of a row tile are neighbours (they run together, so A comes
// from device memory once), then the row tiles, then the K splits. A split
// covers ``chunk`` K steps; its partial product goes to its own slice of the
// output, and the caller adds the slices in a fixed order, so a rerun gives
// the same bits.
//
// Epilogues: the result is staged in the swizzled layout TMA reads, in ring
// panels no one reads any more, and stored by TMA, whole rows at a time.
//   - kMode 0, kParts 1: bf16, ``float2 epi(a0, a1, m, n)`` giving the
//     values of columns n, n + 1 of row m, staged in each warpgroup's own A
//     panels of stages 0 and 1;
//   - kMode 0, kParts 3: the f32 product split exactly into bf16 hi + mid +
//     lo (split3 below), part q stored at column offset ``epi.part_col(q)``
//     of the output map, staged in six panels a warpgroup once both
//     warpgroups are done with the ring;
//   - kMode 1: f32 as accumulated, to a rank-3 map over (splits, M, Nc),
//     staged in four panels a warpgroup (64 rows x 32 columns each).

#pragma once

#include "sm90_attention.cuh"

namespace sm90 {

constexpr int kGemmStages = 3;
constexpr int kGemmThreads = 288;  // two consumer warpgroups, one producer warp
constexpr int kGemmStageElems = 4 * kPanelElems;  // A: 128 rows x 64; B: 64 x 128
constexpr size_t kGemmSmem =
    1024 + kGemmStages * 4 * kPanelBytes + 2 * kGemmStages * sizeof(uint64_t);

struct GemmProblem {
  int a_mn;     // A read MN-major: its map is over (K, M)
  int b_k;      // B read K-major: its map is over (Nc, K)
  int M;        // rows of the output
  int tiles_n;  // Nc / 128
  int tiles_m;  // ceil(M / 128)
  int k_steps;  // ceil(K / 64)
  int chunk;    // K steps of a split
  int first;    // the problem's first block in the flat grid
};

template <int P>
struct GemmArgs {
  CUtensorMap a[P], b[P], out[P];
  GemmProblem prob[P];
};

// f32 x split exactly into bf16 hi + mid + lo, as to_split_frags splits it,
// for a pair of columns: o[q] packs part q of (x0, x1).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&o)[3]) {
  float h0, h1, m0, m1;
  o[0] = pack2(x0, x1);
  unpack2(o[0], h0, h1);
  const float r0 = x0 - h0, r1 = x1 - h1;
  o[1] = pack2(r0, r1);
  unpack2(o[1], m0, m1);
  o[2] = pack2(r0 - m0, r1 - m1);
}

template <int P, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
tma_gemm_kernel(const __grid_constant__ GemmArgs<P> args, const Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(align_1024(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGemmStages * kGemmStageElems);
  uint64_t* empty = full + kGemmStages;
  int pi = 0;
#pragma unroll
  for (int q = 1; q < P; ++q)
    if ((int)blockIdx.x >= args.prob[q].first) pi = q;
  const GemmProblem& pr = args.prob[pi];
  const int local = blockIdx.x - pr.first, rest = local / pr.tiles_n;
  const int n0 = 128 * (local % pr.tiles_n), m0 = 128 * (rest % pr.tiles_m);
  const int split = rest / pr.tiles_m, k_first = split * pr.chunk;
  const int KT = min(pr.k_steps, k_first + pr.chunk) - k_first;
  const bool a_mn = pr.a_mn != 0, b_k = pr.b_k != 0;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 8) {  // the producer
    if ((tid & 31) == 0)
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kGemmStages, k = 64 * (k_first + kt);
        if (kt >= kGemmStages) mbar_wait(&empty[s], (kt / kGemmStages - 1) & 1);
        bf16* st = ring + s * kGemmStageElems;
        mbar_expect_tx(&full[s], 4 * kPanelBytes);
        for (int h = 0; h < 2; ++h) {
          if (a_mn)
            tma_load(st + h * kPanelElems, &args.a[pi], &full[s], m0 + 64 * h, k);
          else
            tma_load(st + h * kPanelElems, &args.a[pi], &full[s], k, m0 + 64 * h);
          if (b_k)
            tma_load(st + (2 + h) * kPanelElems, &args.b[pi], &full[s], k, n0 + 64 * h);
          else
            tma_load(st + (2 + h) * kPanelElems, &args.b[pi], &full[s], n0 + 64 * h, k);
        }
      }
    return;
  }
  const int wg = warp >> 2;  // rows m0 + 64 wg .. + 63
  float acc[64];
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kGemmStages;
    mbar_wait(&full[s], (kt / kGemmStages) & 1);
    const bf16* A = ring + s * kGemmStageElems + wg * kPanelElems;
    const bf16* B = ring + s * kGemmStageElems + 2 * kPanelElems;
    wgmma_fence();
    if (a_mn) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_m64n128<1, 1>(acc, desc_mn(A, kk, 0), desc_mn(B, kk, 0), kt > 0 || kk > 0);
    } else if (b_k) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_m64n128<0, 0>(acc, desc_k(A, kk), desc_k(B, kk), kt > 0 || kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_m64n128<0, 1>(acc, desc_k(A, kk), desc_mn(B, kk, 0), kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(&empty[s]);
  }
  fence_regs(acc);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, wrow = 16 * (warp & 3) + g;
  const int row0 = m0 + 64 * wg;
  int panels = 2;  // the panels this warpgroup stages, from ring panel ``first``
  int first = 0;
  if constexpr (Epi::kMode == 0 && Epi::kParts == 1) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      bf16* tile = ring + p * kGemmStageElems + wg * kPanelElems;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = wrow + 8 * half_of(i), c = col_of(i, t);
        const float2 v = epi(acc[32 * p + i], acc[32 * p + i + 1], row0 + r, n0 + 64 * p + c);
        *reinterpret_cast<uint32_t*>(tile + swizzled(r, c)) = pack2(v.x, v.y);
      }
    }
  } else {
    // Every stage's panels are free once both warpgroups are past the ring.
    asm volatile("bar.sync 3, 256;" ::: "memory");
    if constexpr (Epi::kMode == 0) {
      panels = 6;
      first = 6 * wg;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = wrow + 8 * half_of(i), c = col_of(i, t);
          uint32_t o[3];
          split3(acc[32 * p + i], acc[32 * p + i + 1], o);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            *reinterpret_cast<uint32_t*>(ring + (first + 2 * q + p) * kPanelElems +
                                         swizzled(r, c)) = o[q];
        }
    } else {
      panels = 4;
      first = 4 * wg;
      uint8_t* base = reinterpret_cast<uint8_t*>(ring + first * kPanelElems);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = wrow + 8 * half_of(i), c = 64 * (i >> 5) + col_of(i & 31, t);
        const int cc = c & 31;  // f32 column within its 32-column panel of 128-byte rows
        *reinterpret_cast<float2*>(base + (c >> 5) * kPanelBytes + r * 128 +
                                   ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2))) =
            make_float2(acc[i], acc[i + 1]);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if ((tid & 127) == 0) {
    for (int k = 0; k < panels; ++k) {
      const bf16* src = Epi::kMode == 0 && Epi::kParts == 1
                            ? ring + k * kGemmStageElems + wg * kPanelElems
                            : ring + (first + k) * kPanelElems;
      if constexpr (Epi::kMode == 0)
        tma_store(&args.out[pi], src, epi.part_col(k >> 1) + n0 + 64 * (k & 1), row0);
      else
        tma_store_3d(&args.out[pi], src, n0 + 32 * k, row0, split);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// Problem p of ``args``: out (M x Nc) = A B, A bf16 row-major (M, K)
// (a_mn = 0) or (K, M) (a_mn = 1), B bf16 row-major (K, Nc) (b_k = 0) or
// (Nc, K) (b_k = 1), not both a_mn and b_k; Nc a multiple of 128 and, for an
// MN-major A, M too; K split into at most ``splits`` chunks of whole 64-deep
// steps (gemm_splits: how many). ``blocks`` is the running total of the flat
// grid. The output map is set by out_bf16 or out_f32.
template <int P>
int gemm_problem(GemmArgs<P>& args, int p, const bf16* a, int a_mn, const bf16* b, int b_k, int M,
                 int Nc, int K, int splits, int& blocks) {
  if (Nc % 128 || (a_mn && M % 128) || (a_mn && b_k) || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (int err = a_mn ? make_tile_map(&args.a[p], a, M, K) : make_tile_map(&args.a[p], a, K, M))
    return err;
  if (int err = b_k ? make_tile_map(&args.b[p], b, K, Nc) : make_tile_map(&args.b[p], b, Nc, K))
    return err;
  GemmProblem& pr = args.prob[p];
  pr.a_mn = a_mn;
  pr.b_k = b_k;
  pr.M = M;
  pr.tiles_n = Nc / 128;
  pr.tiles_m = (M + 127) / 128;
  pr.k_steps = (K + 63) / 64;
  pr.chunk = (pr.k_steps + splits - 1) / splits;
  pr.first = blocks;
  blocks += pr.tiles_n * pr.tiles_m * ((pr.k_steps + pr.chunk - 1) / pr.chunk);
  return 0;
}

// The bf16 output of a kMode 0 epilogue: a row-major (rows, cols) matrix.
template <int P>
int out_bf16(GemmArgs<P>& args, int p, bf16* out, int cols, int rows) {
  return make_tile_map(&args.out[p], out, cols, rows);
}

// The f32 output of a kMode 1 epilogue: ``splits`` row-major (M, Nc)
// matrices one after the other, in boxes of 64 rows x 32 columns (128-byte
// rows, 128-byte swizzle).
template <int P>
int out_f32(GemmArgs<P>& args, int p, float* out, int Nc, int M, int splits) {
  const cuuint64_t dims[3] = {(cuuint64_t)Nc, (cuuint64_t)M, (cuuint64_t)splits};
  const cuuint64_t strides[2] = {(cuuint64_t)Nc * sizeof(float),
                                 (cuuint64_t)M * Nc * sizeof(float)};
  const cuuint32_t box[3] = {32, kRows, 1};
  return encode_map(&args.out[p], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, out, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The splits a product over K takes for ``splits`` asked: every split holds
// at least one K step (the caller sizes its partial buffers).
inline int gemm_splits(int K, int splits) {
  const int steps = (K + 63) / 64, chunk = (steps + splits - 1) / splits;
  return (steps + chunk - 1) / chunk;
}

template <int P, class Epi>
int launch_gemm(const GemmArgs<P>& args, int blocks, const Epi& epi, cudaStream_t st) {
  if (int err = set_smem(tma_gemm_kernel<P, Epi>, kGemmSmem)) return err;
  tma_gemm_kernel<P, Epi><<<blocks, kGemmThreads, kGemmSmem, st>>>(args, epi);
  return (int)cudaGetLastError();
}

// One product out (M x Nc) = A (M x K) B, A K-major, B MN-major (b_k = 0)
// or K-major (b_k = 1), stored by a kMode 0 ``epi`` into ``out`` (bf16,
// out_cols columns).
template <class Epi>
int tma_gemm(const bf16* a, const bf16* b, int b_k, bf16* out, int out_cols, int M, int Nc, int K,
             const Epi& epi, cudaStream_t st) {
  GemmArgs<1> args;
  int blocks = 0;
  if (int err = gemm_problem(args, 0, a, 0, b, b_k, M, Nc, K, 1, blocks)) return err;
  if (int err = out_bf16(args, 0, out, out_cols, M)) return err;
  return launch_gemm(args, blocks, epi, st);
}

// The qkv epilogue of #1 and #2: T(round_T(acc) + round_T(bias)), the add in
// f32 and rounded to bf16 by the store.
struct BiasEpi {
  static constexpr int kMode = 0, kParts = 1;
  const float* bias;
  __device__ int part_col(int) const { return 0; }
  __device__ float2 operator()(float a0, float a1, int, int n) const {
    return make_float2(round_bf16(a0) + round_bf16(bias[n]),
                       round_bf16(a1) + round_bf16(bias[n + 1]));
  }
};

// The block's weights rounded to bf16 once a call, as they lie: wq (C x 3HD)
// then wo (HD x C), f32, into wb; both products read them in place (B
// MN-major in the forward, K-major in the backward's dattn and dtokens).
__global__ void round_weights_kernel(const float4* __restrict__ wq, const float4* __restrict__ wo,
                                     uint2* __restrict__ wb, int nq, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float4 v = i < nq ? wq[i] : wo[i - nq];
    wb[i] = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
  }
}

inline int round_weights(const float* wq, const float* wo, bf16* wb, int C, int HD,
                         cudaStream_t st) {
  const int nq = C * 3 * HD / 4, n = nq + HD * C / 4;
  round_weights_kernel<<<n < 262144 ? (n + 255) / 256 : 1024, 256, 0, st>>>(
      reinterpret_cast<const float4*>(wq), reinterpret_cast<const float4*>(wo),
      reinterpret_cast<uint2*>(wb), nq, n);
  return (int)cudaGetLastError();
}

}  // namespace sm90
