// Stage kernels shared by the attention-block forward (attn_block_fwd.cu)
// and backward (attn_block_bwd.cu): GroupNorm statistics, the f32 FMA GEMM
// and the bf16 mma.sync GEMM with their operand loaders and epilogues. See
// attn_block_fwd.cu for the rounding points they keep.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back: the TPU kernel's ``.astype(lp)``.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// Sum over the block; every thread gets the result. ``red`` holds 32 floats.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // ``red`` may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (a) GroupNorm statistics: one block per (item, group).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int S, int C, int G, float eps) {
  __shared__ float red[32];
  const int n = blockIdx.x / G, g = blockIdx.x % G, cg = C / G;
  const T* base = x + (size_t)n * S * C + (size_t)g * cg;
  const int count = S * cg;
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    s += to_f<T>(base[(size_t)(i / cg) * C + i % cg]);
  const float mu = block_sum(s, red) / (float)count;
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const float d = to_f<T>(base[(size_t)(i / cg) * C + i % cg]) - mu;
    v = fmaf(d, d, v);
  }
  const float var = block_sum(v, red) / (float)count;
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd[blockIdx.x] = 1.0f / sqrtf(var + eps);
  }
}

// Tiled f32 GEMM out[m, n] = sum_k A(m, k) * B(k, n) over 64x64 output tiles,
// 256 threads each owning a 4x4 sub-tile strided by 16. The A and B loaders
// return values already rounded to the model dtype; the epilogue writes.
constexpr int BM = 64, BN = 64, BK = 16;

template <typename ALoad, typename BLoad, typename Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(int M, int Ncols, int K, ALoad aload, BLoad bload, Epi epi) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int c = tid % BK, r = tid / BK;  // 16 rows of 16 per pass
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + r + 16 * i, k = k0 + c;
        As[c][r + 16 * i] = (m < M && k < K) ? aload(m, k) : 0.f;
      }
    }
    {
      const int c = tid % BN, r = tid / BN;  // 4 rows of 64 per pass
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + r + 4 * i, n = n0 + c;
        Bs[r + 4 * i][c] = (k < K && n < Ncols) ? bload(k, n) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < Ncols) epi(m, n, acc[i][j]);
    }
}

// (b) A operand of the qkv product: GroupNorm(x) rounded to T, made on load.
template <typename T>
struct GnTokens {
  const T* x; const float* mean; const float* rstd;
  const float* gscale; const float* gbias;
  int S, C, G, cg;
  __device__ float operator()(int m, int k) const {
    const int stat = (m / S) * G + k / cg;
    // _rn intrinsics: no FMA contraction, each step rounded as in the TPU kernel.
    const float centered = __fsub_rn(to_f<T>(x[(size_t)m * C + k]), mean[stat]);
    return rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(centered, rstd[stat]), gscale[k]), gbias[k]));
  }
};

// B operand: an f32 weight (K, ld) rounded to T on load.
template <typename T>
struct RoundedWeight {
  const float* w; int ld;
  __device__ float operator()(int k, int n) const { return rnd<T>(w[(size_t)k * ld + n]); }
};

// A operand of the out projection: the context, already in T.
template <typename T>
struct Rows {
  const T* a; int ld;
  __device__ float operator()(int m, int k) const { return to_f<T>(a[(size_t)m * ld + k]); }
};

// (b) epilogue: qkv = T(round_T(acc) + round_T(bq)).
template <typename T>
struct QkvOut {
  T* qkv; const float* bq; int ld;
  __device__ void operator()(int m, int n, float acc) const {
    qkv[(size_t)m * ld + n] = from_f<T>(rnd<T>(acc) + rnd<T>(bq[n]));
  }
};

// (d) epilogue: y = T(x + (acc + bo)).
template <typename T>
struct ResidualOut {
  const T* x; T* y; const float* bo; int ld;
  __device__ void operator()(int m, int n, float acc) const {
    const size_t i = (size_t)m * ld + n;
    y[i] = from_f<T>(to_f<T>(x[i]) + (acc + bo[n]));
  }
};

// ---------------------------------------------------------------------------
// bf16 tensor-core path: mma.sync.m16n8k16, bf16 operands, f32 accumulators.
// Fragment layout (PTX ISA, "mma.m16n8k16"), g = lane / 4, t = lane % 4:
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..);
//   B 16x8 "col": b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g);
//   C 16x8: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
// Each 32-bit register holds two bf16, the lower k (or column) in the low half.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Prep: wt[n, k] = bf16(w[k, n]), the weight rounded and made K-contiguous.
__global__ void round_transpose_kernel(const float* __restrict__ w, bf16* __restrict__ wt,
                                       int K, int Ncols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K * Ncols) {
    const int n = i / K, k = i % K;
    wt[i] = __float2bfloat16_rn(w[(size_t)k * Ncols + n]);
  }
}

// (b)/(d) GEMM out[m, n] = sum_k A(m, k) * Bt[n, k] over 128x128 block tiles,
// K in steps of 32; 8 warps in a 2x4 grid, each a 64x32 warp tile of 4x4
// mma tiles. ``aload(m, k)`` returns A(m, k..k+7) as 8 bf16 (16 bytes).
// Shared-memory rows are padded to 40 bf16 so the fragment loads of a warp
// fall in 32 distinct banks.
constexpr int TBM = 128, TBN = 128, TBK = 32, TLD = TBK + 8;

template <typename ALoad, typename Epi>
__global__ void __launch_bounds__(kThreads)
mma_gemm_kernel(int M, int Ncols, int K, ALoad aload, const bf16* __restrict__ bt, Epi epi) {
  __shared__ __align__(16) bf16 As[TBM][TLD];
  __shared__ __align__(16) bf16 Bs[TBN][TLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TBK) {
    for (int c = tid; c < TBM * TBK / 8; c += kThreads) {
      const int r = c / (TBK / 8), kc = (c % (TBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r][kc]) =
          m0 + r < M ? aload(m0 + r, k0 + kc) : make_uint4(0, 0, 0, 0);
    }
    for (int c = tid; c < TBN * TBK / 8; c += kThreads) {
      const int r = c / (TBK / 8), kc = (c % (TBK / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r][kc]) =
          n0 + r < Ncols ? *reinterpret_cast<const uint4*>(bt + (size_t)(n0 + r) * K + k0 + kc)
                         : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = ld32(&As[r][kk + 2 * t]);
        a[i][1] = ld32(&As[r + 8][kk + 2 * t]);
        a[i][2] = ld32(&As[r][kk + 2 * t + 8]);
        a[i][3] = ld32(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = wn + j * 8 + g;
        const uint32_t b0 = ld32(&Bs[nn][kk + 2 * t]), b1 = ld32(&Bs[nn][kk + 2 * t + 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r >> 1) * 8, n = n0 + wn + j * 8 + 2 * t + (r & 1);
        if (m < M && n < Ncols) epi(m, n, acc[i][j][r]);
      }
}

// (b) A operand: GroupNorm(x) rounded to bf16, 8 channels at a time.
struct GnTokens8 {
  const bf16* x; const float* mean; const float* rstd;
  const float* gscale; const float* gbias;
  int S, C, G, cg;
  __device__ uint4 operator()(int m, int k) const {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * C + k);
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    const int base = (m / S) * G;
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = k + j + u, stat = base + kk / cg;
        const float centered = __fsub_rn(__bfloat162float(xv[j + u]), mean[stat]);
        v[u] = __fadd_rn(__fmul_rn(__fmul_rn(centered, rstd[stat]), gscale[kk]), gbias[kk]);
      }
      o[j / 2] = pack_bf16(v[0], v[1]);
    }
    return out;
  }
};

// (d) A operand: the context rows, already bf16.
struct Rows8 {
  const bf16* a; int ld;
  __device__ uint4 operator()(int m, int k) const {
    return *reinterpret_cast<const uint4*>(a + (size_t)m * ld + k);
  }
};

}  // namespace
