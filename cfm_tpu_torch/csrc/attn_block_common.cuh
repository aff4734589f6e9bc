// Stage kernels shared by the attention-block forward (attn_block_fwd.cu)
// and backward (attn_block_bwd.cu) and by the multi-head attention forward
// (attention_fwd.cu) and backward (attention_bwd.cu): GroupNorm statistics,
// the f32 FMA GEMM and the bf16 mma.sync GEMM (the backward's) with their
// operand loaders and epilogues, the FMA attention stage (softmax(q k^T) v
// per item and head, on any row layout), and the batched GEMMs and softmax
// row passes of the recomputing attention backward. See attn_block_fwd.cu
// for the rounding points they keep.

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

// (a) GroupNorm statistics: one block per (item, group) (the float32
// forward and the backward; the bf16 forward's GroupNorm is gn_strip.cuh).
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

// The backward's recomputed qkv GEMM (the bf16 forward's GEMMs are TMA +
// wgmma, attn_block_fwd.cu): out[m, n] = sum_k A(m, k) * Bt[n, k] over 128x128 block tiles,
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

// ---------------------------------------------------------------------------
// (c) Multi-head attention per (item, head): logits q k^T * scale in f32, the
// softmax e / sum(e), e = exp(l - max), in f32, the weights rounded to T,
// then w @ v accumulated in f32 and rounded to T. The attention block runs
// it on its (N, S, 3HD) qkv buffer; kernel #3 on the (N, 3, H, S, D) layout.
// ---------------------------------------------------------------------------

// Where one (item n, head h)'s rows sit: q row s at qkv + n * in_item +
// h * in_head + s * in_row, its k and v rows in_comp and 2 * in_comp further;
// output row s at out + n * out_item + h * out_head + s * out_row. Each
// stride is 32-bit (an item's qkv stays under 2^31 elements); the kernels
// widen them where they index.
struct AttnLayout {
  int in_item, in_head, in_comp, in_row, out_item, out_head, out_row;
};

// The FMA kernel, for one (query tile, head, item). Dynamic shared memory:
// q tile QT x D, the f32 logits/weights QT x S, one K or V tile KT x (D+1).
constexpr int QT = 32, KT = 64, DC = 64;  // DC: output columns per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, AttnLayout L, int S, int D,
                 float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // QT * D
  float* P = Qs + QT * D;           // QT * S
  float* KV = P + QT * S;           // KT * (D + 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, n = blockIdx.z;
  const T* qb = qkv + (size_t)n * L.in_item + (size_t)h * L.in_head;
  const T* kb = qb + L.in_comp;
  const T* vb = kb + L.in_comp;
  T* ob = out + (size_t)n * L.out_item + (size_t)h * L.out_head;

  for (int e = tid; e < QT * D; e += kThreads) {
    const int qi = e / D, d = e % D, s = q0 + qi;
    Qs[e] = s < S ? to_f<T>(qb[(size_t)s * L.in_row + d]) : 0.f;
  }
  // Logits for every key, one key tile at a time.
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * D; e += kThreads) {
      const int kj = e / D, d = e % D, s = k0 + kj;
      KV[kj * (D + 1) + d] = s < S ? to_f<T>(kb[(size_t)s * L.in_row + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < QT * KT; e += kThreads) {
      const int qi = e / KT, kj = e % KT;
      if (k0 + kj < S) {
        const float* q = Qs + qi * D;
        const float* k = KV + kj * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(q[d], k[d], dot);
        P[qi * S + k0 + kj] = dot * scale;
      }
    }
  }
  __syncthreads();
  // Softmax per row in f32 (one warp per row), weights rounded to T.
  for (int qi = warp; qi < QT; qi += kThreads / 32) {
    float* row = P + qi * S;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < S; j += 32) row[j] = rnd<T>(row[j] / sum);
  }
  // Context = w @ v, DC output columns per pass, f32 accumulate.
  constexpr int kRows = QT * DC / kThreads;  // outputs per thread: 8
  const int dcol = tid % DC, qrow = tid / DC;  // rows qrow + 4 * i
  for (int d0 = 0; d0 < D; d0 += DC) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < S; k0 += KT) {
      __syncthreads();
      for (int e = tid; e < KT * DC; e += kThreads) {
        const int kj = e / DC, d = e % DC, s = k0 + kj;
        KV[kj * (DC + 1) + d] = s < S ? to_f<T>(vb[(size_t)s * L.in_row + d0 + d]) : 0.f;
      }
      __syncthreads();
      const int kn = min(KT, S - k0);
      for (int j = 0; j < kn; ++j) {
        const float v = KV[j * (DC + 1) + dcol];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i] = fmaf(P[(qrow + 4 * i) * S + k0 + j], v, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = q0 + qrow + 4 * i;
      if (s < S) ob[(size_t)s * L.out_row + d0 + dcol] = from_f<T>(acc[i]);
    }
  }
}

size_t attention_smem(int S, int D) {
  return sizeof(float) * ((size_t)QT * D + (size_t)QT * S + (size_t)KT * (D + 1));
}

// The FMA attention stage for T (float32, and bf16 at head dims other than
// 64 and 128; bf16 at 64 and 128 runs the TMA + wgmma kernels of
// sm90_attention_fwd.cuh). Returns 0 or a CUDA error.
template <typename T>
int launch_attention(const T* qkv, T* out, AttnLayout L, int N, int S, int H, int D, float scale,
                     cudaStream_t stream) {
  const size_t smem = attention_smem(S, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_kernel<T><<<dim3((S + QT - 1) / QT, H, N), kThreads, smem, stream>>>(
      qkv, out, L, S, D, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The recomputing attention backward's pieces: batched GEMMs over (item,
// head) pairs with strided operand loaders, and the softmax row passes over
// an (S, S) scratch per pair. The attention-block backward (#2) runs them on
// its qkv buffer, the multi-head attention backward (#4) on (N, 3, H, S, D).
//
// Operand loaders return V consecutive values along the operand's contiguous
// index, starting at (i, j): (m, k) for A, (k, n) for B. Every extent and
// offset the kernels use is a multiple of 8 elements (S % 8 == 0,
// D % 64 == 0), so a run of V never straddles a tile edge and its address is
// aligned for a V-wide vector load.
// ---------------------------------------------------------------------------

template <typename S, int V> struct Vec;
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
};
template <> struct Vec<float, 8> {
  __device__ static void load(const float* p, float* out) {
    Vec<float, 4>::load(p, out);
    Vec<float, 4>::load(p + 4, out + 4);
  }
};
template <> struct Vec<bf16, 4> {
  __device__ static void load(const bf16* p, float* out) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
    for (int u = 0; u < 4; ++u) out[u] = __bfloat162float(h[u]);
  }
};
template <> struct Vec<bf16, 8> {
  __device__ static void load(const bf16* p, float* out) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
    for (int u = 0; u < 8; ++u) out[u] = __bfloat162float(h[u]);
  }
};

template <int V, typename Load>
__device__ __forceinline__ void load_or_zero(const Load& load, int z, int i, int j, bool in,
                                             float (&out)[V]) {
  if (in) {
    load.template vec<V>(z, i, j, out);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = 0.f;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// Batched f32 FMA GEMM: C[z](m, n) = sum_k A(z, m, k) * B(z, k, n) over
// (16 TM) x (16 TN) tiles, K in steps of 8, 256 threads of TM x TN outputs
// each, fed from shared memory by float4 reads; a thread's columns are
// 4-wide groups 64 apart, so each epilogue row is written coalesced. With kchunk = 0, z is a batch
// index passed to the loaders; with kchunk > 0, z splits K into chunks of
// kchunk and the epilogue writes one partial sum per chunk. Each loader says
// whether consecutive k are adjacent in memory (kKContig), and the tile load
// maps threads along the contiguous index either way.
constexpr int FK = 8;

template <int TM, int TN, typename ALoad, typename BLoad, typename Epi>
__global__ void __launch_bounds__(kThreads)
fgemm_kernel(int M, int Ncols, int K, int kchunk, ALoad aload, BLoad bload, Epi epi) {
  constexpr int TBMf = 16 * TM, TBNf = 16 * TN;
  // Rows padded by 4 floats: the k-major tile stores then hit distinct banks,
  // and the float4 reads stay 16-byte aligned.
  __shared__ __align__(16) float As[FK][TBMf + 4];
  __shared__ __align__(16) float Bs[FK][TBNf + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TBMf, n0 = blockIdx.y * TBNf, z = blockIdx.z;
  const int zb = kchunk ? 0 : z;
  const int kb = kchunk ? z * kchunk : 0;
  const int ke = kchunk ? min(K, kb + kchunk) : K;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += FK) {
    for (int v = tid; v < TBMf * FK / 4; v += kThreads) {
      float f[4];
      if (ALoad::kKContig) {
        const int m = v / (FK / 4), kk = (v % (FK / 4)) * 4;
        load_or_zero<4>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 4; ++u) As[kk + u][m] = f[u];
      } else {
        const int kk = v / (TBMf / 4), m = (v % (TBMf / 4)) * 4;
        load_or_zero<4>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
        *reinterpret_cast<float4*>(&As[kk][m]) = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    for (int v = tid; v < TBNf * FK / 4; v += kThreads) {
      float f[4];
      if (BLoad::kKContig) {
        const int n = v / (FK / 4), kk = (v % (FK / 4)) * 4;
        load_or_zero<4>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 4; ++u) Bs[kk + u][n] = f[u];
      } else {
        const int kk = v / (TBNf / 4), n = (v % (TBNf / 4)) * 4;
        load_or_zero<4>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
        *reinterpret_cast<float4*>(&Bs[kk][n]) = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        *reinterpret_cast<float4*>(&a[i]) = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
#pragma unroll
      for (int j = 0; j < TN; j += 4)  // columns j/4 * 64 + 4 tx: coalesced epilogue rows
        *reinterpret_cast<float4*>(&b[j]) =
            *reinterpret_cast<const float4*>(&Bs[kk][(j / 4) * 64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int m = m0 + ty * TM + i, n = n0 + (j / 4) * 64 + tx * 4;
      if (m < M && n < Ncols) epi.store4(z, m, n, acc[i][j], acc[i][j + 1], acc[i][j + 2],
                                         acc[i][j + 3]);
    }
}

// The same batched GEMM on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulate), for products whose two operands hold model-dtype (bf16)
// values: the loaders return floats that bf16 represents exactly, so the
// products are exact and only the f32 accumulation order differs from the
// FMA kernel. 128x128 block tiles, K in steps of 32, 8 warps of 64x32 (the
// mma_gemm_kernel layout). The tile load maps threads along each
// operand's contiguous index and stores bf16 into (row, k) shared tiles.
template <typename ALoad, typename BLoad, typename Epi>
__global__ void __launch_bounds__(kThreads)
bmma_kernel(int M, int Ncols, int K, int kchunk, ALoad aload, BLoad bload, Epi epi) {
  __shared__ __align__(16) bf16 As[TBM][TLD];
  __shared__ __align__(16) bf16 Bs[TBN][TLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN, z = blockIdx.z;
  const int zb = kchunk ? 0 : z;
  const int kb = kchunk ? z * kchunk : 0;
  const int ke = kchunk ? min(K, kb + kchunk) : K;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += TBK) {
    for (int v = tid; v < TBM * TBK / 8; v += kThreads) {
      float f[8];
      if (ALoad::kKContig) {
        const int m = v / (TBK / 8), kk = (v % (TBK / 8)) * 8;
        load_or_zero<8>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
        *reinterpret_cast<uint4*>(&As[m][kk]) = pack8(f);
      } else {
        const int kk = v / (TBM / 8), m = (v % (TBM / 8)) * 8;
        load_or_zero<8>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 8; ++u) As[m + u][kk] = __float2bfloat16_rn(f[u]);
      }
    }
    for (int v = tid; v < TBN * TBK / 8; v += kThreads) {
      float f[8];
      if (BLoad::kKContig) {
        const int n = v / (TBK / 8), kk = (v % (TBK / 8)) * 8;
        load_or_zero<8>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
        *reinterpret_cast<uint4*>(&Bs[n][kk]) = pack8(f);
      } else {
        const int kk = v / (TBN / 8), n = (v % (TBN / 8)) * 8;
        load_or_zero<8>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 8; ++u) Bs[n + u][kk] = __float2bfloat16_rn(f[u]);
      }
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
        if (m < M && n < Ncols) epi(z, m, n, acc[i][j][r]);
      }
}

// A strided operand: value(z, i, j) = round_R(src[(z / H) * zo + (z % H) * zi
// + i * si + j * sj]), (i, j) = (m, k) for A and (k, n) for B; one of si, sj
// is 1. z runs over (item, head) pairs; R = float leaves the value as it is.
template <typename S, typename R, bool KC>
struct Operand {
  static constexpr bool kKContig = KC;
  const S* p; int H; long long zo, zi, si, sj;
  template <int V>
  __device__ void vec(int z, int i, int j, float (&out)[V]) const {
    Vec<S, V>::load(p + (z / H) * zo + (z % H) * zi + i * si + j * sj, out);
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = rnd<R>(out[u]);
  }
};

// Epilogue: dst[(z / H) * zo + (z % H) * zi + m * sm + n] = D(acc * scale);
// store4 writes n..n+3 (the FMA GEMM's epilogue; D is float there).
template <typename D>
struct Store {
  D* p; int H; long long zo, zi, sm; float scale;
  __device__ void operator()(int z, int m, int n, float acc) const {
    p[(z / H) * zo + (z % H) * zi + m * sm + n] = from_f<D>(acc * scale);
  }
  __device__ void store4(int z, int m, int n, float a, float b, float c, float d) const {
    D* q = p + (z / H) * zo + (z % H) * zi + m * sm + n;
    if constexpr (sizeof(D) == 4) {
      *reinterpret_cast<float4*>(q) = make_float4(a * scale, b * scale, c * scale, d * scale);
    } else {
      q[0] = from_f<D>(a * scale), q[1] = from_f<D>(b * scale);
      q[2] = from_f<D>(c * scale), q[3] = from_f<D>(d * scale);
    }
  }
};

// The f32 FMA GEMM: 128 x 128 tiles, or 128 x 64 for a narrow product
// (N <= 64, the per-head D). gemm_lp<T> is for products of two model-dtype
// operands: tensor cores when T is bf16, FMA (true f32) when T is float.
template <typename A, typename B, typename E>
cudaError_t gemm(int M, int Ncols, int K, int Z, int kchunk, A a, B b, E e, cudaStream_t st) {
  if (Ncols <= 64)
    fgemm_kernel<8, 4><<<dim3((M + 127) / 128, (Ncols + 63) / 64, Z), kThreads, 0, st>>>(
        M, Ncols, K, kchunk, a, b, e);
  else
    fgemm_kernel<8, 8><<<dim3((M + 127) / 128, (Ncols + 127) / 128, Z), kThreads, 0, st>>>(
        M, Ncols, K, kchunk, a, b, e);
  return cudaGetLastError();
}

template <typename T, typename A, typename B, typename E>
cudaError_t gemm_lp(int M, int Ncols, int K, int Z, int kchunk, A a, B b, E e, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    bmma_kernel<<<dim3((M + TBM - 1) / TBM, (Ncols + TBN - 1) / TBN, Z), kThreads, 0, st>>>(
        M, Ncols, K, kchunk, a, b, e);
    return cudaGetLastError();
  } else {
    return gemm(M, Ncols, K, Z, kchunk, a, b, e, st);
  }
}

// P (rows, S) of scaled logits -> wf = e / sum(e), e = exp(l - max), in place.
// One warp per row.
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(float* __restrict__ P, long long rows, int S) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  float* p = P + row * S;
  float m = -INFINITY;
  for (int j = lane; j < S; j += 32) m = fmaxf(m, p[j]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int j = lane; j < S; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  for (int j = lane; j < S; j += 32) p[j] = p[j] / sum;
}

// dP (rows, S) -> ds = (wf * (dp - sum_j dp_j * T(wf_j))) * scale, in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_rows_kernel(const float* __restrict__ P, float* __restrict__ dP, long long rows,
                        int S, float scale) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* w = P + row * S;
  float* d = dP + row * S;
  float s = 0.f;
  for (int j = lane; j < S; j += 32) s = fmaf(d[j], rnd<T>(w[j]), s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  for (int j = lane; j < S; j += 32) d[j] = __fmul_rn(__fmul_rn(w[j], d[j] - s), scale);
}

}  // namespace
