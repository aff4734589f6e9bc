// Forward of the UNet AttentionBlock on Hopper (sm_90a):
//   y = x + OutProj(MHA(QKVProj(GroupNorm(x))))
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_attn_block.py:_fwd_kernel
// (launched by _fwd_impl). It computes the same function with the same
// rounding points as that kernel, which its plain PyTorch version
// (cfm_tpu_torch/ops/attn_block.py:attention_block_reference) spells out:
//   - GroupNorm statistics in f32, two passes (mean, then centred variance);
//   - tokens rounded to the model dtype T;
//   - qkv = round_T(tokens_T @ round_T(wq), f32 accumulate) + round_T(bq),
//     the add done in f32 and rounded to T;
//   - per head: logits in f32 times 1/sqrt(D), softmax in f32 as e / sum(e),
//     the weights rounded to T, then w @ v accumulated in f32;
//   - the concatenated context rounded to T;
//   - y = T(x + (ctx_T @ round_T(wo) + bo)), all in f32 before the cast.
// T is float or __nv_bfloat16. Products of T values are exact in f32, so an
// f32 FMA on rounded operands is the TPU's "T inputs, f32 accumulate".
//
// What bounds it on this card. Per batch item at the CIFAR-10 recipe shape
// (S=256, C=256, H=4, D=64) the work is ~201 MFLOP against 256 KB of x and y
// in bf16: ~800 FLOP per byte, far above the H100's ~295 FLOP/byte ridge, so
// the bound is arithmetic (tensor-core peak). One item does not fit one SM
// the way it fits the TPU's VMEM (x is 128 KB in bf16, wq 384 KB, against
// 227 KB of shared memory), so the TPU kernel's "whole item resident" plan
// is not carried over. The design is a chain of kernels on one stream, each
// tiled for shared memory:
//   (a) gn_stats:  per (item, group) mean and 1/std, two passes, f32;
//   (b) qkv GEMM:  GroupNorm applied and rounded as the A tile is loaded,
//                  bias epilogue; writes qkv (N, S, 3HD) in T;
//   (c) attention: per (item, head, query tile), softmax over all S keys;
//                  writes the context (N, S, HD) in T;
//   (d) out GEMM:  out projection with the bias and residual epilogue.
// qkv and the context make one round trip to device memory each, small
// beside the arithmetic at the recipe shape.
//
// Two arithmetic paths, chosen by T:
//   - float: plain f32 FMAs on shared-memory tiles (a tensor core would make
//     the products TF32, and f32 mode must be true f32). The weights are
//     read as f32 and rounded on load (a no-op for T = float).
//   - bf16: tensor cores through mma.sync m16n8k16 (bf16 inputs, f32
//     accumulate: the TPU's "bf16 inputs, f32 accumulate"). The weights are
//     first rounded to bf16 and transposed into scratch (prep kernel), so the
//     GEMM B tiles are K-contiguous bf16. The attention keeps no row of
//     logits: it recomputes them per 64-key tile in three passes (row max,
//     row sum of exp, then w = exp(l - max) / sum rounded to bf16 and w @ v),
//     which is the exact e / sum(e) softmax for any S at a third more FLOPs.
//     Head dims other than 64 and 128 use the FMA attention kernel.
// Neither path uses TMA, wgmma or a software pipeline yet: that is later
// work (PERF.md holds the times against the bound).

#include "attn_block_common.cuh"

namespace {

// (c) attention for one (query tile, head, item). Dynamic shared memory:
// q tile QT x D, the f32 logits/weights QT x S, one K or V tile KT x (D+1).
constexpr int QT = 32, KT = 64, DC = 64;  // DC: output columns per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ ctx,
                 int S, int H, int D, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // QT * D
  float* P = Qs + QT * D;           // QT * S
  float* KV = P + QT * S;           // KT * (D + 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, n = blockIdx.z;
  const int HD = H * D, ld = 3 * HD;
  const T* base = qkv + (size_t)n * S * ld;
  const int qcol = h * D, kcol = (H + h) * D, vcol = (2 * H + h) * D;

  for (int e = tid; e < QT * D; e += kThreads) {
    const int qi = e / D, d = e % D, s = q0 + qi;
    Qs[e] = s < S ? to_f<T>(base[(size_t)s * ld + qcol + d]) : 0.f;
  }
  // Logits for every key, one key tile at a time.
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * D; e += kThreads) {
      const int kj = e / D, d = e % D, s = k0 + kj;
      KV[kj * (D + 1) + d] = s < S ? to_f<T>(base[(size_t)s * ld + kcol + d]) : 0.f;
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
        KV[kj * (DC + 1) + d] = s < S ? to_f<T>(base[(size_t)s * ld + vcol + d0 + d]) : 0.f;
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
      if (s < S) ctx[((size_t)n * S + s) * HD + h * D + d0 + dcol] = from_f<T>(acc[i]);
    }
  }
}

size_t attention_smem(int S, int D) {
  return sizeof(float) * ((size_t)QT * D + (size_t)QT * S + (size_t)KT * (D + 1));
}

// (c) attention on tensor cores for one (64-query tile, head, item): 4 warps
// of 16 query rows each, keys in tiles of 64 staged in shared memory (K as
// is, V transposed so both are B operands with contiguous k). Three passes
// over the key tiles recompute the same logits bit for bit: the row max, the
// row sum of exp(l - max), then the rounded weights times V.
constexpr int AQ = 64, AK = 64;

template <int D>
__global__ void __launch_bounds__(128)
attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int S, int H,
                     float scale) {
  __shared__ __align__(16) bf16 Ks[AK][D + 8];
  __shared__ __align__(16) bf16 Vt[D][AK + 8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * AQ + warp * 16, h = blockIdx.y, n = blockIdx.z;
  const int HD = H * D, ld = 3 * HD;
  const bf16* base = qkv + (size_t)n * S * ld;
  const bf16* kbase = base + (H + h) * D;
  const bf16* vbase = base + (2 * H + h) * D;

  // This warp's 16 query rows as A fragments, kept in registers.
  uint32_t qa[D / 16][4];
  {
    const int r0 = q0 + g, r1 = q0 + g + 8;
    const bf16* p0 = base + (size_t)r0 * ld + h * D;
    const bf16* p1 = base + (size_t)r1 * ld + h * D;
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      const int c = kt * 16 + 2 * t;
      qa[kt][0] = r0 < S ? ld32(p0 + c) : 0u;
      qa[kt][1] = r1 < S ? ld32(p1 + c) : 0u;
      qa[kt][2] = r0 < S ? ld32(p0 + c + 8) : 0u;
      qa[kt][3] = r1 < S ? ld32(p1 + c + 8) : 0u;
    }
  }

  auto load_k = [&](int k0) {
    for (int c = tid; c < AK * D / 8; c += 128) {
      const int kj = c / (D / 8), d = (c % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(&Ks[kj][d]) =
          k0 + kj < S ? *reinterpret_cast<const uint4*>(kbase + (size_t)(k0 + kj) * ld + d)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  auto load_v = [&](int k0) {
    for (int c = tid; c < AK * D / 8; c += 128) {
      const int kj = c % AK, d = (c / AK) * 8;
      uint4 raw = k0 + kj < S ? *reinterpret_cast<const uint4*>(vbase + (size_t)(k0 + kj) * ld + d)
                              : make_uint4(0, 0, 0, 0);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) Vt[d + u][kj] = v[u];
    }
  };
  // Logits of this warp's rows against the staged key tile, scaled, with
  // keys past S at -inf. l[j][0..1]: row g, keys 8j+2t..; l[j][2..3]: row g+8.
  auto logits = [&](int k0, float (&l)[AK / 8][4]) {
#pragma unroll
    for (int j = 0; j < AK / 8; ++j) {
      l[j][0] = l[j][1] = l[j][2] = l[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < D / 16; ++kt)
        mma_bf16(l[j], qa[kt], ld32(&Ks[j * 8 + g][kt * 16 + 2 * t]),
                 ld32(&Ks[j * 8 + g][kt * 16 + 2 * t + 8]));
#pragma unroll
      for (int r = 0; r < 4; ++r)
        l[j][r] = k0 + j * 8 + 2 * t + (r & 1) < S ? l[j][r] * scale : -INFINITY;
    }
  };
  auto quad_max = [](float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  float l[AK / 8][4];
  float mx[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < S; k0 += AK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    logits(k0, l);
#pragma unroll
    for (int j = 0; j < AK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) mx[r >> 1] = fmaxf(mx[r >> 1], l[j][r]);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);

  float sum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += AK) {
    __syncthreads();
    load_k(k0);
    __syncthreads();
    logits(k0, l);
#pragma unroll
    for (int j = 0; j < AK / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) sum[r >> 1] += expf(l[j][r] - mx[r >> 1]);
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int k0 = 0; k0 < S; k0 += AK) {
    __syncthreads();
    load_k(k0);
    load_v(k0);
    __syncthreads();
    logits(k0, l);
#pragma unroll
    for (int kt = 0; kt < AK / 16; ++kt) {
      float w[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[u][r] = expf(l[2 * kt + u][r] - mx[r >> 1]) / sum[r >> 1];
      const uint32_t a[4] = {pack_bf16(w[0][0], w[0][1]), pack_bf16(w[0][2], w[0][3]),
                             pack_bf16(w[1][0], w[1][1]), pack_bf16(w[1][2], w[1][3])};
#pragma unroll
      for (int dj = 0; dj < D / 8; ++dj)
        mma_bf16(o[dj], a, ld32(&Vt[dj * 8 + g][kt * 16 + 2 * t]),
                 ld32(&Vt[dj * 8 + g][kt * 16 + 2 * t + 8]));
    }
  }
#pragma unroll
  for (int dj = 0; dj < D / 8; ++dj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = q0 + g + 8 * half;
      if (s < S)
        *reinterpret_cast<uint32_t*>(ctx + ((size_t)n * S + s) * HD + h * D + dj * 8 + 2 * t) =
            pack_bf16(o[dj][2 * half], o[dj][2 * half + 1]);
    }
}

template <typename T>
int launch_fma_attention(const T* qkv, T* ctx, int N, int S, int H, int D, float scale,
                         cudaStream_t stream) {
  const size_t smem = attention_smem(S, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  attention_kernel<T><<<dim3((S + QT - 1) / QT, H, N), kThreads, smem, stream>>>(
      qkv, ctx, S, H, D, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* x, const float* gscale, const float* gbias, const float* wq,
                const float* bq, const float* wo, const float* bo, bf16* y, const float* mean,
                const float* rstd, bf16* qkv, bf16* ctx, bf16* wqt, bf16* wot, int N, int S,
                int C, int H, int G, float scale, cudaStream_t stream) {
  const int D = C / H, HD = H * D, M = N * S;
  cudaError_t err;
  round_transpose_kernel<<<(C * 3 * HD + 255) / 256, 256, 0, stream>>>(wq, wqt, C, 3 * HD);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  round_transpose_kernel<<<(HD * C + 255) / 256, 256, 0, stream>>>(wo, wot, HD, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  mma_gemm_kernel<<<dim3((M + TBM - 1) / TBM, (3 * HD + TBN - 1) / TBN), kThreads, 0, stream>>>(
      M, 3 * HD, C, GnTokens8{x, mean, rstd, gscale, gbias, S, C, G, C / G}, wqt,
      QkvOut<bf16>{qkv, bq, 3 * HD});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const dim3 ga((S + AQ - 1) / AQ, H, N);
  if (D == 64)
    attention_mma_kernel<64><<<ga, 128, 0, stream>>>(qkv, ctx, S, H, scale);
  else if (D == 128)
    attention_mma_kernel<128><<<ga, 128, 0, stream>>>(qkv, ctx, S, H, scale);
  else if ((err = (cudaError_t)launch_fma_attention<bf16>(qkv, ctx, N, S, H, D, scale, stream)))
    return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  mma_gemm_kernel<<<dim3((M + TBM - 1) / TBM, (C + TBN - 1) / TBN), kThreads, 0, stream>>>(
      M, C, HD, Rows8{ctx, HD}, wot, ResidualOut<bf16>{x, y, bo, C});
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* gscale, const float* gbias, const float* wq,
               const float* bq, const float* wo, const float* bo, float* y, const float* mean,
               const float* rstd, float* qkv, float* ctx, int N, int S, int C, int H, int G,
               float scale, cudaStream_t stream) {
  const int D = C / H, HD = H * D, M = N * S;
  cudaError_t err;
  gemm_kernel<<<dim3((M + BM - 1) / BM, (3 * HD + BN - 1) / BN), kThreads, 0, stream>>>(
      M, 3 * HD, C, GnTokens<float>{x, mean, rstd, gscale, gbias, S, C, G, C / G},
      RoundedWeight<float>{wq, 3 * HD}, QkvOut<float>{qkv, bq, 3 * HD});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = (cudaError_t)launch_fma_attention<float>(qkv, ctx, N, S, H, D, scale, stream)))
    return (int)err;
  gemm_kernel<<<dim3((M + BM - 1) / BM, (C + BN - 1) / BN), kThreads, 0, stream>>>(
      M, C, HD, Rows<float>{ctx, HD}, RoundedWeight<float>{wo, C},
      ResidualOut<float>{x, y, bo, C});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the FMA attention kernel needs; the wrapper refuses shapes
// above the card's per-block limit before launching.
size_t attn_block_fwd_smem(int S, int D) { return attention_smem(S, D); }

// x, y: (N, S, C) in the model dtype (0 = float32, 1 = bfloat16), contiguous
// and 16-byte aligned. gscale, gbias, bo: (C,) f32; wq: (C, 3HD) f32; bq:
// (3HD,) f32; wo: (HD, C) f32. Scratch: stats 2*N*G f32, qkv N*S*3HD and ctx
// N*S*HD in the model dtype; for bfloat16 also wqt (3HD*C) and wot (C*HD)
// bf16 (unused for float32). Returns 0 or the first CUDA error code.
int attn_block_fwd(const void* x, const float* gscale, const float* gbias,
                   const float* wq, const float* bq, const float* wo, const float* bo,
                   void* y, float* stats, void* qkv, void* ctx, void* wqt, void* wot,
                   int N, int S, int C, int H, int G, float scale, int dtype,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mean = stats;
  float* rstd = stats + (size_t)N * G;
  cudaError_t err;
  if (dtype == 0) {
    gn_stats_kernel<float><<<N * G, kThreads, 0, st>>>(static_cast<const float*>(x), mean, rstd,
                                                       S, C, G, 1e-5f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return launch_f32(static_cast<const float*>(x), gscale, gbias, wq, bq, wo, bo,
                      static_cast<float*>(y), mean, rstd, static_cast<float*>(qkv),
                      static_cast<float*>(ctx), N, S, C, H, G, scale, st);
  }
  if (dtype == 1) {
    gn_stats_kernel<bf16><<<N * G, kThreads, 0, st>>>(static_cast<const bf16*>(x), mean, rstd,
                                                      S, C, G, 1e-5f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return launch_bf16(static_cast<const bf16*>(x), gscale, gbias, wq, bq, wo, bo,
                       static_cast<bf16*>(y), mean, rstd, static_cast<bf16*>(qkv),
                       static_cast<bf16*>(ctx), static_cast<bf16*>(wqt),
                       static_cast<bf16*>(wot), N, S, C, H, G, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
