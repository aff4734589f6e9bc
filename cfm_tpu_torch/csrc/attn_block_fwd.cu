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
//                  writes the context (N, S, HD) in T (attn_block_common.cuh,
//                  shared with the multi-head attention kernel #3);
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

// Stage (c)'s rows in the (N, S, 3HD) qkv buffer and the (N, S, HD) context.
AttnLayout block_layout(int S, int H, int D) {
  const int HD = H * D;
  return AttnLayout{S * 3 * HD, D, HD, 3 * HD, S * HD, D, HD};
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

  if ((err = (cudaError_t)launch_attention<bf16>(qkv, ctx, block_layout(S, H, D), N, S, H, D,
                                                 scale, stream)))
    return (int)err;

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
  if ((err = (cudaError_t)launch_attention<float>(qkv, ctx, block_layout(S, H, D), N, S, H, D,
                                                  scale, stream)))
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
