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
// tiled for shared memory. bf16 (the paths' dtype), five launches a call:
//   (a) GroupNorm: the strip kernel of #8 (gn_strip.cuh) with this block's
//       epilogue: a strip of whole groups read once by TMA into shared
//       memory (a cluster splitting its rows where one block cannot hold
//       it), the two-pass statistics on chip, then the tokens
//       round_T((((x - mean) * rstd) * gscale) + gbias), each step rounded
//       as the TPU kernel rounds, written once as a bf16 (N, S, C) buffer
//       (the context's scratch, free until stage (c)). Writing them costs
//       2 N S C bytes each way (0.04 ms at 3.35 TB/s at N = 512) and lets
//       stage (b) load its A tiles by TMA; forming them in registers as
//       wgmma's A operand would repeat the GroupNorm for each of the
//       3HD / 128 column tiles.
//   (w) the weights rounded to bf16 as they lie, wq and wo in one launch:
//       wgmma reads a (K, N) row-major weight tile MN-major, so nothing is
//       transposed;
//   (b) qkv GEMM: TMA + wgmma (sm90_gemm.cuh), the bias epilogue
//       qkv = T(round_T(acc) + round_T(bq)), written (N, S, 3HD);
//   (c) attention: kernel #3's attention_resident (S <= 256) or
//       attention_streamed (sm90_attention_fwd.cuh) through BlockLayout:
//       rank-3 tensor maps over (N, S, 3HD) and (N, S, HD), so a ragged S
//       loads zeros past an item's rows, masks those keys and stores no
//       row past S. Their softmax is exp2 of the logits scaled by
//       scale * log2 e, times the correctly rounded reciprocal of the sum:
//       a bf16 weight differs from e / sum(e)'s only at a rounding tie
//       (tests/test_torch_attn_block.py counts them). Head dims other than
//       64 and 128 run the FMA attention kernel (attn_block_common.cuh);
//   (d) out GEMM: the same kernel with y = T(x + (acc + bo)).
// float32 keeps the FMA path (a tensor core would make the products TF32):
// gn_stats, the tiled FMA GEMM with GroupNorm applied on load, the FMA
// attention kernel, the FMA out GEMM (attn_block_common.cuh).
//
// The GEMM of (b) and (d) (M x Nc = A (M x K) B (K x Nc), bf16, f32
// accumulate) is sm90_gemm.cuh's: TMA ring, one producer warp, two consumer
// warpgroups on wgmma m64n128k16, shared with the backward #2.

#include "attn_block_common.cuh"
#include "gn_strip.cuh"
#include "sm90_attention_fwd.cuh"
#include "sm90_gemm.cuh"

namespace {

// Stage (c)'s rows in the (N, S, 3HD) qkv buffer and the (N, S, HD) context,
// for the FMA attention kernel.
AttnLayout block_layout(int S, int H, int D) {
  const int HD = H * D;
  return AttnLayout{S * 3 * HD, D, HD, 3 * HD, S * HD, D, HD};
}

// (a)'s epilogue: the tokens, rounded as GnTokens rounds them.
struct TokensOut {
  bf16* out;
  const float* scale;
  const float* bias;
  __device__ void stats(size_t, float, float) const {}
  __device__ static float apply(float x, float mu, float inv, float sc, float bi) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), inv), sc), bi);
  }
};

// (d) epilogue: y = T(x + (acc + bo)).
struct ResidualEpi {
  static constexpr int kMode = 0, kParts = 1;
  const bf16* x;
  const float* bo;
  int ld, M;
  __device__ int part_col(int) const { return 0; }
  __device__ float2 operator()(float a0, float a1, int m, int n) const {
    if (m >= M) return make_float2(0.f, 0.f);
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * ld + n));
    return make_float2(xv.x + (a0 + bo[n]), xv.y + (a1 + bo[n + 1]));
  }
};

int launch_bf16(const bf16* x, const float* gscale, const float* gbias, const float* wq,
                const float* bq, const float* wo, const float* bo, bf16* y, bf16* qkv, bf16* ctx,
                bf16* wb, int N, int S, int C, int H, int G, float scale,
                const gnstrip::Plan& plan, cudaStream_t stream) {
  const int D = C / H, HD = H * D, M = N * S;
  if (C % 128 || D % 64) return (int)cudaErrorInvalidValue;
  if (int e = gnstrip::launch<bf16>(x, TokensOut{ctx, gscale, gbias}, N, S, C, G, plan, 1e-5f,
                                    stream))
    return e;
  if (int e = sm90::round_weights(wq, wo, wb, C, HD, stream)) return e;
  bf16* wqb = wb;
  bf16* wob = wb + (size_t)C * 3 * HD;
  if (int e = sm90::tma_gemm(ctx, wqb, 0, qkv, 3 * HD, M, 3 * HD, C, sm90::BiasEpi{bq}, stream))
    return e;
  if (D == 64 || D == 128) {
    CUtensorMap qkv_map, ctx_map;
    if (int e = sm90::make_item_map(&qkv_map, qkv, 3 * HD, S, N)) return e;
    if (int e = sm90::make_item_map(&ctx_map, ctx, HD, S, N)) return e;
    const sm90::BlockLayout lay{H, S};
    if (int e = D == 64 ? sm90::launch_tensor_core<64>(qkv_map, ctx_map, lay, N, scale, stream)
                        : sm90::launch_tensor_core<128>(qkv_map, ctx_map, lay, N, scale, stream))
      return e;
  } else if (int e = launch_attention<bf16>(qkv, ctx, block_layout(S, H, D), N, S, H, D, scale,
                                            stream)) {
    return e;
  }
  return sm90::tma_gemm(ctx, wob, 0, y, C, M, C, HD, ResidualEpi{x, bo, C, M}, stream);
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

// Shared memory the attention stage needs (0 = float32, 1 = bfloat16); the
// wrapper refuses shapes above the card's per-block limit before launching.
size_t attn_block_fwd_smem(int S, int D, int dtype) {
  if (dtype == 1 && D == 64) return sm90::tensor_core_smem<64>(S);
  if (dtype == 1 && D == 128) return sm90::tensor_core_smem<128>(S);
  return attention_smem(S, D);
}

// x, y: (N, S, C) in the model dtype (0 = float32, 1 = bfloat16), contiguous
// and 16-byte aligned. gscale, gbias, bo: (C,) f32; wq: (C, 3HD) f32; bq:
// (3HD,) f32; wo: (HD, C) f32, wq and wo 16-byte aligned. Scratch: qkv
// N*S*3HD and ctx N*S*HD in the model dtype; for float32 stats 2*N*G f32,
// for bfloat16 wb 4*C*C bf16 (the rounded weights) and the GroupNorm plan
// (width, cluster, items, rows, box_rows, boxes) of strip_plan. Returns 0 or
// the first CUDA error code.
int attn_block_fwd(const void* x, const float* gscale, const float* gbias, const float* wq,
                   const float* bq, const float* wo, const float* bo, void* y, float* stats,
                   void* qkv, void* ctx, void* wb, int N, int S, int C, int H, int G, float scale,
                   int dtype, int width, int cluster, int items, int rows, int box_rows,
                   int boxes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    float* mean = stats;
    float* rstd = stats + (size_t)N * G;
    gn_stats_kernel<float><<<N * G, kThreads, 0, st>>>(static_cast<const float*>(x), mean, rstd,
                                                       S, C, G, 1e-5f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_f32(static_cast<const float*>(x), gscale, gbias, wq, bq, wo, bo,
                      static_cast<float*>(y), mean, rstd, static_cast<float*>(qkv),
                      static_cast<float*>(ctx), N, S, C, H, G, scale, st);
  }
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(x), gscale, gbias, wq, bq, wo, bo,
                       static_cast<bf16*>(y), static_cast<bf16*>(qkv), static_cast<bf16*>(ctx),
                       static_cast<bf16*>(wb), N, S, C, H, G, scale,
                       gnstrip::Plan{width, cluster, items, rows, box_rows, boxes}, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
