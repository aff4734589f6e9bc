// Multi-head self-attention forward on Hopper (sm_90a), on the kernel layout
//   qkv_t (N, 3, H, S, D) -> out (N, H, S, D),
//   out[n, h] = T(T(softmax(q k^T * scale)) @ v).
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_attention.py:_fwd_kernel
// (launched by _fused_attention_t_fwd_impl, and between two transposes by
// _fused_attention_fwd_impl). It computes the same function with the same
// rounding points, which its plain PyTorch version
// (cfm_tpu_torch/ops/attention.py:attn_reference_t) spells out: the logits
// q k^T * scale in f32 from model-dtype q and k, the softmax e / sum(e),
// e = exp(l - max), in f32, the weights rounded to the model dtype T, then
// w @ v accumulated in f32 and rounded to T.
//
// The arithmetic is the attention block's stage (c) (attn_block_common.cuh),
// run here on the (N, 3, H, S, D) layout: one block per (query tile, head,
// item), keys in tiles of 64. bf16 at head dims 64 and 128 runs on tensor
// cores (mma.sync m16n8k16, f32 accumulate) and recomputes each key tile's
// logits in three passes (row max, row sum, then the rounded weights times
// V), which keeps the exact e / sum(e): an online (flash) softmax would
// rescale partial sums and never round e / sum(e) element by element, a
// different function. float, and other head dims, run on f32 FMA (a tensor
// core would make f32 products TF32).
//
// What bounds it on this card. At the ImageNet-64 training shape (N=32,
// H=9, S=256, D=64, bf16) the function moves 37.7 MB (qkv in, out) and does
// 4.8 GFLOP (9.7 with the three-pass recompute): bytes bound it, at about
// 0.011 ms. This version reads each (item, head)'s K tiles three times and
// V once from L2 per query tile and keeps no pipeline: no TMA, wgmma or
// cp.async yet (PERF.md holds its time against the bound).

#include "attn_block_common.cuh"

extern "C" {

// Shared memory the kernel needs at this shape and dtype (0 = float32,
// 1 = bfloat16); the wrapper refuses shapes above the card's per-block limit.
size_t attention_fwd_smem(int S, int D, int dtype) {
  return dtype == 1 && (D == 64 || D == 128) ? 0 : attention_smem(S, D);
}

// qkv: (N, 3, H, S, D), out: (N, H, S, D), both contiguous in the model
// dtype and 16-byte aligned; D a multiple of 64. Returns 0 or the first
// CUDA error code.
int attention_fwd(const void* qkv, void* out, int N, int H, int S, int D, float scale, int dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int SD = S * D;
  const AttnLayout L{3 * H * SD, SD, H * SD, D, H * SD, SD, D};
  if (dtype == 0)
    return launch_attention<float>(static_cast<const float*>(qkv), static_cast<float*>(out), L,
                                   N, S, H, D, scale, st);
  if (dtype == 1)
    return launch_attention<bf16>(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), L, N,
                                  S, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
