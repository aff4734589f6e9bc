// Multi-head self-attention backward on Hopper (sm_90a), recomputing the
// forward from the saved qkv_t:
//   given qkv_t (N, 3, H, S, D) and the output gradient do (N, H, S, D),
//   both in the model dtype T, return dqkv_t (N, 3, H, S, D) in T.
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_attention.py:_bwd_kernel
// (launched by _fused_attention_t_vjp_bwd and _fused_attention_vjp_bwd). It
// computes the same function with the same rounding points, which its plain
// PyTorch version (cfm_tpu_torch/ops/attention.py:attention_t_bwd_reference)
// spells out, per (item, head):
//   - q, k, v and do upcast from T; the logits q k^T * scale in f32, the f32
//     softmax wf = e / sum(e), and w = T(wf);
//   - dv = w^T @ do, dp = do @ v^T, both in f32;
//   - dw = dp - rowsum(dp * w), taken directly (not as rowsum(do * o));
//     ds = (wf * dw) * scale with the unrounded wf;
//   - dq = ds @ k, dk = ds^T @ q with f32 ds;
//   - dq, dk, dv rounded to T.
//
// The stages are those of the attention-block backward (#2), shared through
// attn_block_common.cuh: one batched GEMM over all (item, head) pairs per
// product, the (S, S) logits and their gradient written to scratch, and two
// softmax row passes over them. Products of two model-dtype operands (the
// logits, dp and dv: do is model-dtype-valued here) run on bf16 tensor cores
// (mma.sync, f32 accumulate) when T is bf16, exact products with only the
// accumulation order changed; the two with the f32 operand ds (dq and dk)
// run on f32 FMA in both dtypes, since rounding ds to bf16 to feed a tensor
// core would change the function. When T is float every product is f32 FMA.
//
// What bounds it on this card. At the ImageNet-64 training shape (N=32,
// H=9, S=256, D=64, bf16) the five products are 2.4 GFLOP each: three with
// bf16 operands at the tensor-core rate (about 0.007 ms) and two with an f32
// operand at the non-tensor f32 rate (about 0.072 ms), against 66.1 MB of
// qkv, do and dqkv (0.020 ms): operations bound it. This version adds two
// round trips of the f32 (S, S) scratch (75.5 MB each at that shape); no
// TMA, wgmma or fused flash-style pass yet (PERF.md holds its time against
// the bound).

#include "attn_block_common.cuh"

namespace {

template <typename T>
int launch(const T* qkv, const T* dout, T* dqkv, float* P, float* dP, int N, int H, int S, int D,
           float scale, cudaStream_t st) {
  const int Z = N * H;
  const long long SS = (long long)S * S, SD = (long long)S * D, HSD = H * SD, item = 3 * HSD;
  const T* k = qkv + HSD;
  const T* v = qkv + 2 * HSD;
  cudaError_t err;
  // wf = softmax(q k^T * scale), in place in P.
  if ((err = gemm_lp<T>(S, S, D, Z, 0, Operand<T, float, true>{qkv, H, item, SD, D, 1},
                        Operand<T, float, true>{k, H, item, SD, 1, D},
                        Store<float>{P, 1, SS, 0, S, scale}, st)) != cudaSuccess)
    return (int)err;
  const long long rows = (long long)Z * S;
  const int row_blocks = (int)((rows + kThreads / 32 - 1) / (kThreads / 32));
  softmax_rows_kernel<<<row_blocks, kThreads, 0, st>>>(P, rows, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dp = do @ v^T, then ds in place in dP.
  if ((err = gemm_lp<T>(S, S, D, Z, 0, Operand<T, float, true>{dout, H, HSD, SD, D, 1},
                        Operand<T, float, true>{v, H, item, SD, 1, D},
                        Store<float>{dP, 1, SS, 0, S, 1.f}, st)) != cudaSuccess)
    return (int)err;
  softmax_bwd_rows_kernel<T><<<row_blocks, kThreads, 0, st>>>(P, dP, rows, S, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dq = ds @ k and dk = ds^T @ q on f32 FMA; dv = T(wf)^T @ do.
  if ((err = gemm(S, D, S, Z, 0, Operand<float, float, true>{dP, 1, SS, 0, S, 1},
                  Operand<T, float, false>{k, H, item, SD, D, 1},
                  Store<T>{dqkv, H, item, SD, D, 1.f}, st)) != cudaSuccess)
    return (int)err;
  if ((err = gemm(S, D, S, Z, 0, Operand<float, float, false>{dP, 1, SS, 0, 1, S},
                  Operand<T, float, false>{qkv, H, item, SD, D, 1},
                  Store<T>{dqkv + HSD, H, item, SD, D, 1.f}, st)) != cudaSuccess)
    return (int)err;
  return (int)gemm_lp<T>(S, D, S, Z, 0, Operand<float, T, false>{P, 1, SS, 0, 1, S},
                         Operand<T, float, false>{dout, H, HSD, SD, D, 1},
                         Store<T>{dqkv + 2 * HSD, H, item, SD, D, 1.f}, st);
}

}  // namespace

extern "C" {

// Bytes of scratch the wrapper must pass: the f32 (S, S) softmax and its
// gradient for each of the N * H (item, head) pairs.
size_t attention_bwd_workspace(int N, int H, int S) {
  return 2 * sizeof(float) * (size_t)N * H * S * S;
}

// qkv, dqkv: (N, 3, H, S, D); dout: (N, H, S, D); all contiguous in the model
// dtype (0 = float32, 1 = bfloat16) and 16-byte aligned, S a multiple of 8
// and D a multiple of 64. ws: attention_bwd_workspace bytes. Returns 0 or
// the first CUDA error code.
int attention_bwd(const void* qkv, const void* dout, void* dqkv, void* ws, int N, int H, int S,
                  int D, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* P = static_cast<float*>(ws);
  float* dP = P + (size_t)N * H * S * S;
  if (dtype == 0)
    return launch<float>(static_cast<const float*>(qkv), static_cast<const float*>(dout),
                         static_cast<float*>(dqkv), P, dP, N, H, S, D, scale, st);
  if (dtype == 1)
    return launch<bf16>(static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                        static_cast<bf16*>(dqkv), P, dP, N, H, S, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
