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
// What bounds it on this card. At the ImageNet-64 training shape (N=32,
// H=9, S=256, D=64, bf16) each S x S x D product is 2.42 GFLOP. The
// function needs the logits, dp and dv from bf16 operands (3 products) and
// dq and dk from the f32 ds, which the card can do exactly as three bf16
// products each (below): 9 products, 21.7 GFLOP, 0.0220 ms at 989 TFLOP/s,
// against 66.1 MB of qkv, do and dqkv, 0.0197 ms at 3.35 TB/s. Operations
// bound it, barely. The kernels recompute (14 products) rather than keep
// any S x S tensor in device memory, as the TPU kernel keeps it in VMEM.
//
// bf16 at head dims 64 and 128 (attention_bwd_fused) is two launches, one
// warpgroup a block, tiles by TMA into 128-byte-swizzled shared memory on
// mbarriers, every product a wgmma m64n64k16, every output tile stored by
// TMA (attention_fwd.cu's note). The kernels are in sm90_attention_bwd.cuh,
// where a layout policy (HeadsBwd here) lets the attention-block backward
// #2 run them on its own buffers with an f32 do split in three:
// - (B) one block per 64 query rows: dq and the row statistics (max, sum,
//   delta: three f32 (N, H, S) vectors, 0.9 MB at the path's shape).
//   attention_bwd_rows_resident, at S <= 256 and D = 64 (the path): all of
//   K and V resident, the whole logits row in registers, so the exact row
//   max and sum take one pass and wf one exponential an element; dp is
//   computed for delta = rowsum(dp * w), taken directly as the TPU kernel
//   does, and again for ds = (wf * (dp - delta)) * scale and dq += ds k.
//   attention_bwd_rows elsewhere: K and V stream through a ring, pass 0
//   takes the row max and a rescaled running sum (f32 rounding apart from
//   the direct sum), passes 1 and 2 recompute the logits for delta and ds.
// - (A) attention_bwd_cols, one block per 64 keys, over the query tiles
//   (Q, do and their statistics through a ring, the statistics by a bulk
//   copy): recomputes k q^T, rebuilds wf and w from the statistics,
//   accumulates dv += w^T do (its products overlap the split below),
//   forms dp^T = v do^T and ds^T, and accumulates dk += ds^T q. Each block
//   writes its own dk and dv rows once.
// No atomics and no S x S scratch: a rerun gives the same bits. The
// exponentials and weights are the forward's (attention_fwd.cu's note).
//
// dq and dk from the f32 ds: ds = hi + mid + lo, each part bf16 and the sum
// exact (sm90_attention.cuh, to_split_frags), so ds k is three bf16
// tensor-core products whose terms are exact and only the f32 accumulation
// rounds. Rounding ds once to bf16 would move the gradients by 1e-3 of
// their max-abs (chip_smoke.py), a different function. The split is the
// route the wrapper takes: on an H100 the other variant (split = 0: the ds
// tile through shared memory, f32 FMA) took three times as long in the same
// call (chip_smoke.py phase 4 times both; PERF.md).
//
// float32, and other head dims, keep the staged route of the attention-block
// backward (#2), shared through attn_block_common.cuh: one batched GEMM over
// all (item, head) pairs per product, the (S, S) logits and their gradient
// in scratch, two softmax row passes; every product on f32 FMA in f32, the
// bf16-operand ones on mma.sync in bf16. No path runs it in bf16.

#include "attn_block_common.cuh"
#include "sm90_attention_bwd.cuh"

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

// Bytes of scratch the staged route needs: the f32 (S, S) softmax and its
// gradient for each of the N * H (item, head) pairs.
size_t attention_bwd_workspace(int N, int H, int S) {
  return 2 * sizeof(float) * (size_t)N * H * S * S;
}

// qkv, dqkv: (N, 3, H, S, D); dout: (N, H, S, D); all contiguous in the model
// dtype (0 = float32, 1 = bfloat16) and 16-byte aligned, S a multiple of 8
// and D a multiple of 64. ws: attention_bwd_workspace bytes. The staged
// route. Returns 0 or the first CUDA error code.
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

// Dynamic shared memory of the fused kernels at (S, D), D = 64 or 128 (the
// larger of the two kernels').
size_t attention_bwd_fused_smem(int S, int D, int split) {
  return sm90::bwd_fused_smem<sm90::HeadsBwd>(S, D, split != 0);
}

// The fused bf16 route: qkv, dqkv (N, 3, H, S, D), dout (N, H, S, D),
// contiguous bf16; D = 64 or 128; S a multiple of 64; stats 3 N H S f32.
// split = 1 computes dq and dk as three exact bf16 products, 0 on f32 FMA.
// Returns 0 or the first CUDA error code.
int attention_bwd_fused(const void* qkv, const void* dout, void* dqkv, void* stats, int N, int H,
                        int S, int D, float scale, int split, void* stream) {
  if (S % 64 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const sm90::BwdArgs args{static_cast<float*>(stats), scale, (long long)N * H * S};
  const sm90::HeadsBwd lay{H, S};
  CUtensorMap qkv_map, do_map, dqkv_map;
  if (int err = sm90::make_tile_map(&qkv_map, qkv, D, 3LL * N * H * S)) return err;
  if (int err = sm90::make_tile_map(&dqkv_map, dqkv, D, 3LL * N * H * S)) return err;
  if (int err = sm90::make_tile_map(&do_map, dout, D, (long long)N * H * S)) return err;
  if (D == 64)
    return split ? sm90::launch_bwd_fused<64, true>(qkv_map, do_map, dqkv_map, args, lay, N, st)
                 : sm90::launch_bwd_fused<64, false>(qkv_map, do_map, dqkv_map, args, lay, N, st);
  return split ? sm90::launch_bwd_fused<128, true>(qkv_map, do_map, dqkv_map, args, lay, N, st)
               : sm90::launch_bwd_fused<128, false>(qkv_map, do_map, dqkv_map, args, lay, N, st);
}

}  // extern "C"
