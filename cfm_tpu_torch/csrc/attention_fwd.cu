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
// What bounds it on this card. At the ImageNet-64 training shape (N=32,
// H=9, S=256, D=64, bf16) the function reads qkv (28.3 MB) and writes out
// (9.4 MB): 37.7 MB, 0.0113 ms at 3.35 TB/s, against 4.8 GFLOP, 0.0049 ms
// on the bf16 tensor cores. Bytes bound it, so the design keeps tiles in
// flight, computes each logit once, and moves nothing but q, k, v and the
// output through device memory:
//
// - bf16 at head dims 64 and 128: one warpgroup (128 threads) a block, for
//   64 query rows. Q, K and V arrive by TMA as 64-row tiles with the
//   128-byte swizzle, signalled on mbarriers; both products are wgmma
//   m64n64k16 from those tiles, V read MN-major as it lies in memory (no
//   transpose). The output tile is rounded into Q's free tile and stored by
//   TMA (sm90_attention.cuh, store_tile): 4-byte stores straight from the
//   accumulators, eight rows a warp instruction, were much slower on an
//   H100.
// - S <= 256 (the path's shape), attention_resident: Q and all of K on one
//   barrier, all of V on another, so V streams in while q k^T and the
//   softmax run. The whole logits row of a query (S / 64 accumulators of 32
//   f32 a thread) stays in registers: the exact row max and sum in one
//   pass, no recompute. The weights are rounded to bf16 in registers and are
//   the A operand of w @ v as they lie. Three blocks an SM at D = 64.
// - 256 < S, attention_streamed: the gate admits up to 896, and beyond it
//   the wrapper's streamed route (ops/attention.py) brings the ImageNet-64
//   32x32 blocks, (N, H, S, D) = (64, 6, 1024, 64) a card in training. Two
//   passes over 64-key tiles through a ring of four slots refilled by TMA
//   four tiles ahead. The first takes the row max and a rescaled running
//   sum (which differs from the direct sum by f32 rounding only), and keeps
//   both for the backward where the wrapper asks; the second recomputes
//   each tile's logits, forms w = bf16(exp(l - max) / sum) and runs w @ v.
//   The output accumulator is never rescaled (that would be an online
//   softmax, a different function). At (64, 6, 1024, 64) the three products
//   and two exponentials an element bound it, not bytes: 0.104 ms for the
//   two products the function needs, 0.22 ms for 2 N H S^2 MUFU.EX2 at 16
//   a clock an SM. Blocks an SM set its time there: on an H100 the ring of
//   eight slots it had (3 blocks an SM by shared memory) took 0.46 ms, four
//   (5, by registers) 0.37, and two query tiles a block sharing each K and
//   V tile (half the L2 reads, 2 blocks of 256 threads an SM) 0.44.
// - The exponentials are exp2 of the logits scaled by scale * log2 e less
//   the row max, one FFMA and one MUFU.EX2 (sm90_attention.cuh,
//   softmax_exp; the row max is taken on q . k and scaled once, which needs
//   scale > 0, the wrapper's check), and the weights are those times the
//   correctly rounded reciprocal of the sum, not a division. Against the
//   plain version's exp(l - max) / sum this moves a bf16 weight only where
//   the f32 value sits at a rounding tie (tests/test_torch_attention.py
//   counts them); the tests hold at the existing tolerances.
// - Each block loads all of K and V from L2: a cluster of a head's
//   query-tile blocks sharing them by TMA multicast (a quarter of the L2
//   traffic) ran slower than plain loads on an H100.
// - float32, and other head dims, run on the FMA kernel of the attention
//   block's stage (c) (attn_block_common.cuh, attention_kernel): a tensor
//   core would make f32 products TF32. No path runs them.
// - The kernels live in sm90_attention_fwd.cuh, with the tiles' places in
//   device memory as a layout policy (HeadsLayout here), so the
//   attention-block forward #1 runs the same kernels on its qkv buffer.

#include "attn_block_common.cuh"
#include "sm90_attention_fwd.cuh"

namespace {

using namespace sm90;

template <int D>
int launch_heads(const bf16* qkv, bf16* out, float* stats, int N, int H, int S, float scale,
                 cudaStream_t st) {
  CUtensorMap qkv_map, out_map;
  if (int err = make_tile_map(&qkv_map, qkv, D, 3LL * N * H * S)) return err;
  if (int err = make_tile_map(&out_map, out, D, (long long)N * H * S)) return err;
  return launch_tensor_core<D>(qkv_map, out_map, HeadsLayout{H, S}, N, scale, st, stats);
}

bool tensor_core_route(int D, int dtype) { return dtype == 1 && (D == 64 || D == 128); }

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at this shape and dtype (0 =
// float32, 1 = bfloat16); the wrapper refuses shapes above the card's
// per-block limit.
size_t attention_fwd_smem(int S, int D, int dtype) {
  if (!tensor_core_route(D, dtype)) return attention_smem(S, D);
  return D == 64 ? tensor_core_smem<64>(S) : tensor_core_smem<128>(S);
}

// qkv: (N, 3, H, S, D), out: (N, H, S, D), both contiguous in the model
// dtype and 16-byte aligned; D a multiple of 64, and on the tensor-core
// route (bf16, D = 64 or 128) S a multiple of 64. stats: null, or on the
// tensor-core route at S > 256 a (2, N, H, S) f32 buffer for the rows' max
// and sum, which attention_bwd_fused takes as ``saved``. Returns 0 or the
// first CUDA error code.
int attention_fwd(const void* qkv, void* out, void* stats, int N, int H, int S, int D,
                  float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_core_route(D, dtype)) {
    if (S % 64 || (stats != nullptr && S <= 256)) return (int)cudaErrorInvalidValue;
    const bf16* q = static_cast<const bf16*>(qkv);
    bf16* o = static_cast<bf16*>(out);
    float* kept = static_cast<float*>(stats);
    return D == 64 ? launch_heads<64>(q, o, kept, N, H, S, scale, st)
                   : launch_heads<128>(q, o, kept, N, H, S, scale, st);
  }
  if (stats != nullptr) return (int)cudaErrorInvalidValue;
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
