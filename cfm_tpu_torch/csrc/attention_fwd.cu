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
// - 256 < S (the gate admits up to 896), attention_streamed: two passes
//   over 64-key tiles through a ring of R slots refilled by TMA R tiles
//   ahead. The first takes the row max and a rescaled running sum (which
//   differs from the direct sum by f32 rounding only); the second recomputes
//   each tile's logits, forms w = bf16(exp(l - max) / sum) and runs w @ v.
//   The output accumulator is never rescaled (that would be an online
//   softmax, a different function).
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

#include "attn_block_common.cuh"
#include "sm90_attention.cuh"

namespace {

using namespace sm90;

constexpr int kWarpgroup = 128;

// Blocks an SM holds of the resident kernel (its registers are held to
// 65536 / (128 x blocks)).
__host__ __device__ constexpr int resident_blocks(int D, int T) { return D == 64 && T == 4 ? 3 : 1; }

constexpr size_t resident_smem(int D, int T) {
  return 1024 + (size_t)(1 + 2 * T) * 2 * kRows * D + 2 * sizeof(uint64_t);
}

// S = 64 T <= 256: one block per 64-query tile of one (item, head). Q and K
// arrive on one barrier, V on another, so V streams in while the logits and
// the softmax are computed.
template <int D, int T>
__global__ void __launch_bounds__(kWarpgroup, resident_blocks(D, T))
attention_resident(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap out_map, int H, float scale) {
  constexpr int S = 64 * T;
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1024(smem_raw));
  bf16* Ks = Qs + tile_elems<D>();
  bf16* Vs = Ks + T * tile_elems<D>();
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + T * tile_elems<D>());
  const int tid = threadIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int row_q = ((n * 3) * H + h) * S, row_k = row_q + H * S, row_v = row_k + H * S;
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], (1 + T) * tile_bytes<D>());
    load_tile<D>(Qs, &qkv_map, &bar[0], row_q + 64 * blockIdx.x);
    for (int j = 0; j < T; ++j) load_tile<D>(Ks + j * tile_elems<D>(), &qkv_map, &bar[0], row_k + 64 * j);
    mbar_expect_tx(&bar[1], T * tile_bytes<D>());
    for (int j = 0; j < T; ++j) load_tile<D>(Vs + j * tile_elems<D>(), &qkv_map, &bar[1], row_v + 64 * j);
  }
  const float ls = logit_scale(scale);
  mbar_wait(&bar[0], 0);
  float l[T][32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T; ++j) issue_nt<D>(l[j], Qs, Ks + j * tile_elems<D>());
  wgmma_commit();
  wgmma_wait_all();
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < T; ++j) {
    fence_regs(l[j]);
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[half_of(i)] = fmaxf(mx[half_of(i)], l[j][i]);
  }
  const float m[2] = {__fmul_rn(quad_max(mx[0]), ls), __fmul_rn(quad_max(mx[1]), ls)};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      l[j][i] = softmax_exp(l[j][i], ls, m[half_of(i)]);
      sum[half_of(i)] += l[j][i];
    }
  const float inv[2] = {__frcp_rn(quad_sum(sum[0])), __frcp_rn(quad_sum(sum[1]))};
  uint32_t frag[T][16];
#pragma unroll
  for (int j = 0; j < T; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) l[j][i] *= inv[half_of(i)];
    to_frags(l[j], frag[j]);  // the f32 tile dies here
  }
  mbar_wait(&bar[1], 0);
  float o[D / 64][32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T; ++j) issue_nn<D>(o, frag[j], Vs + j * tile_elems<D>(), j);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int p = 0; p < D / 64; ++p) fence_regs(o[p]);
  stage_acc<D>(Qs, o);  // Q's tile is free once the logits are in
  store_tile<D>(Qs, &out_map, (n * H + h) * S + 64 * blockIdx.x);
}

template <int D, int R>
constexpr size_t streamed_smem() {
  return 1024 + (size_t)(1 + R) * tile_bytes<D>() + (1 + R) * sizeof(uint64_t);
}

// Any S (a multiple of 64): one block per 64-query tile, two passes over the
// key tiles through a ring of R slots. Load i of the 3 S / 64 is K tile i in
// the first pass, then K and V of tile (i - T) / 2 in turn.
template <int D, int R>
__global__ void __launch_bounds__(kWarpgroup, 1)
attention_streamed(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap out_map, int H, int S, float scale) {
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1024(smem_raw));
  bf16* ring = Qs + tile_elems<D>();
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + R * tile_elems<D>());
  uint64_t* full = bar_q + 1;
  const int tid = threadIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int T = S / 64, loads = 3 * T;
  const int row_q = ((n * 3) * H + h) * S, row_k = row_q + H * S;
  auto issue = [&](int i) {  // thread 0 only
    const int which = i < T ? 0 : (i - T) & 1, j = i < T ? i : (i - T) >> 1;
    mbar_expect_tx(&full[i % R], tile_bytes<D>());
    load_tile<D>(ring + (i % R) * tile_elems<D>(), &qkv_map, &full[i % R],
                 row_k + which * H * S + 64 * j);
  };
  auto acquire = [&](int i) {
    mbar_wait(&full[i % R], (i / R) & 1);
    return ring + (i % R) * tile_elems<D>();
  };
  auto release = [&](int i) {  // every thread is done with load i's slot
    __syncthreads();
    if (tid == 0 && i + R < loads) issue(i + R);
  };
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < R; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, tile_bytes<D>());
    load_tile<D>(Qs, &qkv_map, bar_q, row_q + 64 * blockIdx.x);
    for (int i = 0; i < R && i < loads; ++i) issue(i);
  }
  const float ls = logit_scale(scale);
  mbar_wait(bar_q, 0);

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int j = 0; j < T; ++j) {
    float l[32];
    const bf16* K = acquire(j);
    wgmma_fence();
    issue_nt<D>(l, Qs, K);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    release(j);
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) tm[half_of(i)] = fmaxf(tm[half_of(i)], l[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = fmaxf(mx[r], __fmul_rn(quad_max(tm[r]), ls));
      sum[r] *= exp2_approx(mx[r] - m);
      mx[r] = m;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[half_of(i)] += softmax_exp(l[i], ls, mx[half_of(i)]);
  }
  const float inv[2] = {__frcp_rn(quad_sum(sum[0])), __frcp_rn(quad_sum(sum[1]))};

  float o[D / 64][32];
  for (int j = 0; j < T; ++j) {
    const int i = T + 2 * j;
    float l[32];
    const bf16* K = acquire(i);
    wgmma_fence();
    issue_nt<D>(l, Qs, K);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    release(i);
#pragma unroll
    for (int e = 0; e < 32; ++e) l[e] = softmax_exp(l[e], ls, mx[half_of(e)]) * inv[half_of(e)];
    uint32_t frag[16];
    to_frags(l, frag);
    const bf16* V = acquire(i + 1);
    wgmma_fence();
    issue_nn<D>(o, frag, V, j);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < D / 64; ++p) fence_regs(o[p]);
    release(i + 1);
  }
  stage_acc<D>(Qs, o);
  store_tile<D>(Qs, &out_map, (n * H + h) * S + 64 * blockIdx.x);
}

// The ring's depth: 64 KB of K and V tiles in flight.
template <int D> constexpr int ring_slots() { return D == 64 ? 8 : 4; }

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int D, int T>
int launch_resident(const CUtensorMap& qkv_map, const CUtensorMap& out_map, int N, int H,
                    float scale, cudaStream_t st) {
  constexpr size_t smem = resident_smem(D, T);
  if (int err = set_smem(attention_resident<D, T>, smem)) return err;
  attention_resident<D, T><<<dim3(T, H, N), kWarpgroup, smem, st>>>(qkv_map, out_map, H, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tensor_core(const bf16* qkv, bf16* out, int N, int H, int S, float scale,
                       cudaStream_t st) {
  CUtensorMap qkv_map, out_map;
  if (int err = make_tile_map(&qkv_map, qkv, D, 3LL * N * H * S)) return err;
  if (int err = make_tile_map(&out_map, out, D, (long long)N * H * S)) return err;
  switch (S / 64) {
    case 1: return launch_resident<D, 1>(qkv_map, out_map, N, H, scale, st);
    case 2: return launch_resident<D, 2>(qkv_map, out_map, N, H, scale, st);
    case 3: return launch_resident<D, 3>(qkv_map, out_map, N, H, scale, st);
    case 4: return launch_resident<D, 4>(qkv_map, out_map, N, H, scale, st);
    default: {
      constexpr int R = ring_slots<D>();
      constexpr size_t smem = streamed_smem<D, R>();
      if (int err = set_smem(attention_streamed<D, R>, smem)) return err;
      attention_streamed<D, R><<<dim3(S / 64, H, N), kWarpgroup, smem, st>>>(qkv_map, out_map, H,
                                                                            S, scale);
      return (int)cudaGetLastError();
    }
  }
}

bool tensor_core_route(int D, int dtype) { return dtype == 1 && (D == 64 || D == 128); }

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs at this shape and dtype (0 =
// float32, 1 = bfloat16); the wrapper refuses shapes above the card's
// per-block limit.
size_t attention_fwd_smem(int S, int D, int dtype) {
  if (!tensor_core_route(D, dtype)) return attention_smem(S, D);
  if (S <= 256) return resident_smem(D, S / 64);
  return D == 64 ? streamed_smem<64, ring_slots<64>()>() : streamed_smem<128, ring_slots<128>()>();
}

// qkv: (N, 3, H, S, D), out: (N, H, S, D), both contiguous in the model
// dtype and 16-byte aligned; D a multiple of 64, and on the tensor-core
// route (bf16, D = 64 or 128) S a multiple of 64. Returns 0 or the first
// CUDA error code.
int attention_fwd(const void* qkv, void* out, int N, int H, int S, int D, float scale, int dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_core_route(D, dtype)) {
    if (S % 64) return (int)cudaErrorInvalidValue;
    const bf16* q = static_cast<const bf16*>(qkv);
    bf16* o = static_cast<bf16*>(out);
    return D == 64 ? launch_tensor_core<64>(q, o, N, H, S, scale, st)
                   : launch_tensor_core<128>(q, o, N, H, S, scale, st);
  }
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
