// The bf16 tensor-core forward of multi-head attention at head dims 64 and
// 128 (TMA tiles + wgmma), shared by kernel #3 (attention_fwd.cu, the
// (N, 3, H, S, D) layout) and stage (c) of the attention-block forward #1
// (attn_block_fwd.cu, its (N, S, 3HD) qkv buffer). attention_fwd.cu's header
// describes the design; the kernels here take where a (item, head)'s 64-row
// tiles sit as a layout policy, so both callers run the same code:
//
// - HeadsLayout: a rank-2 map over (rows, D), the rows of (n, comp, h) at
//   ((n * 3 + comp) * H + h) * S; the output's at (n * H + h) * S. S is a
//   multiple of 64.
// - BlockLayout: a rank-3 map over (N, S, 3HD), head h's q, k and v at
//   columns comp * HD + h * D; the output a rank-3 map over (N, S, HD). A
//   box never crosses into the next item's rows: rows past S load as zeros
//   and are not stored, so S may be any multiple of 8; the keys past S are
//   masked out of the softmax (logit -inf, weight 0).

#pragma once

#include "sm90_attention.cuh"

namespace sm90 {

struct HeadsLayout {
  static constexpr bool kRagged = false;
  int H, S;
  template <int D>
  __device__ void load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int comp, int n, int h,
                       int s0) const {
    load_tile<D>(dst, map, bar, ((n * 3 + comp) * H + h) * S + s0);
  }
  template <int D>
  __device__ void store(const bf16* tile, const CUtensorMap* map, int n, int h, int s0) const {
    store_tile<D>(tile, map, (n * H + h) * S + s0);
  }
};

struct BlockLayout {
  static constexpr bool kRagged = true;
  int H, S;
  template <int D>
  __device__ void load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int comp, int n, int h,
                       int s0) const {
#pragma unroll
    for (int p = 0; p < D / kPanel; ++p)
      tma_load_3d(dst + p * kPanelElems, map, bar, (comp * H + h) * D + p * kPanel, s0, n);
  }
  template <int D>
  __device__ void store(const bf16* tile, const CUtensorMap* map, int n, int h, int s0) const {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < D / kPanel; ++p)
        tma_store_3d(map, tile + p * kPanelElems, h * D + p * kPanel, s0, n);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    __syncthreads();
  }
};

// Keys 64 j + col (the accumulator's columns) at or past S get logit -inf.
template <class L>
__device__ __forceinline__ void mask_keys(float (&l)[32], const L& lay, int j) {
  if constexpr (L::kRagged) {
    const int past = lay.S - 64 * j, t = threadIdx.x & 3;
    if (past < 64)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (col_of(i, t) >= past) l[i] = -INFINITY;
  }
}

// Blocks an SM holds of the resident kernel (its registers are held to
// 65536 / (128 x blocks)).
__host__ __device__ constexpr int resident_blocks(int D, int T) { return D == 64 && T == 4 ? 3 : 1; }

constexpr size_t resident_smem(int D, int T) {
  return 1024 + (size_t)(1 + 2 * T) * 2 * kRows * D + 2 * sizeof(uint64_t);
}

// S <= 64 T <= 256: one block per 64-query tile of one (item, head). Q and K
// arrive on one barrier, V on another, so V streams in while the logits and
// the softmax are computed.
template <int D, int T, class L>
__global__ void __launch_bounds__(kWarpgroup, resident_blocks(D, T))
attention_resident(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap out_map, const L lay, float scale) {
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1024(smem_raw));
  bf16* Ks = Qs + tile_elems<D>();
  bf16* Vs = Ks + T * tile_elems<D>();
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + T * tile_elems<D>());
  const int tid = threadIdx.x, h = blockIdx.y, n = blockIdx.z;
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], (1 + T) * tile_bytes<D>());
    lay.template load<D>(Qs, &qkv_map, &bar[0], 0, n, h, 64 * blockIdx.x);
    for (int j = 0; j < T; ++j) lay.template load<D>(Ks + j * tile_elems<D>(), &qkv_map, &bar[0], 1, n, h, 64 * j);
    mbar_expect_tx(&bar[1], T * tile_bytes<D>());
    for (int j = 0; j < T; ++j) lay.template load<D>(Vs + j * tile_elems<D>(), &qkv_map, &bar[1], 2, n, h, 64 * j);
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
    mask_keys(l[j], lay, j);
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
  lay.template store<D>(Qs, &out_map, n, h, 64 * blockIdx.x);
}

template <int D, int R>
constexpr size_t streamed_smem() {
  return 1024 + (size_t)(1 + R) * tile_bytes<D>() + (1 + R) * sizeof(uint64_t);
}

// Any S: one block per 64-query tile, two passes over the T = ceil(S / 64)
// key tiles through a ring of R slots. Load i of the 3 T is K tile i in the
// first pass, then K and V of tile (i - T) / 2 in turn.
template <int D, int R, class L>
__global__ void __launch_bounds__(kWarpgroup, 1)
attention_streamed(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap out_map, const L lay, float scale) {
  extern __shared__ uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align_1024(smem_raw));
  bf16* ring = Qs + tile_elems<D>();
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + R * tile_elems<D>());
  uint64_t* full = bar_q + 1;
  const int tid = threadIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int T = (lay.S + 63) / 64, loads = 3 * T;
  auto issue = [&](int i) {  // thread 0 only
    const int which = i < T ? 0 : (i - T) & 1, j = i < T ? i : (i - T) >> 1;
    mbar_expect_tx(&full[i % R], tile_bytes<D>());
    lay.template load<D>(ring + (i % R) * tile_elems<D>(), &qkv_map, &full[i % R], 1 + which, n,
                         h, 64 * j);
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
    lay.template load<D>(Qs, &qkv_map, bar_q, 0, n, h, 64 * blockIdx.x);
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
    mask_keys(l, lay, j);
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
    mask_keys(l, lay, j);
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
  lay.template store<D>(Qs, &out_map, n, h, 64 * blockIdx.x);
}

// The ring's depth: 64 KB of K and V tiles in flight.
template <int D> constexpr int ring_slots() { return D == 64 ? 8 : 4; }

template <int D>
constexpr size_t tensor_core_smem(int S) {
  return S <= 256 ? resident_smem(D, (S + 63) / 64) : streamed_smem<D, ring_slots<D>()>();
}

template <int D, int T, class L>
int launch_resident(const CUtensorMap& qkv_map, const CUtensorMap& out_map, const L& lay, int N,
                    float scale, cudaStream_t st) {
  constexpr size_t smem = resident_smem(D, T);
  if (int err = set_smem(attention_resident<D, T, L>, smem)) return err;
  attention_resident<D, T, L><<<dim3(T, lay.H, N), kWarpgroup, smem, st>>>(qkv_map, out_map, lay,
                                                                          scale);
  return (int)cudaGetLastError();
}

// The attention of N items on the maps of layout ``lay``: resident at
// S <= 256, streamed above. Returns 0 or a CUDA error code.
template <int D, class L>
int launch_tensor_core(const CUtensorMap& qkv_map, const CUtensorMap& out_map, const L& lay,
                       int N, float scale, cudaStream_t st) {
  switch ((lay.S + 63) / 64) {
    case 1: return launch_resident<D, 1>(qkv_map, out_map, lay, N, scale, st);
    case 2: return launch_resident<D, 2>(qkv_map, out_map, lay, N, scale, st);
    case 3: return launch_resident<D, 3>(qkv_map, out_map, lay, N, scale, st);
    case 4: return launch_resident<D, 4>(qkv_map, out_map, lay, N, scale, st);
    default: {
      constexpr int R = ring_slots<D>();
      constexpr size_t smem = streamed_smem<D, R>();
      if (int err = set_smem(attention_streamed<D, R, L>, smem)) return err;
      attention_streamed<D, R, L><<<dim3((lay.S + 63) / 64, lay.H, N), kWarpgroup, smem, st>>>(
          qkv_map, out_map, lay, scale);
      return (int)cudaGetLastError();
    }
  }
}

}  // namespace sm90
