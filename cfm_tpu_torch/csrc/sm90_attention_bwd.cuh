// The bf16 tensor-core backward of multi-head attention at head dims 64 and
// 128 (TMA tiles + wgmma), shared by kernel #4 (attention_bwd.cu, the
// (N, 3, H, S, D) layout, do in bf16) and the attention stage of the
// attention-block backward #2 (attn_block_bwd.cu, its (N, S, 3HD) buffers,
// do in f32). attention_bwd.cu's header describes the design: (B) a rows
// kernel per 64 queries for dq and the row statistics (max, sum, delta),
// then (A) a columns kernel per 64 keys for dk and dv; dq and dk as three
// exact bf16 products of the split f32 ds. The kernels take where a
// (item, head)'s tiles sit, and how do arrives, as a layout policy:
//
// - HeadsBwd (#4): rank-2 maps over (rows, D); q, k, v of (n, h) at rows
//   ((n * 3 + comp) * H + h) * S, do at (n * H + h) * S. One do tile.
// - BlockBwd (#2): rank-3 maps over (N, S, 3HD), head h's component comp at
//   columns comp * HD + h * D, for qkv, for dqkv, and for do: the f32 do is
//   given as three bf16 parts hi + mid + lo (the sum exact, as
//   to_split_frags splits ds) in the three column blocks of one (N, S, 3HD)
//   buffer, so dp = do v^T and dv = w^T do are three exact bf16 products
//   each. S is any multiple of 8: rows past S load as zeros and are not
//   stored, keys past S are masked out of the softmax in both kernels and
//   queries past S out of the columns kernel. The kernels also write the
//   column sums of each f32 tile of dq, dk and dv (the rows past S left
//   out, the rows added in a fixed order) for dbq, which sums the f32 dqkv
//   before it is rounded.
//
// The statistics are (3, N, H, Sp) f32, Sp = 64 ceil(S / 64), written for
// every row of a tile.

#pragma once

#include "sm90_attention_fwd.cuh"

namespace sm90 {

constexpr int kDsLd = 68;  // f32 row stride of the FMA variant's ds tile in shared memory
constexpr int kStatBytes = 3 * kRows * sizeof(float);  // a query tile's max, sum and delta

struct BwdArgs {
  float* stats;  // (3, N, H, Sp): row max, row sum, delta
  float scale;
  long long nhs;  // N * H * Sp
  const float* saved = nullptr;  // (2, N, H, Sp): the forward's row max and sum, or null
};

struct HeadsBwd {
  static constexpr bool kRagged = false;
  static constexpr int kParts = 1;
  static constexpr bool kSums = false;
  int H, S;
  __device__ int stat_row(int n, int h) const { return (n * H + h) * S; }
  template <int D>
  __device__ void load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int comp, int n, int h,
                       int s0) const {
    load_tile<D>(dst, map, bar, ((n * 3 + comp) * H + h) * S + s0);
  }
  template <int D>
  __device__ void load_do(bf16* dst, const CUtensorMap* map, uint64_t* bar, int, int n, int h,
                          int s0) const {
    load_tile<D>(dst, map, bar, (n * H + h) * S + s0);
  }
  template <int D>
  __device__ void store(const bf16* tile, const CUtensorMap* map, int comp, int n, int h,
                        int s0) const {
    store_tile<D>(tile, map, ((n * 3 + comp) * H + h) * S + s0);
  }
};

struct BlockBwd {
  static constexpr bool kRagged = true;
  static constexpr int kParts = 3;
  static constexpr bool kSums = true;
  int H, S;
  float* sums;  // (N * ceil(S / 64), 3 H D): column sums of the f32 dq, dk, dv tiles
  __device__ int tiles() const { return (S + 63) / 64; }
  __device__ int stat_row(int n, int h) const { return (n * H + h) * 64 * tiles(); }
  template <int D>
  __device__ void load(bf16* dst, const CUtensorMap* map, uint64_t* bar, int comp, int n, int h,
                       int s0) const {
#pragma unroll
    for (int p = 0; p < D / kPanel; ++p)
      tma_load_3d(dst + p * kPanelElems, map, bar, (comp * H + h) * D + p * kPanel, s0, n);
  }
  template <int D>
  __device__ void load_do(bf16* dst, const CUtensorMap* map, uint64_t* bar, int part, int n,
                          int h, int s0) const {
    load<D>(dst, map, bar, part, n, h, s0);
  }
  template <int D>
  __device__ void store(const bf16* tile, const CUtensorMap* map, int comp, int n, int h,
                        int s0) const {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < D / kPanel; ++p)
        tma_store_3d(map, tile + p * kPanelElems, (comp * H + h) * D + p * kPanel, s0, n);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    __syncthreads();
  }
  // Where the column sums of component comp's tile s0 / 64 of (n, h) go.
  __device__ float* sum_row(int comp, int n, int h, int s0, int D) const {
    return sums + (size_t)(n * tiles() + s0 / 64) * 3 * H * D + (comp * H + h) * D;
  }
};

// Column sums of a 64-row f32 tile in the wgmma layout (D / 64 panels of
// m64n64), rows at or past ``valid`` left out, into out[0 .. D): each
// thread adds its two rows, a butterfly adds the eight row groups of a
// warp, and thread c adds the four warps' sums in order. ``red`` holds
// 4 D floats. Every thread of the warpgroup calls it.
template <int D>
__device__ __forceinline__ void tile_col_sums(const float (&acc)[D / 64][32], int valid, float* red,
                                              float* out) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool in0 = 16 * warp + g < valid, in1 = 16 * warp + g + 8 < valid;
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = (in0 ? acc[p][4 * c + e] : 0.f) + (in1 ? acc[p][4 * c + 2 + e] : 0.f);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[warp * D + 64 * p + 8 * c + 2 * t + e] = v;
      }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kWarpgroup)
    out[c] = ((red[c] + red[D + c]) + red[2 * D + c]) + red[3 * D + c];
  __syncthreads();
}

// acc (+)= x B for f32 x: three exact bf16 parts, three products.
template <int D>
__device__ __forceinline__ void split_product(float (&acc)[D / 64][32], const float (&x)[32],
                                              const bf16* B, int accumulate) {
  uint32_t hi[16], mid[16], lo[16];
  to_split_frags(x, hi, mid, lo);
  wgmma_fence();
  issue_nn<D>(acc, hi, B, accumulate);
  issue_nn<D>(acc, mid, B, 1);
  issue_nn<D>(acc, lo, B, 1);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int p = 0; p < D / 64; ++p) fence_regs(acc[p]);
}

// The FMA variant: acc[p][u] += sum_k x[r][k] B[k][64 p + c] in k order,
// for the thread's rows r = tid / 64 + 2 u and column c = tid % 64; x goes
// through shared memory (xs, 64 x kDsLd f32).
template <int D>
__device__ __forceinline__ void fma_product(float (&acc)[D / 64][32], const float (&x)[32],
                                            const bf16* B, float* xs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<float2*>(&xs[(16 * warp + g + 8 * half_of(i)) * kDsLd + col_of(i, t)]) =
        make_float2(x[i], x[i + 1]);
  __syncthreads();
  const int c = tid & 63, r0 = tid >> 6;
  for (int k = 0; k < 64; k += 4) {
    float b[D / 64][4];
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const int kr = k + kq;
        b[p][kq] = __bfloat162float(
            B[p * kPanelElems + kr * kPanel + ((((c >> 3) ^ (kr & 7)) << 3) | (c & 7))]);
      }
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[(r0 + 2 * u) * kDsLd + k]);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        float a = acc[p][u];
        a = fmaf(xv.x, b[p][0], a);
        a = fmaf(xv.y, b[p][1], a);
        a = fmaf(xv.z, b[p][2], a);
        acc[p][u] = fmaf(xv.w, b[p][3], a);
      }
    }
  }
  __syncthreads();
}

// An output tile from accumulators, staged for a TMA store: SPLIT holds
// them in the wgmma layout, the FMA variant in its own.
template <int D, bool SPLIT>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[D / 64][32]) {
  if constexpr (SPLIT) {
    stage_acc<D>(tile, acc);
  } else {
    const int tid = threadIdx.x;
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int u = 0; u < 32; ++u)
        tile[swizzled((tid >> 6) + 2 * u, 64 * p + (tid & 63))] = __float2bfloat16_rn(acc[p][u]);
  }
}

// dp (+)= do v^T over the do parts (the rows kernel: rows are queries).
template <int D, int PARTS>
__device__ __forceinline__ void issue_dp(float (&dp)[32], const bf16* dO, const bf16* V) {
#pragma unroll
  for (int q = 0; q < PARTS; ++q) issue_nt<D>(dp, dO + q * tile_elems<D>(), V, q);
}

// Shared memory of the kernels: tile a, PARTS tiles b, a ring of R slots of
// SLOT tiles, the FMA variant's ds tile, the ring's statistics, the column
// sums' scratch, 1 + R barriers.
constexpr size_t bwd_smem(int D, int R, int SLOT, int PARTS, bool split, bool sums) {
  return 1024 + (size_t)(1 + PARTS + R * SLOT) * 2 * kRows * D +
         (split ? 0 : 4 * kRows * kDsLd) + R * kStatBytes + (sums ? 4 * D * sizeof(float) : 0) +
         (1 + R) * sizeof(uint64_t);
}

template <int D, int R, int SLOT, int PARTS, bool SPLIT, bool SUMS>
struct BwdSmem {
  bf16 *a, *b, *ring;
  float *xs, *stats, *red;
  uint64_t *bar, *full;
  __device__ explicit BwdSmem(uint8_t* raw) {
    a = reinterpret_cast<bf16*>(align_1024(raw));
    b = a + tile_elems<D>();
    ring = b + PARTS * tile_elems<D>();
    xs = reinterpret_cast<float*>(ring + R * SLOT * tile_elems<D>());
    stats = xs + (SPLIT ? 0 : kRows * kDsLd);
    red = stats + R * 3 * kRows;
    bar = reinterpret_cast<uint64_t*>(red + (SUMS ? 4 * D : 0));
    full = bar + 1;
  }
  __device__ bf16* slot(int i) const { return ring + SLOT * (i % R) * tile_elems<D>(); }
  __device__ float* slot_stats(int i) const { return stats + (i % R) * 3 * kRows; }
};

// Ring slots of the streaming kernels: the rows kernel streams K and V
// through them where they are not resident (S > 256, or D = 128), the
// columns kernel Q and do; two keep a load in flight. And the blocks an SM
// holds of them: registers are held to 65536 / (128 x blocks), and with
// three do parts the columns kernel's ring holds two blocks at D = 64.
constexpr int kRing = 2;
__host__ __device__ constexpr int bwd_blocks(int D, int parts) {
  return D == 64 ? (parts == 1 ? 3 : 2) : 1;
}

// (B) one block per 64 query rows of one (item, head): dq and the statistics.
template <int D, int R, bool SPLIT, class L>
__global__ void __launch_bounds__(kWarpgroup, bwd_blocks(D, L::kParts))
attention_bwd_rows(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap dqkv_map, const BwdArgs args, const L lay) {
  static_assert(SPLIT || !L::kSums, "the column sums read the wgmma layout");
  constexpr int P = L::kParts;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<D, R, 2, P, SPLIT, L::kSums> sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, n = blockIdx.z;
  const int T = (lay.S + 63) / 64, q0 = 64 * blockIdx.x;
  const bool streamed = T > R;  // else K and V stay resident through the passes
  const int first = args.saved != nullptr;  // with the forward's statistics, no pass 0
  const int loads = streamed ? (3 - first) * T : T;
  const int row_z = lay.stat_row(n, h);  // (n, h)'s first row of the statistics
  auto issue = [&](int i) {  // thread 0 only: K and V of key tile i % T
    uint64_t* bar = &sm.full[i % R];
    mbar_expect_tx(bar, 2 * tile_bytes<D>());
    lay.template load<D>(sm.slot(i), &qkv_map, bar, 1, n, h, 64 * (i % T));
    lay.template load<D>(sm.slot(i) + tile_elems<D>(), &qkv_map, bar, 2, n, h, 64 * (i % T));
  };
  auto acquire = [&](int pass, int j) {
    const int i = streamed ? (pass - first) * T + j : j;
    mbar_wait(&sm.full[i % R], (i / R) & 1);
    return sm.slot(i);
  };
  auto release = [&](int pass, int j) {
    if (!streamed) return;
    const int i = (pass - first) * T + j;
    __syncthreads();
    if (tid == 0 && i + R < loads) issue(i + R);
  };
  if (tid == 0) {
    for (int s = 0; s <= R; ++s) mbar_init(&sm.bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sm.bar, (1 + P) * tile_bytes<D>());
    lay.template load<D>(sm.a, &qkv_map, sm.bar, 0, n, h, q0);
    for (int q = 0; q < P; ++q)
      lay.template load_do<D>(sm.b + q * tile_elems<D>(), &do_map, sm.bar, q, n, h, q0);
    for (int i = 0; i < R && i < loads; ++i) issue(i);
  }
  const bf16 *Q = sm.a, *dO = sm.b;
  const float ls = logit_scale(args.scale);
  mbar_wait(sm.bar, 0);

  // Pass 0: the row max and the rescaled running sum, or the forward's.
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  if (first) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long s = row_z + q0 + 16 * warp + g + 8 * r;
      mx[r] = args.saved[s];
      sum[r] = args.saved[args.nhs + s];
    }
  } else {
    for (int j = 0; j < T; ++j) {
      const bf16* K = acquire(0, j);
      float l[32];
      wgmma_fence();
      issue_nt<D>(l, Q, K);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(l);
      release(0, j);
      mask_keys(l, lay, j);
      running_stats(l, ls, mx, sum);
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
  }
  const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};

  // Pass 1 recomputes l and dp for delta = rowsum(dp * w); pass 2 for ds
  // and dq += ds k.
  float delta[2] = {0.f, 0.f};
  float dq[D / 64][32];
  if constexpr (!SPLIT)
#pragma unroll
    for (int p = 0; p < D / 64; ++p) zero(dq[p]);
  for (int pass = 1; pass <= 2; ++pass) {
    for (int j = 0; j < T; ++j) {
      const bf16* K = acquire(pass, j);
      const bf16* V = K + tile_elems<D>();
      float l[32], dp[32];
      wgmma_fence();
      issue_nt<D>(l, Q, K);
      issue_dp<D, P>(dp, dO, V);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(l);
      fence_regs(dp);
      mask_keys(l, lay, j);
      if (pass == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float wf = softmax_exp(l[i], ls, mx[half_of(i)]) * inv[half_of(i)];
          delta[half_of(i)] += dp[i] * round_bf16(wf);
        }
        release(pass, j);
        if (j == T - 1) {
          delta[0] = quad_sum(delta[0]);
          delta[1] = quad_sum(delta[1]);
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float wf = softmax_exp(l[i], ls, mx[half_of(i)]) * inv[half_of(i)];
        dp[i] = __fmul_rn(__fmul_rn(wf, dp[i] - delta[half_of(i)]), args.scale);  // ds
      }
      if constexpr (SPLIT)
        split_product<D>(dq, dp, K, j);
      else
        fma_product<D>(dq, dp, K, sm.xs);
      release(pass, j);
    }
  }
  __syncthreads();  // every product that read Q is done
  if constexpr (L::kSums) tile_col_sums<D>(dq, lay.S - q0, sm.red, lay.sum_row(0, n, h, q0, D));
  stage_rows<D, SPLIT>(sm.a, dq);
  lay.template store<D>(sm.a, &dqkv_map, 0, n, h, q0);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long s = row_z + q0 + 16 * warp + g + 8 * r;
      args.stats[s] = mx[r];
      args.stats[args.nhs + s] = sum[r];
      args.stats[2 * args.nhs + s] = delta[r];
    }
}

// (B) at S <= 64 T <= 256 and D = 64: the whole logits row of the block's
// queries stays in registers, so the exact row max and sum take one pass
// and wf one exponential an element; dp is recomputed for delta and for ds.
template <int D, int T, bool SPLIT, class L>
__global__ void __launch_bounds__(kWarpgroup, 1)
attention_bwd_rows_resident(const __grid_constant__ CUtensorMap qkv_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap dqkv_map, const BwdArgs args,
                            const L lay) {
  static_assert(SPLIT || !L::kSums, "the column sums read the wgmma layout");
  constexpr int P = L::kParts;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<D, T, 2, P, SPLIT, L::kSums> sm(smem_raw);  // ring: K tiles, then V tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, n = blockIdx.z, q0 = 64 * blockIdx.x;
  const int row_z = lay.stat_row(n, h);
  const bf16 *Q = sm.a, *dO = sm.b, *Ks = sm.ring, *Vs = sm.ring + T * tile_elems<D>();
  if (tid == 0) {
    mbar_init(&sm.bar[0], 1);
    mbar_init(&sm.bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.bar[0], (1 + T) * tile_bytes<D>());
    lay.template load<D>(sm.a, &qkv_map, &sm.bar[0], 0, n, h, q0);
    for (int j = 0; j < T; ++j)
      lay.template load<D>(sm.ring + j * tile_elems<D>(), &qkv_map, &sm.bar[0], 1, n, h, 64 * j);
    mbar_expect_tx(&sm.bar[1], (P + T) * tile_bytes<D>());
    for (int q = 0; q < P; ++q)
      lay.template load_do<D>(sm.b + q * tile_elems<D>(), &do_map, &sm.bar[1], q, n, h, q0);
    for (int j = 0; j < T; ++j)
      lay.template load<D>(sm.ring + (T + j) * tile_elems<D>(), &qkv_map, &sm.bar[1], 2, n, h,
                           64 * j);
  }
  const float ls = logit_scale(args.scale);
  mbar_wait(&sm.bar[0], 0);
  float wf[T][32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T; ++j) issue_nt<D>(wf[j], Q, Ks + j * tile_elems<D>());
  wgmma_commit();
  wgmma_wait_all();
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < T; ++j) {
    fence_regs(wf[j]);
    mask_keys(wf[j], lay, j);
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[half_of(i)] = fmaxf(mx[half_of(i)], wf[j][i]);
  }
  mx[0] = __fmul_rn(quad_max(mx[0]), ls);
  mx[1] = __fmul_rn(quad_max(mx[1]), ls);
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      wf[j][i] = softmax_exp(wf[j][i], ls, mx[half_of(i)]);
      sum[half_of(i)] += wf[j][i];
    }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) wf[j][i] *= inv[half_of(i)];

  mbar_wait(&sm.bar[1], 0);
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float dp[32];
    wgmma_fence();
    issue_dp<D, P>(dp, dO, Vs + j * tile_elems<D>());
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) delta[half_of(i)] += dp[i] * round_bf16(wf[j][i]);
  }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  float dq[D / 64][32];
  if constexpr (!SPLIT)
#pragma unroll
    for (int p = 0; p < D / 64; ++p) zero(dq[p]);
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float dp[32];
    wgmma_fence();
    issue_dp<D, P>(dp, dO, Vs + j * tile_elems<D>());
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = __fmul_rn(__fmul_rn(wf[j][i], dp[i] - delta[half_of(i)]), args.scale);  // ds
    if constexpr (SPLIT)
      split_product<D>(dq, dp, Ks + j * tile_elems<D>(), j);
    else
      fma_product<D>(dq, dp, Ks + j * tile_elems<D>(), sm.xs);
  }
  __syncthreads();  // every product that read Q is done
  if constexpr (L::kSums) tile_col_sums<D>(dq, lay.S - q0, sm.red, lay.sum_row(0, n, h, q0, D));
  stage_rows<D, SPLIT>(sm.a, dq);
  lay.template store<D>(sm.a, &dqkv_map, 0, n, h, q0);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long s = row_z + q0 + 16 * warp + g + 8 * r;
      args.stats[s] = mx[r];
      args.stats[args.nhs + s] = sum[r];
      args.stats[2 * args.nhs + s] = delta[r];
    }
}

// The columns kernel's masks: keys (the accumulator's rows k0 + row) and
// queries (its columns 64 i + col) at or past S get logit -inf, so weight
// and ds 0 there.
template <class L>
__device__ __forceinline__ void mask_cols(float (&l)[32], const L& lay, int k0, int i) {
  if constexpr (L::kRagged) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int keys = lay.S - k0 - 16 * warp - g, queries = lay.S - 64 * i;
    if (keys <= 8 || queries < 64)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (8 * half_of(e) >= keys || col_of(e, t) >= queries) l[e] = -INFINITY;
  }
}

// (A) one block per 64 keys of one (item, head): dk and dv, over the query
// tiles, from the statistics attention_bwd_rows wrote.
template <int D, int R, bool SPLIT, class L>
__global__ void __launch_bounds__(kWarpgroup, bwd_blocks(D, L::kParts))
attention_bwd_cols(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap dqkv_map, const BwdArgs args, const L lay) {
  static_assert(SPLIT || !L::kSums, "the column sums read the wgmma layout");
  constexpr int P = L::kParts;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<D, R, 1 + P, P, SPLIT, L::kSums> sm(smem_raw);
  const int tid = threadIdx.x, t = tid & 3;
  const int h = blockIdx.y, n = blockIdx.z;
  const int T = (lay.S + 63) / 64, k0 = 64 * blockIdx.x;
  const int row_z = lay.stat_row(n, h);
  auto issue = [&](int i) {  // thread 0 only: Q, do and the statistics of query tile i
    uint64_t* bar = &sm.full[i % R];
    mbar_expect_tx(bar, (1 + P) * tile_bytes<D>() + kStatBytes);
    lay.template load<D>(sm.slot(i), &qkv_map, bar, 0, n, h, 64 * i);
    for (int q = 0; q < P; ++q)
      lay.template load_do<D>(sm.slot(i) + (1 + q) * tile_elems<D>(), &do_map, bar, q, n, h, 64 * i);
    for (int v = 0; v < 3; ++v)
      bulk_load(sm.slot_stats(i) + v * kRows, args.stats + v * args.nhs + row_z + 64 * i,
                kRows * sizeof(float), bar);
  };
  if (tid == 0) {
    for (int s = 0; s <= R; ++s) mbar_init(&sm.bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sm.bar, 2 * tile_bytes<D>());
    lay.template load<D>(sm.a, &qkv_map, sm.bar, 1, n, h, k0);
    lay.template load<D>(sm.b, &qkv_map, sm.bar, 2, n, h, k0);
    for (int i = 0; i < R && i < T; ++i) issue(i);
  }
  const bf16 *K = sm.a, *V = sm.b;
  const float ls = logit_scale(args.scale);
  mbar_wait(sm.bar, 0);

  float dk[D / 64][32], dv[D / 64][32];
  if constexpr (!SPLIT)
#pragma unroll
    for (int p = 0; p < D / 64; ++p) zero(dk[p]);
  for (int i = 0; i < T; ++i) {
    mbar_wait(&sm.full[i % R], (i / R) & 1);
    const bf16* Q = sm.slot(i);
    const bf16* dO = Q + tile_elems<D>();
    float l[32], dp[32];  // transposed: rows are keys, columns queries
    wgmma_fence();
    issue_nt<D>(l, K, Q);
#pragma unroll
    for (int q = 0; q < P; ++q) issue_nt<D>(dp, V, dO + q * tile_elems<D>(), q);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    fence_regs(dp);
    mask_cols(l, lay, k0, i);
    // The statistics of this thread's query columns 8 c + 2 t + {0, 1}.
    const float* st = sm.slot_stats(i) + 2 * t;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 m = *reinterpret_cast<const float2*>(st + 8 * c);
      const float2 s = *reinterpret_cast<const float2*>(st + kRows + 8 * c);
      const float2 d = *reinterpret_cast<const float2*>(st + 2 * kRows + 8 * c);
      const float ms[2] = {m.x, m.y}, inv[2] = {__frcp_rn(s.x), __frcp_rn(s.y)};
      const float dl[2] = {d.x, d.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = 4 * c + e, u = e & 1;
        l[i2] = softmax_exp(l[i2], ls, ms[u]) * inv[u];                    // wf
        dp[i2] = __fmul_rn(__fmul_rn(l[i2], dp[i2] - dl[u]), args.scale);  // ds
      }
    }
    uint32_t w[16];
    to_frags(l, w);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < P; ++q) issue_nn<D>(dv, w, dO + q * tile_elems<D>(), i || q);
    wgmma_commit();
    if constexpr (D > 64 || !SPLIT) wgmma_wait_all();  // at D = 64 dv overlaps the split
    if constexpr (SPLIT)
      split_product<D>(dk, dp, Q, i);
    else
      fma_product<D>(dk, dp, Q, sm.xs);
#pragma unroll
    for (int p = 0; p < D / 64; ++p) fence_regs(dv[p]);
    __syncthreads();  // every thread is done with slot i % R
    if (tid == 0 && i + R < T) issue(i + R);
  }
  if constexpr (L::kSums) {
    tile_col_sums<D>(dk, lay.S - k0, sm.red, lay.sum_row(1, n, h, k0, D));
    tile_col_sums<D>(dv, lay.S - k0, sm.red, lay.sum_row(2, n, h, k0, D));
  }
  stage_rows<D, SPLIT>(sm.a, dk);  // K's and V's tiles are free after the last tile
  stage_acc<D>(sm.b, dv);
  lay.template store<D>(sm.a, &dqkv_map, 1, n, h, k0);
  lay.template store<D>(sm.b, &dqkv_map, 2, n, h, k0);
}

template <int D, int T, bool SPLIT, class L>
int launch_rows_resident(const CUtensorMap& qkv_map, const CUtensorMap& do_map,
                         const CUtensorMap& dqkv_map, const BwdArgs& args, const L& lay, dim3 grid,
                         cudaStream_t st) {
  constexpr size_t smem = bwd_smem(D, T, 2, L::kParts, SPLIT, L::kSums);
  if (int err = set_smem(attention_bwd_rows_resident<D, T, SPLIT, L>, smem)) return err;
  attention_bwd_rows_resident<D, T, SPLIT, L><<<grid, kWarpgroup, smem, st>>>(qkv_map, do_map,
                                                                           dqkv_map, args, lay);
  return (int)cudaGetLastError();
}

// Both kernels on the maps of layout ``lay``: (B) resident at D = 64 and
// S <= 256, streamed elsewhere, then (A). Returns 0 or a CUDA error code.
template <int D, bool SPLIT, class L>
int launch_bwd_fused(const CUtensorMap& qkv_map, const CUtensorMap& do_map,
                     const CUtensorMap& dqkv_map, const BwdArgs& args, const L& lay, int N,
                     cudaStream_t st) {
  constexpr int P = L::kParts;
  const int T = (lay.S + 63) / 64;
  const dim3 grid(T, lay.H, N);
  int err = 0;
  bool resident = false;
  if constexpr (D == 64) {  // S <= 256 takes attention_bwd_rows_resident
    resident = T <= 4;
    switch (resident ? T : 0) {
      case 0: break;
      case 1: err = launch_rows_resident<D, 1, SPLIT>(qkv_map, do_map, dqkv_map, args, lay, grid, st); break;
      case 2: err = launch_rows_resident<D, 2, SPLIT>(qkv_map, do_map, dqkv_map, args, lay, grid, st); break;
      case 3: err = launch_rows_resident<D, 3, SPLIT>(qkv_map, do_map, dqkv_map, args, lay, grid, st); break;
      default: err = launch_rows_resident<D, 4, SPLIT>(qkv_map, do_map, dqkv_map, args, lay, grid, st);
    }
  }
  if (!resident) {
    constexpr size_t smem = bwd_smem(D, kRing, 2, P, SPLIT, L::kSums);
    err = set_smem(attention_bwd_rows<D, kRing, SPLIT, L>, smem);
    if (err == 0) {
      attention_bwd_rows<D, kRing, SPLIT, L><<<grid, kWarpgroup, smem, st>>>(qkv_map, do_map,
                                                                          dqkv_map, args, lay);
      err = (int)cudaGetLastError();
    }
  }
  if (err) return err;
  constexpr size_t smem = bwd_smem(D, kRing, 1 + P, P, SPLIT, L::kSums);
  if ((err = set_smem(attention_bwd_cols<D, kRing, SPLIT, L>, smem))) return err;
  attention_bwd_cols<D, kRing, SPLIT, L><<<grid, kWarpgroup, smem, st>>>(qkv_map, do_map,
                                                                      dqkv_map, args, lay);
  return (int)cudaGetLastError();
}

// The larger of the two kernels' dynamic shared memory at (S, D).
template <class L>
constexpr size_t bwd_fused_smem(int S, int D, bool split) {
  const size_t ring = bwd_smem(D, kRing, 1 + L::kParts, L::kParts, split, L::kSums);
  const size_t rows = D == 64 && S <= 256 ? bwd_smem(D, (S + 63) / 64, 2, L::kParts, split, L::kSums)
                                           : bwd_smem(D, kRing, 2, L::kParts, split, L::kSums);
  return ring > rows ? ring : rows;
}

}  // namespace sm90
