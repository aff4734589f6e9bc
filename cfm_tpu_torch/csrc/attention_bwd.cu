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
// TMA (attention_fwd.cu's note):
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
#include "sm90_attention.cuh"

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

// ---------------------------------------------------------------------------
// The fused bf16 kernels.
// ---------------------------------------------------------------------------

using namespace sm90;

constexpr int kWarpgroup = 128;
constexpr int kDsLd = 68;  // f32 row stride of the FMA variant's ds tile in shared memory
constexpr int kStatBytes = 3 * kRows * sizeof(float);  // a query tile's max, sum and delta

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

// An output tile from accumulators, staged for store_tile: SPLIT holds them
// in the wgmma layout, the FMA variant in its own.
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

// Shared memory of either kernel: two resident tiles, a ring of R slots of
// two tiles, the FMA variant's ds tile, 1 + R barriers.
constexpr size_t fused_smem(int D, int R, bool split) {
  return 1024 + (size_t)(2 + 2 * R) * 2 * kRows * D + (split ? 0 : 4 * kRows * kDsLd) +
         R * kStatBytes + (1 + R) * sizeof(uint64_t);
}

// Ring slots (of two tiles each) of the streaming kernels: the rows kernel
// streams K and V through them where they are not resident (S > 256, or
// D = 128), the columns kernel Q and do; two keep a load in flight. And the
// blocks an SM holds of them: registers are held to 65536 / (128 x blocks).
constexpr int kRing = 2;
__host__ __device__ constexpr int bwd_blocks(int D) { return D == 64 ? 3 : 1; }

struct BwdArgs {
  bf16* dqkv;
  float* stats;      // (3, N, H, S): row max, row sum, delta
  int H, S;
  float scale;
  long long nhs;     // N * H * S
};

// Carve the dynamic shared memory: tiles a, b, the ring, xs, the ring's
// statistics (the columns kernel's), barriers.
template <int D, int R, bool SPLIT>
struct Smem {
  bf16 *a, *b, *ring;
  float *xs, *stats;
  uint64_t *bar, *full;
  __device__ explicit Smem(uint8_t* raw) {
    a = reinterpret_cast<bf16*>(align_1024(raw));
    b = a + tile_elems<D>();
    ring = b + tile_elems<D>();
    xs = reinterpret_cast<float*>(ring + 2 * R * tile_elems<D>());
    stats = xs + (SPLIT ? 0 : kRows * kDsLd);
    bar = reinterpret_cast<uint64_t*>(stats + R * 3 * kRows);
    full = bar + 1;
  }
  __device__ bf16* slot(int i) const { return ring + 2 * (i % R) * tile_elems<D>(); }
  __device__ float* slot_stats(int i) const { return stats + (i % R) * 3 * kRows; }
};

// (B) one block per 64 query rows of one (item, head): dq and the statistics.
template <int D, int R, bool SPLIT>
__global__ void __launch_bounds__(kWarpgroup, bwd_blocks(D))
attention_bwd_rows(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap dqkv_map, BwdArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D, R, SPLIT> sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int H = args.H, S = args.S, h = blockIdx.y, n = blockIdx.z;
  const int T = S / 64, q0 = 64 * blockIdx.x;
  const bool streamed = T > R;  // else K and V stay resident through the three passes
  const int loads = streamed ? 3 * T : T;
  const int row_q = ((n * 3) * H + h) * S, row_k = row_q + H * S, row_v = row_k + H * S;
  const int row_z = (n * H + h) * S;  // (n, h)'s first row of do and of the statistics
  auto issue = [&](int i) {  // thread 0 only: K and V of key tile i % T
    uint64_t* bar = &sm.full[i % R];
    mbar_expect_tx(bar, 2 * tile_bytes<D>());
    load_tile<D>(sm.slot(i), &qkv_map, bar, row_k + 64 * (i % T));
    load_tile<D>(sm.slot(i) + tile_elems<D>(), &qkv_map, bar, row_v + 64 * (i % T));
  };
  auto acquire = [&](int pass, int j) {
    const int i = streamed ? pass * T + j : j;
    mbar_wait(&sm.full[i % R], (i / R) & 1);
    return sm.slot(i);
  };
  auto release = [&](int pass, int j) {
    if (!streamed) return;
    const int i = pass * T + j;
    __syncthreads();
    if (tid == 0 && i + R < loads) issue(i + R);
  };
  if (tid == 0) {
    for (int s = 0; s <= R; ++s) mbar_init(&sm.bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sm.bar, 2 * tile_bytes<D>());
    load_tile<D>(sm.a, &qkv_map, sm.bar, row_q + q0);
    load_tile<D>(sm.b, &do_map, sm.bar, row_z + q0);
    for (int i = 0; i < R && i < loads; ++i) issue(i);
  }
  const bf16 *Q = sm.a, *dO = sm.b;
  const float ls = logit_scale(args.scale);
  mbar_wait(sm.bar, 0);

  // Pass 0: the row max and the rescaled running sum.
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int j = 0; j < T; ++j) {
    const bf16* K = acquire(0, j);
    float l[32];
    wgmma_fence();
    issue_nt<D>(l, Q, K);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    release(0, j);
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
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
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
      issue_nt<D>(dp, dO, V);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(l);
      fence_regs(dp);
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
  stage_rows<D, SPLIT>(sm.a, dq);
  store_tile<D>(sm.a, &dqkv_map, row_q + q0);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long s = row_z + q0 + 16 * warp + g + 8 * r;
      args.stats[s] = mx[r];
      args.stats[args.nhs + s] = sum[r];
      args.stats[2 * args.nhs + s] = delta[r];
    }
}

// (B) at S = 64 T <= 256 and D = 64: the whole logits row of the block's
// queries stays in registers, so the exact row max and sum take one pass
// and wf one exponential an element; dp is recomputed for delta and for ds.
template <int D, int T, bool SPLIT>
__global__ void __launch_bounds__(kWarpgroup, 1)
attention_bwd_rows_resident(const __grid_constant__ CUtensorMap qkv_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap dqkv_map, BwdArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D, T, SPLIT> sm(smem_raw);  // ring: K tiles, then V tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int H = args.H, S = 64 * T, h = blockIdx.y, n = blockIdx.z, q0 = 64 * blockIdx.x;
  const int row_q = ((n * 3) * H + h) * S, row_k = row_q + H * S, row_v = row_k + H * S;
  const int row_z = (n * H + h) * S;
  const bf16 *Q = sm.a, *dO = sm.b, *Ks = sm.ring, *Vs = sm.ring + T * tile_elems<D>();
  if (tid == 0) {
    mbar_init(&sm.bar[0], 1);
    mbar_init(&sm.bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.bar[0], (1 + T) * tile_bytes<D>());
    load_tile<D>(sm.a, &qkv_map, &sm.bar[0], row_q + q0);
    for (int j = 0; j < T; ++j)
      load_tile<D>(sm.ring + j * tile_elems<D>(), &qkv_map, &sm.bar[0], row_k + 64 * j);
    mbar_expect_tx(&sm.bar[1], (1 + T) * tile_bytes<D>());
    load_tile<D>(sm.b, &do_map, &sm.bar[1], row_z + q0);
    for (int j = 0; j < T; ++j)
      load_tile<D>(sm.ring + (T + j) * tile_elems<D>(), &qkv_map, &sm.bar[1], row_v + 64 * j);
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
    issue_nt<D>(dp, dO, Vs + j * tile_elems<D>());
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
    issue_nt<D>(dp, dO, Vs + j * tile_elems<D>());
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
  stage_rows<D, SPLIT>(sm.a, dq);
  store_tile<D>(sm.a, &dqkv_map, row_q + q0);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long s = row_z + q0 + 16 * warp + g + 8 * r;
      args.stats[s] = mx[r];
      args.stats[args.nhs + s] = sum[r];
      args.stats[2 * args.nhs + s] = delta[r];
    }
}

// (A) one block per 64 keys of one (item, head): dk and dv, over the query
// tiles, from the statistics attention_bwd_rows wrote.
template <int D, int R, bool SPLIT>
__global__ void __launch_bounds__(kWarpgroup, bwd_blocks(D))
attention_bwd_cols(const __grid_constant__ CUtensorMap qkv_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap dqkv_map, BwdArgs args) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D, R, SPLIT> sm(smem_raw);
  const int tid = threadIdx.x, t = tid & 3;
  const int H = args.H, S = args.S, h = blockIdx.y, n = blockIdx.z;
  const int T = S / 64, k0 = 64 * blockIdx.x;
  const int row_q = ((n * 3) * H + h) * S, row_k = row_q + H * S, row_v = row_k + H * S;
  const int row_z = (n * H + h) * S;
  auto issue = [&](int i) {  // thread 0 only: Q, do and the statistics of query tile i
    uint64_t* bar = &sm.full[i % R];
    mbar_expect_tx(bar, 2 * tile_bytes<D>() + kStatBytes);
    load_tile<D>(sm.slot(i), &qkv_map, bar, row_q + 64 * i);
    load_tile<D>(sm.slot(i) + tile_elems<D>(), &do_map, bar, row_z + 64 * i);
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
    load_tile<D>(sm.a, &qkv_map, sm.bar, row_k + k0);
    load_tile<D>(sm.b, &qkv_map, sm.bar, row_v + k0);
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
    issue_nt<D>(dp, V, dO);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    fence_regs(dp);
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
    issue_nn<D>(dv, w, dO, i);
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
  stage_rows<D, SPLIT>(sm.a, dk);  // K's and V's tiles are free after the last tile
  stage_acc<D>(sm.b, dv);
  store_tile<D>(sm.a, &dqkv_map, row_k + k0);
  store_tile<D>(sm.b, &dqkv_map, row_v + k0);
}

template <int D, int T, bool SPLIT>
int launch_rows_resident(const CUtensorMap& qkv_map, const CUtensorMap& do_map,
                         const CUtensorMap& dqkv_map, const BwdArgs& args, dim3 grid,
                         cudaStream_t st) {
  constexpr size_t smem = fused_smem(D, T, SPLIT);
  const cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_resident<D, T, SPLIT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_rows_resident<D, T, SPLIT><<<grid, kWarpgroup, smem, st>>>(qkv_map, do_map,
                                                                        dqkv_map, args);
  return (int)cudaGetLastError();
}

template <int D, bool SPLIT>
int launch_fused(const bf16* qkv, const bf16* dout, const BwdArgs& args, int N, cudaStream_t st) {
  constexpr size_t ring_smem = fused_smem(D, kRing, SPLIT);
  CUtensorMap qkv_map, do_map, dqkv_map;
  if (int err = make_tile_map(&qkv_map, qkv, D, 3LL * N * args.H * args.S)) return err;
  if (int err = make_tile_map(&dqkv_map, args.dqkv, D, 3LL * N * args.H * args.S)) return err;
  if (int err = make_tile_map(&do_map, dout, D, (long long)N * args.H * args.S)) return err;
  const dim3 grid(args.S / 64, args.H, N);
  cudaError_t err = cudaSuccess;
  bool resident = false;
  if constexpr (D == 64) {  // S <= 256 takes attention_bwd_rows_resident
    resident = args.S <= 256;
    switch (resident ? args.S / 64 : 0) {
      case 0: break;
      case 1: err = (cudaError_t)launch_rows_resident<D, 1, SPLIT>(qkv_map, do_map, dqkv_map, args, grid, st); break;
      case 2: err = (cudaError_t)launch_rows_resident<D, 2, SPLIT>(qkv_map, do_map, dqkv_map, args, grid, st); break;
      case 3: err = (cudaError_t)launch_rows_resident<D, 3, SPLIT>(qkv_map, do_map, dqkv_map, args, grid, st); break;
      default: err = (cudaError_t)launch_rows_resident<D, 4, SPLIT>(qkv_map, do_map, dqkv_map, args, grid, st);
    }
  }
  if (!resident) {
    err = cudaFuncSetAttribute(attention_bwd_rows<D, kRing, SPLIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring_smem);
    if (err == cudaSuccess) {
      attention_bwd_rows<D, kRing, SPLIT><<<grid, kWarpgroup, ring_smem, st>>>(qkv_map, do_map,
                                                                           dqkv_map, args);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_cols<D, kRing, SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring_smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_cols<D, kRing, SPLIT><<<grid, kWarpgroup, ring_smem, st>>>(qkv_map, do_map,
                                                                         dqkv_map, args);
  return (int)cudaGetLastError();
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
  const size_t ring = fused_smem(D, kRing, split != 0);
  const size_t resident = D == 64 && S <= 256 ? fused_smem(D, S / 64, split != 0) : 0;
  return ring > resident ? ring : resident;
}

// The fused bf16 route: qkv, dqkv (N, 3, H, S, D), dout (N, H, S, D),
// contiguous bf16; D = 64 or 128; S a multiple of 64; stats 3 N H S f32.
// split = 1 computes dq and dk as three exact bf16 products, 0 on f32 FMA.
// Returns 0 or the first CUDA error code.
int attention_bwd_fused(const void* qkv, const void* dout, void* dqkv, void* stats, int N, int H,
                        int S, int D, float scale, int split, void* stream) {
  if (S % 64 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs args{static_cast<bf16*>(dqkv), static_cast<float*>(stats), H, S, scale,
                     (long long)N * H * S};
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  if (D == 64)
    return split ? launch_fused<64, true>(q, d, args, N, st) : launch_fused<64, false>(q, d, args, N, st);
  return split ? launch_fused<128, true>(q, d, args, N, st) : launch_fused<128, false>(q, d, args, N, st);
}

}  // extern "C"
