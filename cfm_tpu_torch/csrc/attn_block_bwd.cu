// Backward of the UNet AttentionBlock on Hopper (sm_90a), recomputing the
// forward from the saved primal inputs:
//   given x, the block's weights and dy, return dx in the model dtype T and
//   the f32 gradients dgscale, dgbias, dwq, dbq, dwo, dbo summed over the batch.
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_attn_block.py:_bwd_kernel
// (launched by _vjp_bwd). It computes the same function with the same
// rounding points, which its plain PyTorch version
// (cfm_tpu_torch/ops/attn_block.py:attention_block_backward_reference)
// spells out:
//   - recompute: GroupNorm (f32), tokens_T, qkv_T = T(T(tokens_T @ T(wq)) +
//     T(bq)), the f32 softmax wf per head, attn_T = T(T(wf) @ v);
//   - out projection: dbo = sum dy, dwo = attn_T^T @ dy, dattn = dy @ T(wo)^T
//     (f32, not rounded);
//   - per head, with do = dattn[:, head] in f32 and w = T(wf):
//       dv = w^T @ do, dp = do @ v^T, dw = dp - rowsum(dp * w),
//       ds = (wf * dw) * scale (the unrounded wf), dq = ds @ k, dk = ds^T @ q;
//   - qkv projection: dbq sums the f32 dqkv, but dwq = tokens_T^T @ T(dqkv)
//     and dtokens = T(dqkv) @ T(wq)^T use dqkv rounded to T;
//   - GroupNorm backward with x_hat = (x - mean) * rstd, and dx = T(dy + dx_gn).
//
// What bounds it on this card. At the recipe's training shape (N=128, S=256,
// C=256, H=4, D=64, bf16) the products are about 56 GFLOP with bf16 operands;
// dp, dv, dq and dk have an f32 operand (do or ds), which the card computes
// exactly as three bf16 products each: 52 GFLOP more, 108 GFLOP in all, 0.109
// ms at 989 TFLOP/s, against about 50 MB of x, dy and dx (0.015 ms at
// 3.35 TB/s). Operations bound it.
//
// bf16 at head dims 64 and 128, C a multiple of 128: the fused route, ten
// launches, no (S, S) tensor in device memory:
//   (1) GroupNorm: the strip kernel of #8 and #1 (gn_strip.cuh) writes the
//       tokens with #1's rounding (so their bits are the forward's) and
//       each (item, channel)'s mean and 1 / std;
//   (2) the weights rounded to bf16 once, as they lie (#1's launch): wq is
//       read MN-major as the qkv product's B and K-major as dtokens', wo
//       K-major as dattn's (sm90_gemm.cuh), so nothing is transposed;
//   (3) qkv = #1's TMA + wgmma GEMM (sm90_gemm.cuh) with #1's bias epilogue;
//   (4) attn = kernel #3's forward on the block's layout (BlockLayout), as
//       #1's stage (c);
//   (5) dattn = dy @ T(wo)^T on the same GEMM, its f32 result split exactly
//       into bf16 hi + mid + lo (to_split_frags's steps) in the epilogue and
//       stored by TMA;
//   (6, 7) kernel #4's rows and columns kernels on the block's layout
//       (sm90_attention_bwd.cuh, BlockBwd): the logits recomputed, dp and dv
//       from the three do parts, dq and dk from the three parts of ds, each
//       part a bf16 product whose terms are exact, so only the f32
//       accumulation rounds; dw = dp - rowsum(dp * w) taken directly. They
//       write T(dqkv) and the f32 column sums of each 64-row tile of dq, dk
//       and dv (for dbq, which sums the unrounded dqkv). Ragged S is masked
//       as #1 masks it;
//   (8) one grouped GEMM launch: dwo = attn^T dy and dwq = tokens^T T(dqkv)
//       (A read MN-major, split over the N*S rows into partial products)
//       and dtokens = T(dqkv) @ T(wq)^T, all f32, staged and stored by TMA;
//   (9) the GroupNorm backward: one block per (item, strip of whole groups)
//       reads x and dtokens for the per-channel sums, then x, dtokens and dy
//       for dx, with the means of (1); it writes each item's column sums of
//       dgscale, dgbias and dbo;
//   (10) one launch adds every set of partials (dwo, dwq over the splits;
//       dbq over the row tiles; dgscale, dgbias, dbo over the items) in a
//       fixed order.
// No atomics anywhere: a rerun gives the same bits. Rounding do to bf16 once
// (to feed the tensor cores directly) would move the weight gradients past
// chip_smoke.py's limit; the three-part split keeps the function.
//
// float32 (where f32 must mean f32), bf16 at other head dims, and C not a
// multiple of 128 take the staged route: each stage its own kernel on one
// stream, the (S, S) softmax and its gradient per head in scratch; the four
// products with an f32 operand on f32 FMA, the products of two model-dtype
// operands on bf16 tensor cores (mma.sync, f32 accumulate) in bf16 and on
// FMA in f32; the recomputed qkv GEMM with GroupNorm applied on load. The
// batched GEMMs, their operand loaders and the softmax row passes are in
// attn_block_common.cuh.

#include <algorithm>

#include "attn_block_common.cuh"
#include "gn_strip.cuh"
#include "sm90_attention_bwd.cuh"
#include "sm90_gemm.cuh"

namespace {

// A of dwq: tokens_T transposed, A(m = channel, k = row), made on load with
// the forward's GroupNorm arithmetic; runs along the channels.
template <typename T>
struct GnTokensT {
  static constexpr bool kKContig = false;
  GnTokens<T> g;
  template <int V>
  __device__ void vec(int, int c, int row, float (&out)[V]) const {
    Vec<T, V>::load(g.x + (size_t)row * g.C + c, out);
    const int base = (row / g.S) * g.G;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int stat = base + (c + u) / g.cg;
      const float centered = __fsub_rn(out[u], g.mean[stat]);
      out[u] = rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(centered, g.rstd[stat]), g.gscale[c + u]),
                                g.gbias[c + u]));
    }
  }
};

// ---------------------------------------------------------------------------
// Column passes.
// ---------------------------------------------------------------------------

// Column sums of a (R, cols) matrix given by ``load(r, c)``, in two
// deterministic passes: partial[rb][c] over row chunks, then sum_parts.
constexpr int kRowBlocks = 64;

template <typename Load>
__global__ void colsum_partial_kernel(int R, int cols, int chunk, Load load,
                                      float* __restrict__ partial) {
  __shared__ float red[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x, rb = blockIdx.y;
  const int r0 = rb * chunk, r1 = min(R, r0 + chunk);
  float s = 0.f;
  if (c < cols)
    for (int r = r0 + threadIdx.y; r < r1; r += 8) s += load(r, c);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.f;
    for (int y = 0; y < 8; ++y) t += red[y][threadIdx.x];
    partial[(size_t)rb * cols + c] = t;
  }
}

// out[i] = sum over p of part[p][i], in order of p.
__global__ void sum_parts_kernel(const float* __restrict__ part, int nparts, long long count,
                                 float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[p * count + i];
  out[i] = s;
}

template <typename S>
struct Elem {  // load(r, c) = src[r * ld + c]
  const S* p; int ld;
  __device__ float operator()(int r, int c) const { return to_f<S>(p[(size_t)r * ld + c]); }
};

template <typename T>
struct DtokensXhat {  // load(r, c) = dtokens[r, c] * x_hat[r, c]
  const float* dt; const T* x; const float* mean; const float* rstd; int S, C, G, cg;
  __device__ float operator()(int r, int c) const {
    const int stat = (r / S) * G + c / cg;
    const size_t i = (size_t)r * C + c;
    return dt[i] * __fmul_rn(__fsub_rn(to_f<T>(x[i]), mean[stat]), rstd[stat]);
  }
};

template <typename Load>
cudaError_t colsum(int R, int cols, Load load, float* partial, float* out, cudaStream_t st) {
  const int chunk = (R + kRowBlocks - 1) / kRowBlocks;
  colsum_partial_kernel<<<dim3((cols + 31) / 32, kRowBlocks), dim3(32, 8), 0, st>>>(
      R, cols, chunk, load, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_parts_kernel<<<(cols + 255) / 256, 256, 0, st>>>(partial, kRowBlocks, cols, out);
  return cudaGetLastError();
}

// GroupNorm backward, one block per (item, group):
//   m1, m2 = group means of dxhat and dxhat * x_hat, dxhat = dtokens * gscale;
//   dx = T(dy + rstd * ((dxhat - m1) - x_hat * m2)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ dt,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gscale, T* __restrict__ dx, int S, int C, int G) {
  __shared__ float red[32];
  const int n = blockIdx.x / G, g = blockIdx.x % G, cg = C / G, count = S * cg;
  const float mu = mean[blockIdx.x], rs = rstd[blockIdx.x];
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c = g * cg + i % cg;
    const size_t idx = ((size_t)n * S + i / cg) * C + c;
    const float xh = __fmul_rn(__fsub_rn(to_f<T>(x[idx]), mu), rs);
    const float dxh = __fmul_rn(dt[idx], gscale[c]);
    s1 += dxh;
    s2 = fmaf(dxh, xh, s2);
  }
  const float m1 = block_sum(s1, red) / (float)count;
  const float m2 = block_sum(s2, red) / (float)count;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int c = g * cg + i % cg;
    const size_t idx = ((size_t)n * S + i / cg) * C + c;
    const float xh = __fmul_rn(__fsub_rn(to_f<T>(x[idx]), mu), rs);
    const float dxh = __fmul_rn(dt[idx], gscale[c]);
    dx[idx] = from_f<T>(to_f<T>(dy[idx]) + rs * ((dxh - m1) - xh * m2));
  }
}

// ---------------------------------------------------------------------------
// Workspace plan: one byte buffer from the wrapper, carved here.
// ---------------------------------------------------------------------------

struct Split { int splits, kchunk; };

Split split_k(int tiles, int K) {
  int s = (4 * 132 + tiles - 1) / tiles;         // about four waves of blocks
  s = std::max(1, std::min(s, std::max(1, K / 256)));  // at least 256 rows per chunk
  int kchunk = ((K + s - 1) / s + TBK - 1) / TBK * TBK;  // a multiple of every K step
  return {(K + kchunk - 1) / kchunk, kchunk};
}

struct Plan {
  Split wo, wq;
  size_t stats, qkv, wqt, P, dP, attn, dattn, dqkv, dtok, parts, total;
};

Plan make_plan(int N, int S, int C, int H, int dtype) {
  const int D = C / H, HD = H * D, M = N * S;
  const size_t lp = dtype == 0 ? 4 : 2;
  Plan p;
  p.wo = split_k(((HD + 127) / 128) * ((C + 127) / 128), M);  // 128 x 128 tiles
  p.wq = split_k(((C + 127) / 128) * ((3 * HD + 127) / 128), M);
  size_t off = 0;
  auto take = [&](size_t bytes) { size_t at = off; off += (bytes + 255) / 256 * 256; return at; };
  p.stats = take(sizeof(float) * 2 * (size_t)N * 32 * 2);  // room for G <= 64
  p.qkv = take(lp * M * 3 * HD);
  p.wqt = take(dtype == 0 ? 0 : 2 * (size_t)3 * HD * C);
  p.P = take(sizeof(float) * (size_t)N * H * S * S);
  p.dP = take(sizeof(float) * (size_t)N * H * S * S);
  p.attn = take(lp * M * HD);
  p.dattn = take(sizeof(float) * (size_t)M * HD);
  p.dqkv = take(sizeof(float) * (size_t)M * 3 * HD);
  p.dtok = take(sizeof(float) * (size_t)M * C);
  size_t parts = std::max((size_t)p.wo.splits * HD * C, (size_t)p.wq.splits * C * 3 * HD);
  parts = std::max(parts, (size_t)kRowBlocks * std::max(3 * HD, C));
  p.parts = take(sizeof(float) * parts);
  p.total = off;
  return p;
}

#define CHECK(expr)                                 \
  do {                                              \
    const cudaError_t e_ = (expr);                  \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

template <typename T>
int launch_bwd(const T* x, const T* dy, const float* gscale, const float* gbias,
               const float* wq, const float* bq, const float* wo, T* dx, float* dgscale,
               float* dgbias, float* dwq, float* dbq, float* dwo, float* dbo,
               unsigned char* ws, int N, int S, int C, int H, int G, float scale,
               cudaStream_t st) {
  const int D = C / H, HD = H * D, HD3 = 3 * HD, M = N * S, Z = N * H, cg = C / G;
  const Plan pl = make_plan(N, S, C, H, sizeof(T) == 4 ? 0 : 1);
  float* mean = reinterpret_cast<float*>(ws + pl.stats);
  float* rstd = mean + (size_t)N * G;
  T* qkv = reinterpret_cast<T*>(ws + pl.qkv);
  float* P = reinterpret_cast<float*>(ws + pl.P);
  float* dP = reinterpret_cast<float*>(ws + pl.dP);
  T* attn = reinterpret_cast<T*>(ws + pl.attn);
  float* dattn = reinterpret_cast<float*>(ws + pl.dattn);
  float* dqkv = reinterpret_cast<float*>(ws + pl.dqkv);
  float* dtok = reinterpret_cast<float*>(ws + pl.dtok);
  float* parts = reinterpret_cast<float*>(ws + pl.parts);
  const long long SS = (long long)S * S, ldq = (long long)S * HD3, lda = (long long)S * HD;

  // ---- recompute: GroupNorm statistics, qkv, softmax, attn ----
  gn_stats_kernel<T><<<N * G, kThreads, 0, st>>>(x, mean, rstd, S, C, G, 1e-5f);
  CHECK(cudaGetLastError());
  if constexpr (sizeof(T) == 2) {
    bf16* wqt = reinterpret_cast<bf16*>(ws + pl.wqt);
    round_transpose_kernel<<<(C * HD3 + 255) / 256, 256, 0, st>>>(wq, wqt, C, HD3);
    CHECK(cudaGetLastError());
    mma_gemm_kernel<<<dim3((M + TBM - 1) / TBM, (HD3 + TBN - 1) / TBN), kThreads, 0, st>>>(
        M, HD3, C, GnTokens8{x, mean, rstd, gscale, gbias, S, C, G, cg}, wqt,
        QkvOut<bf16>{qkv, bq, HD3});
  } else {
    gemm_kernel<<<dim3((M + BM - 1) / BM, (HD3 + BN - 1) / BN), kThreads, 0, st>>>(
        M, HD3, C, GnTokens<float>{x, mean, rstd, gscale, gbias, S, C, G, cg},
        RoundedWeight<float>{wq, HD3}, QkvOut<float>{qkv, bq, HD3});
  }
  CHECK(cudaGetLastError());
  // logits = q k^T * scale; q at column h*D, k at (H + h)*D of qkv.
  CHECK(gemm_lp<T>(S, S, D, Z, 0, Operand<T, float, true>{qkv, H, ldq, D, HD3, 1},
             Operand<T, float, true>{qkv + HD, H, ldq, D, 1, HD3},
             Store<float>{P, 1, SS, 0, S, scale}, st));
  const long long rows = (long long)Z * S;
  const int row_blocks = (int)((rows + kThreads / 32 - 1) / (kThreads / 32));
  softmax_rows_kernel<<<row_blocks, kThreads, 0, st>>>(P, rows, S);
  CHECK(cudaGetLastError());
  // attn = T(T(wf) @ v), v at column (2H + h)*D.
  CHECK(gemm_lp<T>(S, D, S, Z, 0, Operand<float, T, true>{P, 1, SS, 0, S, 1},
             Operand<T, float, false>{qkv + 2 * HD, H, ldq, D, HD3, 1},
             Store<T>{attn, H, lda, D, HD, 1.f}, st));

  // ---- out projection ----
  CHECK(colsum(M, C, Elem<T>{dy, C}, parts, dbo, st));
  CHECK(gemm_lp<T>(M, HD, C, 1, 0, Operand<T, float, true>{dy, 1, 0, 0, C, 1},
             Operand<float, T, true>{wo, 1, 0, 0, 1, C},
             Store<float>{dattn, 1, 0, 0, HD, 1.f}, st));
  CHECK(gemm_lp<T>(HD, C, M, pl.wo.splits, pl.wo.kchunk,
                   Operand<T, float, false>{attn, 1, 0, 0, 1, HD},
             Operand<T, float, false>{dy, 1, 0, 0, C, 1},
             Store<float>{parts, 1, (long long)HD * C, 0, C, 1.f}, st));
  sum_parts_kernel<<<(HD * C + 255) / 256, 256, 0, st>>>(parts, pl.wo.splits, (long long)HD * C,
                                                         dwo);
  CHECK(cudaGetLastError());

  // ---- attention backward per head ----
  // dp = do @ v^T, do = dattn[:, h*D:(h+1)*D] in f32.
  CHECK(gemm(S, S, D, Z, 0, Operand<float, float, true>{dattn, H, lda, D, HD, 1},
             Operand<T, float, true>{qkv + 2 * HD, H, ldq, D, 1, HD3},
             Store<float>{dP, 1, SS, 0, S, 1.f}, st));
  softmax_bwd_rows_kernel<T><<<row_blocks, kThreads, 0, st>>>(P, dP, rows, S, scale);
  CHECK(cudaGetLastError());
  // dq = ds @ k, dk = ds^T @ q, dv = T(wf)^T @ do, into the f32 dqkv.
  CHECK(gemm(S, D, S, Z, 0, Operand<float, float, true>{dP, 1, SS, 0, S, 1},
             Operand<T, float, false>{qkv + HD, H, ldq, D, HD3, 1},
             Store<float>{dqkv, H, ldq, D, HD3, 1.f}, st));
  CHECK(gemm(S, D, S, Z, 0, Operand<float, float, false>{dP, 1, SS, 0, 1, S},
             Operand<T, float, false>{qkv, H, ldq, D, HD3, 1},
             Store<float>{dqkv + HD, H, ldq, D, HD3, 1.f}, st));
  CHECK(gemm(S, D, S, Z, 0, Operand<float, T, false>{P, 1, SS, 0, 1, S},
             Operand<float, float, false>{dattn, H, lda, D, HD, 1},
             Store<float>{dqkv + 2 * HD, H, ldq, D, HD3, 1.f}, st));

  // ---- qkv projection ----
  CHECK(colsum(M, HD3, Elem<float>{dqkv, HD3}, parts, dbq, st));
  CHECK(gemm_lp<T>(C, HD3, M, pl.wq.splits, pl.wq.kchunk,
             GnTokensT<T>{GnTokens<T>{x, mean, rstd, gscale, gbias, S, C, G, cg}},
             Operand<float, T, false>{dqkv, 1, 0, 0, HD3, 1},
             Store<float>{parts, 1, (long long)C * HD3, 0, HD3, 1.f}, st));
  sum_parts_kernel<<<(C * HD3 + 255) / 256, 256, 0, st>>>(parts, pl.wq.splits,
                                                          (long long)C * HD3, dwq);
  CHECK(cudaGetLastError());
  CHECK(gemm_lp<T>(M, C, HD3, 1, 0, Operand<float, T, true>{dqkv, 1, 0, 0, HD3, 1},
             Operand<float, T, true>{wq, 1, 0, 0, 1, HD3},
             Store<float>{dtok, 1, 0, 0, C, 1.f}, st));

  // ---- GroupNorm backward ----
  CHECK(colsum(M, C, Elem<float>{dtok, C}, parts, dgbias, st));
  CHECK(colsum(M, C, DtokensXhat<T>{dtok, x, mean, rstd, S, C, G, cg}, parts, dgscale, st));
  gn_bwd_kernel<T><<<N * G, kThreads, 0, st>>>(x, dy, dtok, mean, rstd, gscale, dx, S, C, G);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The fused bf16 route (head dims 64 and 128, C a multiple of 128).
// ---------------------------------------------------------------------------

// (1) the GroupNorm strip's epilogue: the tokens rounded as #1 rounds them,
// and each (item, channel)'s mean and 1 / std for stage (9).
struct TokensStats {
  bf16* out;
  const float* scale;
  const float* bias;
  float* mean;
  float* inv;
  __device__ void stats(size_t i, float mu, float iv) const {
    mean[i] = mu;
    inv[i] = iv;
  }
  __device__ static float apply(float x, float mu, float iv, float sc, float bi) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), iv), sc), bi);
  }
};

// (5) dattn in f32, split exactly into bf16 hi + mid + lo in the GEMM's
// epilogue (sm90::split3), part q to columns q HD .. of the (M, 3HD) do buffer.
struct SplitDoEpi {
  static constexpr int kMode = 0, kParts = 3;
  int HD;
  __device__ int part_col(int q) const { return q * HD; }
};

// (8) f32 results to rank-3 maps: the split-K partials of dwo and dwq, and
// dtokens.
struct F32Epi {
  static constexpr int kMode = 1, kParts = 1;
};

// (9) GroupNorm backward, one block per (item, strip of W channels of whole
// groups), 8 channels a thread, R = 256 / (W / 8) row slots; the mean and
// 1 / std are stage (1)'s. Pass 1 reads x and dtokens for each channel's
// sums of dtokens (dgbias) and dtokens * x_hat (dgscale); the group means
// m1 = sum(gscale * dtokens) / count, m2 = sum(gscale * dtokens * x_hat) /
// count follow from them. Pass 2 reads x, dtokens (again, from L2) and dy:
//   dx = T(dy + inv * ((dtokens * gscale - m1) - x_hat * m2)),
// and sums dy for dbo. Each sum runs over the thread's rows in order, then
// the row slots in order: the item's column sums go to ``parts`` (dgscale,
// dgbias, dbo, each (N, C)), which stage (10) adds over the items in order.
constexpr int kGnThreads = 256;

__global__ void __launch_bounds__(kGnThreads)
gn_bwd_strip_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const float* __restrict__ dt, const float* __restrict__ mean,
                    const float* __restrict__ inv, const float* __restrict__ gscale,
                    bf16* __restrict__ dx, float* __restrict__ parts, int N, int S, int C, int cg,
                    int W) {
  __shared__ float slots[kGnThreads * 8];
  __shared__ float tot[2][256], m1s[256], m2s[256];
  const int tid = threadIdx.x, n = blockIdx.y, c0 = blockIdx.x * W;
  const int nv = W / 8, R = kGnThreads / nv, j = tid % nv, r0 = tid / nv;
  const bool active = r0 < R;
  const size_t NC = (size_t)N * C;
  float mu[8], iv[8], gs[8], s1[8], s2[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = c0 + 8 * j + u;
    mu[u] = mean[(size_t)n * C + c];
    iv[u] = inv[(size_t)n * C + c];
    gs[u] = gscale[c];
    s1[u] = s2[u] = 0.f;
  }
  const size_t base = (size_t)n * S * C + c0 + 8 * j;
  auto load8 = [&](const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __bfloat162float(e[u]);
  };
  auto load8f = [&](const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  };
  // The column totals of the per-thread sums v[8] over the row slots, in order.
  auto totals = [&](const float (&v)[8], float* out) {
#pragma unroll
    for (int u = 0; u < 8; ++u) slots[tid * 8 + u] = v[u];
    __syncthreads();
    if (tid < W) {
      float a = 0.f;
      for (int rr = 0; rr < R; ++rr) a += slots[(rr * nv + tid / 8) * 8 + tid % 8];
      out[tid] = a;
    }
    __syncthreads();
  };
  if (active)
    for (int r = r0; r < S; r += R) {
      float xv[8], dv[8];
      load8(x + base + (size_t)r * C, xv);
      load8f(dt + base + (size_t)r * C, dv);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        s1[u] += dv[u];
        s2[u] = fmaf(dv[u], __fmul_rn(__fsub_rn(xv[u], mu[u]), iv[u]), s2[u]);
      }
    }
  totals(s1, tot[0]);
  totals(s2, tot[1]);
  if (tid < W) {
    parts[NC + (size_t)n * C + c0 + tid] = tot[0][tid];  // dgbias
    parts[(size_t)n * C + c0 + tid] = tot[1][tid];       // dgscale
    const int g0 = tid - tid % cg;
    float a = 0.f, b = 0.f;
    for (int k = g0; k < g0 + cg; ++k) {
      a = fmaf(gscale[c0 + k], tot[0][k], a);
      b = fmaf(gscale[c0 + k], tot[1][k], b);
    }
    const float cnt = (float)S * (float)cg;
    m1s[tid] = a / cnt;
    m2s[tid] = b / cnt;
  }
  __syncthreads();
  float m1[8], m2[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    m1[u] = m1s[8 * j + u];
    m2[u] = m2s[8 * j + u];
    s1[u] = 0.f;
  }
  if (active)
    for (int r = r0; r < S; r += R) {
      float xv[8], dv[8], yv[8];
      load8(x + base + (size_t)r * C, xv);
      load8f(dt + base + (size_t)r * C, dv);
      load8(dy + base + (size_t)r * C, yv);
      uint4 raw;
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float xh = __fmul_rn(__fsub_rn(xv[u], mu[u]), iv[u]);
        const float dxh = __fmul_rn(dv[u], gs[u]);
        e[u] = __float2bfloat16_rn(yv[u] + iv[u] * ((dxh - m1[u]) - xh * m2[u]));
        s1[u] += yv[u];
      }
      *reinterpret_cast<uint4*>(dx + base + (size_t)r * C) = raw;
    }
  totals(s1, tot[0]);
  if (tid < W) parts[2 * NC + (size_t)n * C + c0 + tid] = tot[0][tid];  // dbo
}

// (10) out[i] = the sum over p of src[p * count + i] for each of the six
// gradients, in a fixed order: ``ways`` neighbouring lanes of a warp take a
// column (more where it has more parts), lane y adding the parts y,
// y + ways, ... in order; a butterfly over the ways lanes adds their sums.
struct SumJob {
  const float* src;
  float* dst;
  int parts, count, ways;
  int first;  // the job's first thread, a multiple of 32
};
struct SumJobs {
  SumJob job[6];
  int threads;
};

__global__ void __launch_bounds__(256) sum_jobs_kernel(const SumJobs jobs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int k = 0;
  while (k < 5 && t >= jobs.job[k + 1].first) ++k;
  const SumJob& jb = jobs.job[k];
  const int i = (t - jb.first) / jb.ways, y = (t - jb.first) % jb.ways;
  float s = 0.f;
  if (i < jb.count)
#pragma unroll 4
    for (int p = y; p < jb.parts; p += jb.ways) s += jb.src[(size_t)p * jb.count + i];
  for (int o = jb.ways >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (i < jb.count && y == 0) jb.dst[i] = s;
}

// The lanes a column of a sum with ``parts`` parts takes.
int sum_ways(int parts) { return parts >= 64 ? 8 : parts >= 16 ? 4 : 1; }

// The GroupNorm backward's strip: the least multiple of lcm(cg, 8) channels
// that is at least 64 and divides C (C itself where none does).
int gn_strip_width(int C, int cg) {
  int l = cg;
  while (l % 8) l += cg;
  for (int w = l; w <= 256 && w <= C; w += l)
    if (w >= 64 && C % w == 0) return w;
  return C <= 256 && C % l == 0 ? C : 0;
}

// The K splits asked of the weight-gradient products over the N*S rows:
// about 1024 rows a split.
int split_ask(int M) { return std::max(1, (M + 1023) / 1024); }

struct FusedPlan {
  int T, splits;  // splits: those dwo's and dwq's products take
  size_t mean, inv, tokens, wb, qkv, attn, dos, stats, dqkv, dtok, p_wo, p_wq, p_bq, p_g, total;
};

FusedPlan make_fused_plan(int N, int S, int C, int H) {
  const int D = C / H, HD = H * D, M = N * S;
  FusedPlan p;
  p.T = (S + 63) / 64;
  p.splits = sm90::gemm_splits(M, split_ask(M));
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 1023) / 1024 * 1024;
    return at;
  };
  p.mean = take(4 * (size_t)N * C);
  p.inv = take(4 * (size_t)N * C);
  p.tokens = take(2 * (size_t)M * C);
  p.wb = take(2 * (size_t)4 * C * HD);
  p.qkv = take(2 * (size_t)M * 3 * HD);
  p.attn = take(2 * (size_t)M * HD);
  p.dos = take(2 * (size_t)M * 3 * HD);
  p.stats = take(4 * (size_t)3 * N * H * 64 * p.T);
  p.dqkv = take(2 * (size_t)M * 3 * HD);
  p.dtok = take(4 * (size_t)M * C);
  p.p_wo = take(4 * (size_t)p.splits * HD * C);
  p.p_wq = take(4 * (size_t)p.splits * C * 3 * HD);
  p.p_bq = take(4 * (size_t)N * p.T * 3 * HD);
  p.p_g = take(4 * (size_t)3 * N * C);
  p.total = off;
  return p;
}

// The route of a call: the fused one in bf16 at head dims 64 and 128 with C
// a multiple of 128, the staged one otherwise.
bool fused_route(int C, int H, int G, int dtype) {
  const int D = C / H;
  return dtype == 1 && (D == 64 || D == 128) && C % 128 == 0 && gn_strip_width(C, C / G) > 0;
}

int launch_fused(const bf16* x, const bf16* dy, const float* gscale, const float* gbias,
                 const float* wq, const float* bq, const float* wo, bf16* dx, float* dgscale,
                 float* dgbias, float* dwq, float* dbq, float* dwo, float* dbo, unsigned char* ws,
                 int N, int S, int C, int H, int G, float scale, const gnstrip::Plan& plan,
                 cudaStream_t st) {
  const int D = C / H, HD = H * D, HD3 = 3 * HD, M = N * S, cg = C / G;
  const FusedPlan pl = make_fused_plan(N, S, C, H);
  const int W = gn_strip_width(C, cg);
  auto f32 = [&](size_t off) { return reinterpret_cast<float*>(ws + off); };
  auto b16 = [&](size_t off) { return reinterpret_cast<bf16*>(ws + off); };
  float *mean = f32(pl.mean), *inv = f32(pl.inv), *dtok = f32(pl.dtok);
  float *p_wo = f32(pl.p_wo), *p_wq = f32(pl.p_wq), *p_bq = f32(pl.p_bq), *p_g = f32(pl.p_g);
  bf16 *tokens = b16(pl.tokens), *wqb = b16(pl.wb), *wob = wqb + (size_t)C * HD3;
  bf16 *qkv = b16(pl.qkv), *attn = b16(pl.attn), *dos = b16(pl.dos), *dqkv = b16(pl.dqkv);
  // (1) GroupNorm: tokens, mean, 1 / std.
  if (int e = gnstrip::launch<bf16>(x, TokensStats{tokens, gscale, gbias, mean, inv}, N, S, C, G,
                                    plan, 1e-5f, st))
    return e;
  // (2) the weights, rounded once as they lie (#1's launch).
  if (int e = sm90::round_weights(wq, wo, wqb, C, HD, st)) return e;
  // (3) qkv, (4) attn = #3's forward on the block's layout.
  if (int e = sm90::tma_gemm(tokens, wqb, 0, qkv, HD3, M, HD3, C, sm90::BiasEpi{bq}, st))
    return e;
  CUtensorMap qkv_map, attn_map, do_map, dqkv_map;
  if (int e = sm90::make_item_map(&qkv_map, qkv, HD3, S, N)) return e;
  if (int e = sm90::make_item_map(&attn_map, attn, HD, S, N)) return e;
  if (int e = sm90::make_item_map(&do_map, dos, HD3, S, N)) return e;
  if (int e = sm90::make_item_map(&dqkv_map, dqkv, HD3, S, N)) return e;
  const sm90::BlockLayout fwd{H, S};
  if (int e = D == 64 ? sm90::launch_tensor_core<64>(qkv_map, attn_map, fwd, N, scale, st)
                      : sm90::launch_tensor_core<128>(qkv_map, attn_map, fwd, N, scale, st))
    return e;
  // (5) dattn = dy T(wo)^T in f32 (wo read K-major), split into three bf16 parts.
  if (int e = sm90::tma_gemm(dy, wob, 1, dos, HD3, M, HD, C, SplitDoEpi{HD}, st)) return e;
  // (6, 7) the attention backward: dq, dk, dv in bf16 and their f32 column sums.
  const sm90::BwdArgs args{f32(pl.stats), scale, (long long)N * H * 64 * pl.T};
  const sm90::BlockBwd lay{H, S, p_bq};
  const int attn_err =
      D == 64 ? sm90::launch_bwd_fused<64, true>(qkv_map, do_map, dqkv_map, args, lay, N, st)
              : sm90::launch_bwd_fused<128, true>(qkv_map, do_map, dqkv_map, args, lay, N, st);
  if (attn_err) return attn_err;
  // (8) dwo = attn^T dy and dwq = tokens^T T(dqkv) in split-K partials, and
  // dtokens = T(dqkv) T(wq)^T, in one grouped launch.
  sm90::GemmArgs<3> g;
  int blocks = 0;
  if (int e = sm90::gemm_problem(g, 0, attn, 1, dy, 0, HD, C, M, split_ask(M), blocks)) return e;
  if (int e = sm90::out_f32(g, 0, p_wo, C, HD, pl.splits)) return e;
  if (int e = sm90::gemm_problem(g, 1, tokens, 1, dqkv, 0, C, HD3, M, split_ask(M), blocks))
    return e;
  if (int e = sm90::out_f32(g, 1, p_wq, HD3, C, pl.splits)) return e;
  if (int e = sm90::gemm_problem(g, 2, dqkv, 0, wqb, 1, M, C, HD3, 1, blocks)) return e;
  if (int e = sm90::out_f32(g, 2, dtok, C, M, 1)) return e;
  if (int e = sm90::launch_gemm(g, blocks, F32Epi{}, st)) return e;
  // (9) GroupNorm backward: dx and the per-item sums of dgscale, dgbias, dbo.
  gn_bwd_strip_kernel<<<dim3(C / W, N), kGnThreads, 0, st>>>(x, dy, dtok, mean, inv, gscale, dx,
                                                             p_g, N, S, C, cg, W);
  CHECK(cudaGetLastError());
  // (10) every sum over partials, in a fixed order.
  SumJobs jobs{{{p_wo, dwo, pl.splits, HD * C},
                {p_wq, dwq, pl.splits, C * HD3},
                {p_bq, dbq, N * pl.T, HD3},
                {p_g, dgscale, N, C},
                {p_g + (size_t)N * C, dgbias, N, C},
                {p_g + 2 * (size_t)N * C, dbo, N, C}},
               0};
  for (SumJob& jb : jobs.job) {
    jb.ways = sum_ways(jb.parts);
    jb.first = jobs.threads;
    jobs.threads += (jb.count * jb.ways + 31) / 32 * 32;
  }
  sum_jobs_kernel<<<(jobs.threads + 255) / 256, 256, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch the wrapper must pass for this shape, group count and
// dtype (0 = float32, 1 = bfloat16), on the route the call will take.
size_t attn_block_bwd_workspace(int N, int S, int C, int H, int G, int dtype) {
  return fused_route(C, H, G, dtype) ? make_fused_plan(N, S, C, H).total
                                     : make_plan(N, S, C, H, dtype).total;
}

// Whether the call takes the fused bf16 route (1) or the staged one (0).
int attn_block_bwd_fused(int C, int H, int G, int dtype) { return fused_route(C, H, G, dtype); }

// x, dy, dx: (N, S, C) in the model dtype, contiguous and 16-byte aligned.
// gscale, gbias: (C,) f32; wq: (C, 3HD) f32; bq: (3HD,) f32; wo: (HD, C)
// f32. Outputs dgscale, dgbias (C,), dwq (C, 3HD), dbq (3HD,), dwo (HD, C),
// dbo (C,), all f32 and fully written. ws: attn_block_bwd_workspace bytes.
// The fused route also takes the GroupNorm strip's plan (width, cluster,
// items, rows, box_rows, boxes) of strip_plan; the staged route ignores it.
// Returns 0 or the first CUDA error code.
int attn_block_bwd(const void* x, const void* dy, const float* gscale, const float* gbias,
                   const float* wq, const float* bq, const float* wo, void* dx,
                   float* dgscale, float* dgbias, float* dwq, float* dbq, float* dwo,
                   float* dbo, void* ws, int N, int S, int C, int H, int G, float scale,
                   int dtype, int width, int cluster, int items, int rows, int box_rows,
                   int boxes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (G > 64) return (int)cudaErrorInvalidValue;
  if (fused_route(C, H, G, dtype))
    return launch_fused(static_cast<const bf16*>(x), static_cast<const bf16*>(dy), gscale, gbias,
                        wq, bq, wo, static_cast<bf16*>(dx), dgscale, dgbias, dwq, dbq, dwo, dbo,
                        w, N, S, C, H, G, scale,
                        gnstrip::Plan{width, cluster, items, rows, box_rows, boxes}, st);
  if (dtype == 0)
    return launch_bwd<float>(static_cast<const float*>(x), static_cast<const float*>(dy),
                             gscale, gbias, wq, bq, wo, static_cast<float*>(dx), dgscale,
                             dgbias, dwq, dbq, dwo, dbo, w, N, S, C, H, G, scale, st);
  if (dtype == 1)
    return launch_bwd<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy), gscale,
                            gbias, wq, bq, wo, static_cast<bf16*>(dx), dgscale, dgbias, dwq,
                            dbq, dwo, dbo, w, N, S, C, H, G, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
