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
// Cross-item sums. The TPU kernel accumulates the weight gradients across its
// sequential grid cells (+= into one block). Hopper blocks run in parallel in
// no order, so that does not carry over. Here the per-item operands (tokens,
// dqkv, attn, dy) are laid out as (N*S, .) matrices and dwq, dwo are GEMMs
// whose reduction runs over all N*S rows, split into chunks whose partial
// sums a second kernel adds in a fixed order. dbq, dbo, dgscale and dgbias
// are column sums done the same way: deterministic, no atomics.
//
// Two arithmetic paths. The four products with an f32 operand (dv, dp, dq,
// dk: do and ds are f32 in the TPU kernel, and interpret mode makes them
// true f32 products) run as f32 FMA in both dtypes: rounding do or ds to
// bf16 to feed a tensor core would change the function. The products of two
// model-dtype operands (logits, attn, dattn, dwo, dwq, dtokens) run on bf16
// tensor cores (mma.sync, f32 accumulate) when T is bf16, and as f32 FMA
// when T is float, where f32 must mean f32. The recomputed qkv GEMM reuses
// the forward's stage kernels (GroupNorm statistics, and in bf16 the
// mma.sync GEMM with GroupNorm on load).
//
// What bounds it on this card. At the recipe's training shape (N=128, S=256,
// C=256, H=4, D=64) the work is about 73 GFLOP against about 50 MB of x, dy
// and dx: far above the ridge, so operations bound it: about 56 GFLOP with
// bf16 operands at the tensor-core rate and 17 GFLOP with f32 operands at
// the non-tensor f32 rate. This version writes the (S, S) softmax and
// its gradient per head to scratch (2 x 134 MB at that shape) and reads them
// back, and runs each stage as its own kernel on one stream. No TMA, wgmma or
// pipelining yet: PERF.md holds its time against the bound. The batched
// GEMMs, their operand loaders and the softmax row passes are in
// attn_block_common.cuh, shared with the multi-head attention backward (#4).

#include <algorithm>

#include "attn_block_common.cuh"

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

}  // namespace

extern "C" {

// Bytes of scratch the wrapper must pass for this shape and dtype
// (0 = float32, 1 = bfloat16).
size_t attn_block_bwd_workspace(int N, int S, int C, int H, int dtype) {
  return make_plan(N, S, C, H, dtype).total;
}

// x, dy, dx: (N, S, C) in the model dtype, contiguous and 16-byte aligned.
// gscale, gbias: (C,) f32; wq: (C, 3HD) f32; bq: (3HD,) f32; wo: (HD, C)
// f32. Outputs dgscale, dgbias (C,), dwq (C, 3HD), dbq (3HD,), dwo (HD, C),
// dbo (C,), all f32 and fully written. ws: attn_block_bwd_workspace bytes.
// Returns 0 or the first CUDA error code.
int attn_block_bwd(const void* x, const void* dy, const float* gscale, const float* gbias,
                   const float* wq, const float* bq, const float* wo, void* dx,
                   float* dgscale, float* dgbias, float* dwq, float* dbq, float* dwo,
                   float* dbo, void* ws, int N, int S, int C, int H, int G, float scale,
                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (G > 64) return (int)cudaErrorInvalidValue;
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
