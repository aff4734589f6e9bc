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
// pipelining yet: PERF.md holds its time against the bound.

#include <algorithm>

#include "attn_block_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Operand loaders. Each returns V consecutive values along the operand's
// contiguous index, starting at (i, j): (m, k) for A, (k, n) for B. Every
// extent and offset the kernels use is a multiple of 8 elements (S % 8 == 0,
// D % 64 == 0), so a run of V never straddles a tile edge and its address is
// aligned for a V-wide vector load.
// ---------------------------------------------------------------------------

template <typename S, int V> struct Vec;
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
};
template <> struct Vec<float, 8> {
  __device__ static void load(const float* p, float* out) {
    Vec<float, 4>::load(p, out);
    Vec<float, 4>::load(p + 4, out + 4);
  }
};
template <> struct Vec<bf16, 4> {
  __device__ static void load(const bf16* p, float* out) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
    for (int u = 0; u < 4; ++u) out[u] = __bfloat162float(h[u]);
  }
};
template <> struct Vec<bf16, 8> {
  __device__ static void load(const bf16* p, float* out) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
    for (int u = 0; u < 8; ++u) out[u] = __bfloat162float(h[u]);
  }
};

template <int V, typename Load>
__device__ __forceinline__ void load_or_zero(const Load& load, int z, int i, int j, bool in,
                                             float (&out)[V]) {
  if (in) {
    load.template vec<V>(z, i, j, out);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = 0.f;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// ---------------------------------------------------------------------------
// Batched f32 FMA GEMM: C[z](m, n) = sum_k A(z, m, k) * B(z, k, n) over
// (16 TM) x (16 TN) tiles, K in steps of 8, 256 threads of TM x TN outputs
// each, fed from shared memory by float4 reads; a thread's columns are
// 4-wide groups 64 apart, so each epilogue row is written coalesced. With kchunk = 0, z is a batch
// index passed to the loaders; with kchunk > 0, z splits K into chunks of
// kchunk and the epilogue writes one partial sum per chunk. Each loader says
// whether consecutive k are adjacent in memory (kKContig), and the tile load
// maps threads along the contiguous index either way.
// ---------------------------------------------------------------------------

constexpr int FK = 8;

template <int TM, int TN, typename ALoad, typename BLoad, typename Epi>
__global__ void __launch_bounds__(kThreads)
fgemm_kernel(int M, int Ncols, int K, int kchunk, ALoad aload, BLoad bload, Epi epi) {
  constexpr int TBMf = 16 * TM, TBNf = 16 * TN;
  // Rows padded by 4 floats: the k-major tile stores then hit distinct banks,
  // and the float4 reads stay 16-byte aligned.
  __shared__ __align__(16) float As[FK][TBMf + 4];
  __shared__ __align__(16) float Bs[FK][TBNf + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TBMf, n0 = blockIdx.y * TBNf, z = blockIdx.z;
  const int zb = kchunk ? 0 : z;
  const int kb = kchunk ? z * kchunk : 0;
  const int ke = kchunk ? min(K, kb + kchunk) : K;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += FK) {
    for (int v = tid; v < TBMf * FK / 4; v += kThreads) {
      float f[4];
      if (ALoad::kKContig) {
        const int m = v / (FK / 4), kk = (v % (FK / 4)) * 4;
        load_or_zero<4>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 4; ++u) As[kk + u][m] = f[u];
      } else {
        const int kk = v / (TBMf / 4), m = (v % (TBMf / 4)) * 4;
        load_or_zero<4>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
        *reinterpret_cast<float4*>(&As[kk][m]) = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    for (int v = tid; v < TBNf * FK / 4; v += kThreads) {
      float f[4];
      if (BLoad::kKContig) {
        const int n = v / (FK / 4), kk = (v % (FK / 4)) * 4;
        load_or_zero<4>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 4; ++u) Bs[kk + u][n] = f[u];
      } else {
        const int kk = v / (TBNf / 4), n = (v % (TBNf / 4)) * 4;
        load_or_zero<4>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
        *reinterpret_cast<float4*>(&Bs[kk][n]) = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        *reinterpret_cast<float4*>(&a[i]) = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
#pragma unroll
      for (int j = 0; j < TN; j += 4)  // columns j/4 * 64 + 4 tx: coalesced epilogue rows
        *reinterpret_cast<float4*>(&b[j]) =
            *reinterpret_cast<const float4*>(&Bs[kk][(j / 4) * 64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int m = m0 + ty * TM + i, n = n0 + (j / 4) * 64 + tx * 4;
      if (m < M && n < Ncols) epi.store4(z, m, n, acc[i][j], acc[i][j + 1], acc[i][j + 2],
                                         acc[i][j + 3]);
    }
}

// The same batched GEMM on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulate), for products whose two operands hold model-dtype (bf16)
// values: the loaders return floats that bf16 represents exactly, so the
// products are exact and only the f32 accumulation order differs from the
// FMA kernel. 128x128 block tiles, K in steps of 32, 8 warps of 64x32 (the
// forward's mma_gemm_kernel layout). The tile load maps threads along each
// operand's contiguous index and stores bf16 into (row, k) shared tiles.
template <typename ALoad, typename BLoad, typename Epi>
__global__ void __launch_bounds__(kThreads)
bmma_kernel(int M, int Ncols, int K, int kchunk, ALoad aload, BLoad bload, Epi epi) {
  __shared__ __align__(16) bf16 As[TBM][TLD];
  __shared__ __align__(16) bf16 Bs[TBN][TLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN, z = blockIdx.z;
  const int zb = kchunk ? 0 : z;
  const int kb = kchunk ? z * kchunk : 0;
  const int ke = kchunk ? min(K, kb + kchunk) : K;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += TBK) {
    for (int v = tid; v < TBM * TBK / 8; v += kThreads) {
      float f[8];
      if (ALoad::kKContig) {
        const int m = v / (TBK / 8), kk = (v % (TBK / 8)) * 8;
        load_or_zero<8>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
        *reinterpret_cast<uint4*>(&As[m][kk]) = pack8(f);
      } else {
        const int kk = v / (TBM / 8), m = (v % (TBM / 8)) * 8;
        load_or_zero<8>(aload, zb, m0 + m, k0 + kk, m0 + m < M && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 8; ++u) As[m + u][kk] = __float2bfloat16_rn(f[u]);
      }
    }
    for (int v = tid; v < TBN * TBK / 8; v += kThreads) {
      float f[8];
      if (BLoad::kKContig) {
        const int n = v / (TBK / 8), kk = (v % (TBK / 8)) * 8;
        load_or_zero<8>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
        *reinterpret_cast<uint4*>(&Bs[n][kk]) = pack8(f);
      } else {
        const int kk = v / (TBN / 8), n = (v % (TBN / 8)) * 8;
        load_or_zero<8>(bload, zb, k0 + kk, n0 + n, n0 + n < Ncols && k0 + kk < ke, f);
#pragma unroll
        for (int u = 0; u < 8; ++u) Bs[n + u][kk] = __float2bfloat16_rn(f[u]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = ld32(&As[r][kk + 2 * t]);
        a[i][1] = ld32(&As[r + 8][kk + 2 * t]);
        a[i][2] = ld32(&As[r][kk + 2 * t + 8]);
        a[i][3] = ld32(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = wn + j * 8 + g;
        const uint32_t b0 = ld32(&Bs[nn][kk + 2 * t]), b1 = ld32(&Bs[nn][kk + 2 * t + 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r >> 1) * 8, n = n0 + wn + j * 8 + 2 * t + (r & 1);
        if (m < M && n < Ncols) epi(z, m, n, acc[i][j][r]);
      }
}

// A strided operand: value(z, i, j) = round_R(src[(z / H) * zo + (z % H) * zi
// + i * si + j * sj]), (i, j) = (m, k) for A and (k, n) for B; one of si, sj
// is 1. z runs over (item, head) pairs; R = float leaves the value as it is.
template <typename S, typename R, bool KC>
struct Operand {
  static constexpr bool kKContig = KC;
  const S* p; int H; long long zo, zi, si, sj;
  template <int V>
  __device__ void vec(int z, int i, int j, float (&out)[V]) const {
    Vec<S, V>::load(p + (z / H) * zo + (z % H) * zi + i * si + j * sj, out);
#pragma unroll
    for (int u = 0; u < V; ++u) out[u] = rnd<R>(out[u]);
  }
};

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

// Epilogue: dst[(z / H) * zo + (z % H) * zi + m * sm + n] = D(acc * scale);
// store4 writes n..n+3 (the FMA GEMM's epilogue; D is float there).
template <typename D>
struct Store {
  D* p; int H; long long zo, zi, sm; float scale;
  __device__ void operator()(int z, int m, int n, float acc) const {
    p[(z / H) * zo + (z % H) * zi + m * sm + n] = from_f<D>(acc * scale);
  }
  __device__ void store4(int z, int m, int n, float a, float b, float c, float d) const {
    D* q = p + (z / H) * zo + (z % H) * zi + m * sm + n;
    if constexpr (sizeof(D) == 4) {
      *reinterpret_cast<float4*>(q) = make_float4(a * scale, b * scale, c * scale, d * scale);
    } else {
      q[0] = from_f<D>(a * scale), q[1] = from_f<D>(b * scale);
      q[2] = from_f<D>(c * scale), q[3] = from_f<D>(d * scale);
    }
  }
};

// The f32 FMA GEMM: 128 x 128 tiles, or 128 x 64 for a narrow product
// (N <= 64, the per-head D). gemm_lp<T> is for products of two model-dtype
// operands: tensor cores when T is bf16, FMA (true f32) when T is float.
template <typename A, typename B, typename E>
cudaError_t gemm(int M, int Ncols, int K, int Z, int kchunk, A a, B b, E e, cudaStream_t st) {
  if (Ncols <= 64)
    fgemm_kernel<8, 4><<<dim3((M + 127) / 128, (Ncols + 63) / 64, Z), kThreads, 0, st>>>(
        M, Ncols, K, kchunk, a, b, e);
  else
    fgemm_kernel<8, 8><<<dim3((M + 127) / 128, (Ncols + 127) / 128, Z), kThreads, 0, st>>>(
        M, Ncols, K, kchunk, a, b, e);
  return cudaGetLastError();
}

template <typename T, typename A, typename B, typename E>
cudaError_t gemm_lp(int M, int Ncols, int K, int Z, int kchunk, A a, B b, E e, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    bmma_kernel<<<dim3((M + TBM - 1) / TBM, (Ncols + TBN - 1) / TBN, Z), kThreads, 0, st>>>(
        M, Ncols, K, kchunk, a, b, e);
    return cudaGetLastError();
  } else {
    return gemm(M, Ncols, K, Z, kchunk, a, b, e, st);
  }
}

// ---------------------------------------------------------------------------
// Row and column passes.
// ---------------------------------------------------------------------------

// P (rows, S) of scaled logits -> wf = e / sum(e), e = exp(l - max), in place.
// One warp per row.
__global__ void __launch_bounds__(kThreads)
softmax_rows_kernel(float* __restrict__ P, long long rows, int S) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  float* p = P + row * S;
  float m = -INFINITY;
  for (int j = lane; j < S; j += 32) m = fmaxf(m, p[j]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sum = 0.f;
  for (int j = lane; j < S; j += 32) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  for (int j = lane; j < S; j += 32) p[j] = p[j] / sum;
}

// dP (rows, S) -> ds = (wf * (dp - sum_j dp_j * T(wf_j))) * scale, in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_rows_kernel(const float* __restrict__ P, float* __restrict__ dP, long long rows,
                        int S, float scale) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* w = P + row * S;
  float* d = dP + row * S;
  float s = 0.f;
  for (int j = lane; j < S; j += 32) s = fmaf(d[j], rnd<T>(w[j]), s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  for (int j = lane; j < S; j += 32) d[j] = __fmul_rn(__fmul_rn(w[j], d[j] - s), scale);
}

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
