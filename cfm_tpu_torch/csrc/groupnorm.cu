// GroupNorm (+ SiLU) forward and backward on Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernels cfm_tpu/ops/pallas_groupnorm.py:_gn_silu_fwd_kernel
// (launched by _gn_silu_fwd_pallas) and _gn_silu_bwd_kernel (launched by
// _gn_silu_bwd_pallas). The arithmetic is that of their plain PyTorch
// versions in cfm_tpu_torch/ops/groupnorm.py:
//   forward:  per (item n, group g), over HW x cg elements in f32, the mean,
//             then the variance as the mean of (x - mean)^2: two passes,
//             recentred, never E[x^2] - E[x]^2, which cancels in f32 when
//             |mean| >> std. inv = 1 / sqrt(var + eps);
//             y = (x - mean) * inv * scale + bias, then y * sigmoid(y) with
//             SiLU, rounded once to x's dtype. The per-channel mean and inv
//             (f32) are written for the backward, as the TPU kernel does.
//   backward: norm recomputed from x and the saved statistics;
//             dy = g * s * (1 + y * (1 - s)) with SiLU (s = sigmoid(y),
//             y = norm * scale + bias), else g; dnorm = dy * scale;
//             dx = inv * (dnorm - mean_g(dnorm) - norm * mean_g(dnorm * norm)),
//             rounded to x's dtype; dscale = sum of dy * norm and dbias = sum
//             of dy over items and pixels, in f32.
//
// Forward (#8, redesigned): gn_strip.cuh. A block holds a strip of whole
// groups, a multiple of 16 bytes wide, on chip: its rows arrive once by TMA,
// both statistics passes and the output pass read shared memory, and a
// thread-block cluster splits the rows of a strip too large for one block,
// combining per-channel sums through distributed shared memory in a fixed
// order. The plan comes from ops/groupnorm.py:strip_plan. Only the
// statistics' summation order changed from the first design (strips about
// 32 channels wide read three times from device memory, one element a
// thread); the affine, the SiLU and the rounding are as they were.
//
// Backward (#9), layout. x is (N, HW, C) with groups of cg = C / G
// contiguous channels. One block per (item, group) would read cg = 1-4
// channels (every MNIST shape) at a stride of C: 2 to 16 bytes of each
// 32-byte sector. Instead a block takes one item and a strip of whole groups
// about 32 channels wide, and its threads read the strip row by row,
// neighbouring threads on neighbouring channels: each warp's load is one
// contiguous run of a row (64 bytes in bf16, 128 in f32). Each thread keeps
// one column, sums it over its rows, and the block folds the column sums
// into group sums in shared memory, as the TPU kernel folds its (1, C)
// column sums with one-hot matmuls.
//
// Cross-item sums. dscale and dbias sum over all items. The TPU kernel
// carries them across its sequential grid; blocks here run in no order, so
// each block writes its item's column sums to a workspace and a second kernel
// adds the items in a fixed order: the result does not change from run to
// run (no atomics).
//
// What bounds them: bytes. A few dozen flops per element against reading x
// (and g) and writing the output. The forward reads x from device memory
// once; the backward reads its strip twice, the repeat mostly from the 50 MB
// L2. chip_smoke.py reports the bound (bytes at 3.35 TB/s) beside the
// kernels' times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "gn_strip.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kStrip = 32;  // target channels per block; also the most groups per block

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + expf(-y)); }

// The strip of block (blockIdx.x, item blockIdx.y): groups [g0, g0 + ng),
// channels [c0, c0 + W). Thread t < R * W owns column col = t % W and reads
// rows r0 = t / W, r0 + R, r0 + 2R, ...; the other threads only help reduce.
struct Strip {
  int ng, W, R, c0, col, r0;
  bool active;
  __device__ Strip(int G, int cg, int gpb) {
    const int g0 = blockIdx.x * gpb;
    ng = min(gpb, G - g0);
    W = ng * cg;
    R = kThreads / W;
    c0 = g0 * cg;
    col = threadIdx.x % W;
    r0 = threadIdx.x / W;
    active = r0 < R;
  }
};

template <bool kSilu>
__device__ __forceinline__ float dy_of(float g, float norm, float sc, float bi) {
  if (!kSilu) return g;
  const float y = norm * sc + bi, s = sigmoid(y);
  return g * s * (1.f + y * (1.f - s));
}

// #8's epilogue: y = (x - mean) * inv * scale + bias, then y * sigmoid(y)
// with SiLU, rounded once to T; the per-channel mean and inv are kept for
// the backward.
template <typename T, bool kSilu>
struct SiluOut {
  T* out;
  const float* scale;
  const float* bias;
  float* mean_c;
  float* inv_c;
  __device__ void stats(size_t i, float mu, float inv) const {
    mean_c[i] = mu;
    inv_c[i] = inv;
  }
  __device__ static float apply(float x, float mu, float inv, float sc, float bi) {
    float y = (x - mu) * inv * sc + bi;
    if (kSilu) y = y * sigmoid(y);
    return y;
  }
};

// dx for one item's strip; the item's column sums of dy and dy * norm go to
// ws_db and ws_ds (N, C) for gn_silu_wgrad_kernel.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
gn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ mean_c, const float* __restrict__ inv_c,
                   T* __restrict__ dx, float* __restrict__ ws_ds, float* __restrict__ ws_db,
                   int HW, int C, int G, int cg, int gpb) {
  __shared__ float pa[kThreads], pb[kThreads], ca[kThreads], cb[kThreads];
  __shared__ float s1[kStrip], s2[kStrip];
  const Strip s(G, cg, gpb);
  const int n = blockIdx.y, c = s.c0 + s.col, k = s.col / cg;
  const size_t base = (size_t)n * HW * C + c;
  const float cnt = (float)HW * (float)cg;
  const float mu = mean_c[(size_t)n * C + c], inv = inv_c[(size_t)n * C + c];
  const float sc = scale[c], bi = bias[c];

  float sdy = 0.f, sdyn = 0.f;
  if (s.active)
    for (int r = s.r0; r < HW; r += s.R) {
      const size_t i = base + (size_t)r * C;
      const float norm = (to_f<T>(x[i]) - mu) * inv;
      const float d = dy_of<kSilu>(to_f<T>(gy[i]), norm, sc, bi);
      sdy += d;
      sdyn = fmaf(d, norm, sdyn);
    }
  pa[threadIdx.x] = sdy;
  pb[threadIdx.x] = sdyn;
  __syncthreads();
  if (threadIdx.x < s.W) {  // this column's totals over the item's pixels
    float a = 0.f, b = 0.f;
    for (int rr = 0; rr < s.R; ++rr) {
      a += pa[rr * s.W + threadIdx.x];
      b += pb[rr * s.W + threadIdx.x];
    }
    ws_db[(size_t)n * C + c] = a;
    ws_ds[(size_t)n * C + c] = b;
    ca[threadIdx.x] = a * sc;  // the column sums of dnorm and dnorm * norm
    cb[threadIdx.x] = b * sc;
  }
  __syncthreads();
  if (threadIdx.x < s.ng) {
    float a = 0.f, b = 0.f;
    for (int j = threadIdx.x * cg; j < (threadIdx.x + 1) * cg; ++j) {
      a += ca[j];
      b += cb[j];
    }
    s1[threadIdx.x] = a / cnt;
    s2[threadIdx.x] = b / cnt;
  }
  __syncthreads();
  if (!s.active) return;
  const float m1 = s1[k], m2 = s2[k];
  for (int r = s.r0; r < HW; r += s.R) {
    const size_t i = base + (size_t)r * C;
    const float norm = (to_f<T>(x[i]) - mu) * inv;
    const float dnorm = dy_of<kSilu>(to_f<T>(gy[i]), norm, sc, bi) * sc;
    dx[i] = from_f<T>(inv * (dnorm - m1 - norm * m2));
  }
}

// dscale[c] and dbias[c]: the items' column sums added in item order.
__global__ void gn_silu_wgrad_kernel(const float* __restrict__ ws_ds,
                                     const float* __restrict__ ws_db, float* __restrict__ dscale,
                                     float* __restrict__ dbias, int N, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int n = 0; n < N; ++n) {
    a += ws_ds[(size_t)n * C + c];
    b += ws_db[(size_t)n * C + c];
  }
  dscale[c] = a;
  dbias[c] = b;
}

// Groups per block: whole groups up to about kStrip channels.
int groups_per_block(int cg) { return cg >= kStrip ? 1 : kStrip / cg; }

bool bad_shape(int N, int HW, int C, int G) {
  return N <= 0 || N > 65535 || HW <= 0 || G <= 0 || C % G || C / G > kThreads;
}

}  // namespace

extern "C" {

// x, out: (N, HW, C) float32 (dtype 0) or bfloat16 (dtype 1), x 16-byte
// aligned; scale, bias: (C,) f32; mean, inv: (N, C) f32 out. (width,
// cluster, items, rows, box_rows, boxes): the plan of strip_plan. Returns 0
// or the CUDA error code.
int gn_silu_fwd(const void* x, const float* scale, const float* bias, void* out, float* mean,
                float* inv, int N, int HW, int C, int G, float eps, int silu, int dtype, int width,
                int cluster, int items, int rows, int box_rows, int boxes, void* stream) {
  const gnstrip::Plan plan{width, cluster, items, rows, box_rows, boxes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_FWD(T, S)                                                                        \
  return gnstrip::launch<T>(static_cast<const T*>(x),                                       \
                            SiluOut<T, S>{static_cast<T*>(out), scale, bias, mean, inv}, N, \
                            HW, C, G, plan, eps, st)
  if (dtype == 0) {
    if (silu) GN_FWD(float, true); else GN_FWD(float, false);
  }
  if (dtype == 1) {
    if (silu) GN_FWD(bf16, true); else GN_FWD(bf16, false);
  }
#undef GN_FWD
  return (int)cudaErrorInvalidValue;
}

// x, g, dx: (N, HW, C) of dtype; scale, bias: (C,) f32; mean, inv: (N, C) f32
// from gn_silu_fwd; dscale, dbias: (C,) f32 out; ws: 2 * N * C f32 scratch.
int gn_silu_bwd(const void* x, const void* g, const float* scale, const float* bias,
                const float* mean, const float* inv, void* dx, float* dscale, float* dbias,
                float* ws, int N, int HW, int C, int G, int silu, int dtype, void* stream) {
  if (bad_shape(N, HW, C, G)) return (int)cudaErrorInvalidValue;
  const int cg = C / G, gpb = groups_per_block(cg);
  const dim3 grid((G + gpb - 1) / gpb, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws_ds = ws;
  float* ws_db = ws + (size_t)N * C;
#define GN_BWD(T, S)                                                                          \
  gn_silu_bwd_kernel<T, S><<<grid, kThreads, 0, st>>>(                                        \
      static_cast<const T*>(x), static_cast<const T*>(g), scale, bias, mean, inv,             \
      static_cast<T*>(dx), ws_ds, ws_db, HW, C, G, cg, gpb)
  if (dtype == 0) {
    if (silu) GN_BWD(float, true); else GN_BWD(float, false);
  } else {
    if (silu) GN_BWD(bf16, true); else GN_BWD(bf16, false);
  }
#undef GN_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_silu_wgrad_kernel<<<(C + 255) / 256, 256, 0, st>>>(ws_ds, ws_db, dscale, dbias, N, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
