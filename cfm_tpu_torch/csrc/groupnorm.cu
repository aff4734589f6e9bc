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
// Forward (#8, redesigned): gn_strip.cuh. A block holds a
// strip of whole groups, a multiple of 16 bytes wide, on chip: its rows
// arrive once by TMA, both statistics passes and the output pass read shared
// memory, and a thread-block cluster splits the rows of a strip too large
// for one block, combining per-channel sums through distributed shared
// memory in a fixed order. The plan comes from ops/groupnorm.py:strip_plan.
//
// Backward (#9): gn_strip_bwd.cuh, on the same pieces. x's and g's rows of a
// strip arrive once by TMA (two maps, one mbarrier a box) and both passes
// read them from shared memory with 16-byte vectors; a cluster of up to 8
// blocks (16 where 8 cannot hold the narrowest strip) splits a large
// strip's rows, the column sums of dy and dy * norm crossing it in one
// rank-order exchange; small maps take several items a block. Each item's
// column sums go to a workspace once and a second launch adds them over the
// items in a fixed order, so a rerun gives the same bits (no atomics). The
// plan is strip_plan(..., backward=True). It replaces the first design's
// backward (one item and a strip about 32 channels wide a block, one
// element a thread, x and g read twice from device memory, no split of the
// rows).
//
// The split route (gn_split.cuh): shapes a strip on chip cannot take (a
// strip too large for a cluster's shared memory, channels that are not
// whole 16-byte rows, groups wider than 256 channels) go through row chunks
// whose statistics are combined through device memory, in a fixed order,
// and an element-wise pass; the plan comes from ops/groupnorm.py:split_plan.
// The strip kernels take items beyond a grid's 65535 rows by launching once
// for each 65535 rows of item groups.
//
// What bounds them: bytes. A few dozen flops per element against reading x
// (and g) once and writing the output once. chip_smoke.py reports the bound
// (bytes at 3.35 TB/s) beside the kernels' times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "gn_split.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + expf(-y)); }

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

// 1 / b for 1 <= b < 2^120: rcp.approx and one Newton step, the same bits
// as the IEEE division 1.f / b at every f32 b of that range (probes/gn_bwd.py
// checks all 120 x 2^23 on the card), without the division's branch to its
// slow path, which kept the compiler from interleaving a row's elements.
__device__ __forceinline__ float rcp_newton(float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return fmaf(r, fmaf(-b, r, 1.f), r);
}

// #9's gradient through the activation, for a thread's V elements of a row:
// dy = g * s * (1 + y * (1 - s)) with SiLU (s = sigmoid(y) = 1 / (1 + expf(-y))
// with the IEEE division, y = norm * scale + bias), else g. One branch a
// row: rcp_newton where every 1 + expf(-y) is below 2^120 (y > -83), else
// the division.
template <bool kSilu>
struct SiluGrad {
  template <int V>
  __device__ static void row(const float (&g)[V], const float (&norm)[V], const float (&sc)[V],
                             const float (&bi)[V], float (&dy)[V]) {
    if (!kSilu) {
#pragma unroll
      for (int u = 0; u < V; ++u) dy[u] = g[u];
      return;
    }
    float y[V], b[V], s[V];
    bool newton = true;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      y[u] = norm[u] * sc[u] + bi[u];
      b[u] = 1.f + expf(-y[u]);
      newton = newton && b[u] < 0x1p120f;
    }
    if (newton) {
#pragma unroll
      for (int u = 0; u < V; ++u) s[u] = rcp_newton(b[u]);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) s[u] = 1.f / b[u];
    }
#pragma unroll
    for (int u = 0; u < V; ++u) dy[u] = g[u] * s[u] * (1.f + y[u] * (1.f - s[u]));
  }
};

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

// x, g, dx: (N, HW, C) of dtype, 16-byte aligned; scale, bias: (C,) f32;
// mean, inv: (N, C) f32 from gn_silu_fwd; dscale, dbias: (C,) f32 out; ws:
// 2 * N * C f32 scratch. (width, ..., boxes): the plan of strip_plan(...,
// backward=True). Returns 0 or the CUDA error code.
int gn_silu_bwd(const void* x, const void* g, const float* scale, const float* bias,
                const float* mean, const float* inv, void* dx, float* dscale, float* dbias,
                float* ws, int N, int HW, int C, int G, int silu, int dtype, int width,
                int cluster, int items, int rows, int box_rows, int boxes, void* stream) {
  const gnstrip::Plan plan{width, cluster, items, rows, box_rows, boxes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_BWD(T, S)                                                                          \
  return gnstrip::launch_bwd<T, SiluGrad<S>>(                                                 \
      static_cast<const T*>(x), static_cast<const T*>(g),                                     \
      gnstrip::BwdArgs<T>{scale, bias, mean, inv, static_cast<T*>(dx), ws}, dscale, dbias, N, \
      HW, C, G, plan, st)
  if (dtype == 0) {
    if (silu) GN_BWD(float, true); else GN_BWD(float, false);
  }
  if (dtype == 1) {
    if (silu) GN_BWD(bf16, true); else GN_BWD(bf16, false);
  }
#undef GN_BWD
  return (int)cudaErrorInvalidValue;
}

// The split route. ws: N * chunks * C f32 scratch; (tile, lanes, chunks,
// rows): the plan of split_plan. Otherwise as gn_silu_fwd.
int gn_silu_fwd_split(const void* x, const float* scale, const float* bias, void* out, float* mean,
                      float* inv, float* ws, int N, int HW, int C, int G, float eps, int silu,
                      int dtype, int tile, int lanes, int chunks, int rows, void* stream) {
  const gnsplit::Plan plan{tile, lanes, chunks, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_FWD(T, S)                                                                        \
  return gnsplit::launch<T>(static_cast<const T*>(x),                                       \
                            SiluOut<T, S>{static_cast<T*>(out), scale, bias, mean, inv}, ws, \
                            N, HW, C, G, plan, eps, st)
  if (dtype == 0) {
    if (silu) GN_FWD(float, true); else GN_FWD(float, false);
  }
  if (dtype == 1) {
    if (silu) GN_FWD(bf16, true); else GN_FWD(bf16, false);
  }
#undef GN_FWD
  return (int)cudaErrorInvalidValue;
}

// The split route's backward. split_ws: 2 * N * chunks * C + 2 * N * C f32
// scratch; otherwise as gn_silu_bwd, with the split plan.
int gn_silu_bwd_split(const void* x, const void* g, const float* scale, const float* bias,
                      const float* mean, const float* inv, void* dx, float* dscale, float* dbias,
                      float* ws, float* split_ws, int N, int HW, int C, int G, int silu,
                      int dtype, int tile, int lanes, int chunks, int rows, void* stream) {
  const gnsplit::Plan plan{tile, lanes, chunks, rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GN_BWD(T, S)                                                                          \
  return gnsplit::launch_bwd<T, SiluGrad<S>>(                                                 \
      static_cast<const T*>(x), static_cast<const T*>(g),                                     \
      gnstrip::BwdArgs<T>{scale, bias, mean, inv, static_cast<T*>(dx), ws}, split_ws, dscale, \
      dbias, N, HW, C, G, plan, st)
  if (dtype == 0) {
    if (silu) GN_BWD(float, true); else GN_BWD(float, false);
  }
  if (dtype == 1) {
    if (silu) GN_BWD(bf16, true); else GN_BWD(bf16, false);
  }
#undef GN_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
