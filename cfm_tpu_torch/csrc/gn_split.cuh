// GroupNorm (+ SiLU) forward and backward over row chunks, the statistics
// combined through device memory (sm_90a): the route of kernels #8 and #9
// (groupnorm.cu) for the shapes a strip on chip cannot take.
//
//   - maps whose strip of the narrowest width exceeds what a cluster's
//     shared memory holds (float32 256x256 at 256 channels: 2 MB a strip);
//   - channel counts that are not whole 16-byte rows (float32 C = 6, bf16
//     C = 12), which TMA boxes and 16-byte vectors cannot take;
//   - groups wider than a strip's 256 channels (ResNetDiffEq at width 8192
//     in 16 groups).
//
// The arithmetic is the strip kernels' and the plain versions': two-pass
// recentred f32 statistics (the mean of (x - mean)^2, never E[x^2] -
// E[x]^2), one rounding of the output to T. The forward is five launches:
//   1. stats_partial<0>: block (tile, chunk) of item n sums each channel of
//      its tile over the chunk's rows into part[n][chunk][c];
//   2. stats_combine<0>: per (item, group), the chunks of each channel, then
//      the group's channels, over HW * cg: the mean, written per channel;
//   3. stats_partial<1>: the same for (x - mean)^2 (fmaf);
//   4. stats_combine<1>: inv = 1 / sqrt(var + eps), written per channel;
//   5. apply: every element through the epilogue (groupnorm.cu's SiluOut).
// The backward is four: bwd_partial (the column sums of dy and dy * norm a
// chunk), bwd_combine (each item's sums into ws, which per_item returns,
// and the group means m1, m2 of scale times them), bwd_apply (dx), and
// gnstrip::item_sum_kernel (dscale, dbias over the items).
//
// A block's threads: a tile of channels (C, or 256 of a wider C, looping
// over the tiles of a wide group) times lanes = 256 / tile row lanes, so a
// block reads whole rows (C <= 256) or 256 neighbouring channels of a row,
// each channel in its own thread: no channel count needs a whole 16-byte
// vector, and the masked tail is the channel test. Rows of a chunk go to
// lane l as l, l + lanes, ... in order; the lanes add in lane order. The
// combine adds a channel's chunks on a warp's 32 lanes (lane l the chunks
// l, l + 32, ... in order, then the lanes pairwise, xor 16, ..., 1), the
// eight warps the group's channels w, w + 8, ... in order, then the warps
// in order. Every order is fixed: a rerun gives the same bits. Items beyond
// the grid's 65535 rows are taken by a grid loop.
//
// What bounds it: bytes. x is read three times (two statistics passes and
// the output; x and g twice in the backward) where the strip reads it once;
// the partial sums are HW / rows of a chunk times smaller than x.

#pragma once

#include "gn_strip_bwd.cuh"

namespace gnsplit {

using gnstrip::from_f;
using gnstrip::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;

// The route's blocks (split_plan in cfm_tpu_torch/ops/groupnorm.py).
struct Plan {
  int tile;    // channels of a block: C, or 256 of a wider C
  int lanes;   // row lanes of a block, kThreads / tile
  int chunks;  // row chunks of an item
  int rows;    // rows of a chunk
};

inline bool plan_ok(int N, int HW, int C, int cg, const Plan& p) {
  return N > 0 && HW > 0 && cg > 0 && C % cg == 0 && p.tile == (C < kThreads ? C : kThreads) &&
         p.lanes == kThreads / p.tile && p.chunks >= 1 && p.rows >= 1 &&
         (long long)p.chunks * p.rows >= HW && (long long)(p.chunks - 1) * p.rows < HW;
}

// The block's tile, chunk and channel, its lane and its rows.
struct Slot {
  int k, lane, c, r_begin, r_end;
  bool active;
  __device__ Slot(const Plan& p, int HW, int C) {
    const int tiles = (C + p.tile - 1) / p.tile, t = threadIdx.x;
    k = blockIdx.x / tiles;
    lane = t / p.tile;
    c = (blockIdx.x % tiles) * p.tile + t % p.tile;
    r_begin = k * p.rows;
    r_end = min(HW, r_begin + p.rows);
    active = lane < p.lanes && c < C;
  }
};

// The lanes' sums of channel column t (t < tile), added in lane order.
__device__ __forceinline__ float lane_order_sum(const float* sums, const Plan& p) {
  float a = 0.f;
  for (int l = 0; l < p.lanes; ++l) a += sums[l * p.tile + threadIdx.x];
  return a;
}

// Pass 0: part[n][k][c] = the sum of x over chunk k's rows; pass 1: of
// (x - mean)^2, mean the channel's group mean from pass 0.
template <typename T, int kPass>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ x, const float* __restrict__ mean_c, float* __restrict__ part,
              int N, int HW, int C, const Plan p) {
  __shared__ float sums[kThreads];
  const Slot s(p, HW, C);
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    float a = 0.f;
    if (s.active) {
      const float mu = kPass ? mean_c[(size_t)n * C + s.c] : 0.f;
      const T* xp = x + (size_t)n * HW * C + s.c;
#pragma unroll 4
      for (int r = s.r_begin + s.lane; r < s.r_end; r += p.lanes) {
        const float v = to_f<T>(xp[(size_t)r * C]);
        if (kPass == 0) {
          a += v;
        } else {
          const float d = v - mu;
          a = fmaf(d, d, a);
        }
      }
    }
    sums[threadIdx.x] = a;
    __syncthreads();
    if ((int)threadIdx.x < p.tile && s.c < C)
      part[((size_t)n * p.chunks + s.k) * C + s.c] = lane_order_sum(sums, p);
    __syncthreads();
  }
}

// The sum of channel c's chunks in part (n's rows), on a warp: lane l the
// chunks l, l + 32, ... in order, then the lanes pairwise. Every lane gets
// the total.
__device__ __forceinline__ float chunk_sum(const float* part, size_t n, int c, int C, int chunks) {
  float a = 0.f;
  for (int k = threadIdx.x & 31; k < chunks; k += 32) a += part[(n * chunks + k) * C + c];
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

// The warps' sums added in warp order, the total to every thread.
__device__ __forceinline__ float warp_order_sum(float* scratch, float v) {
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  __syncthreads();
  return t;
}

// Per (item, group): pass 0 writes the group's mean to mean_c, pass 1 its
// 1 / sqrt(var + eps) to inv_c, for each of its channels.
template <int kPass>
__global__ void __launch_bounds__(kThreads)
stats_combine(const float* __restrict__ part, float* __restrict__ mean_c,
              float* __restrict__ inv_c, int N, int HW, int C, int cg, int chunks, float eps) {
  __shared__ float scratch[kWarps];
  const int G = C / cg, warp = threadIdx.x >> 5;
  const float cnt = (float)HW * (float)cg;
  for (size_t pair = blockIdx.x; pair < (size_t)N * G; pair += gridDim.x) {
    const size_t n = pair / G;
    const int c0 = (int)(pair % G) * cg;
    float a = 0.f;
    for (int j = warp; j < cg; j += kWarps) a += chunk_sum(part, n, c0 + j, C, chunks);
    const float tot = warp_order_sum(scratch, a);
    const float v = kPass == 0 ? tot / cnt : 1.f / sqrtf(tot / cnt + eps);
    float* dst = (kPass == 0 ? mean_c : inv_c) + n * C + c0;
    for (int j = threadIdx.x; j < cg; j += kThreads) dst[j] = v;
  }
}

// out = the epilogue of every element, item n on grid row blockIdx.y (a grid
// loop beyond it). The channel of a thread's element advances by the grid's
// stride modulo C, so no element needs a division.
template <typename T, typename Epi>
__global__ void __launch_bounds__(kThreads)
apply(const T* __restrict__ x, const Epi epi, int N, int HW, int C) {
  const size_t per_item = (size_t)HW * C, stride = (size_t)gridDim.x * kThreads;
  const int dc = (int)(stride % C);
  const size_t e0 = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const T* xi = x + (size_t)n * per_item;
    T* oi = epi.out + (size_t)n * per_item;
    const float* mu = epi.mean_c + (size_t)n * C;
    const float* iv = epi.inv_c + (size_t)n * C;
    int c = (int)(e0 % C);
    for (size_t e = e0; e < per_item; e += stride) {
      oi[e] = from_f<T>(Epi::apply(to_f<T>(xi[e]), mu[c], iv[c], epi.scale[c], epi.bias[c]));
      c += dc;
      if (c >= C) c -= C;
    }
  }
}

// The backward's arguments beyond the strip route's BwdArgs.
struct SplitBwd {
  float* part;  // (2, N, chunks, C): each chunk's column sums of dy, then of dy * norm
  float* m;     // (2, N, C): each channel's group means m1, then m2
};

// dy of one element (Grad: groupnorm.cu's SiluGrad) and its norm.
template <typename Grad>
__device__ __forceinline__ void grad_of(float xv, float gv, float mu, float iv, float sc, float bi,
                                        float& norm, float& dy) {
  float g1[1] = {gv}, n1[1] = {(xv - mu) * iv}, s1[1] = {sc}, b1[1] = {bi}, d1[1];
  Grad::row(g1, n1, s1, b1, d1);
  norm = n1[0];
  dy = d1[0];
}

template <typename T, typename Grad>
__global__ void __launch_bounds__(kThreads)
bwd_partial(const T* __restrict__ x, const T* __restrict__ g, const gnstrip::BwdArgs<T> a,
            const SplitBwd w, int N, int HW, int C, const Plan p) {
  __shared__ float sums[2][kThreads];
  const Slot s(p, HW, C);
  const size_t half = (size_t)N * p.chunks * C;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    float s1 = 0.f, s2 = 0.f;
    if (s.active) {
      const size_t nc = (size_t)n * C + s.c;
      const float mu = a.mean[nc], iv = a.inv[nc], sc = a.scale[s.c], bi = a.bias[s.c];
      const T* xp = x + (size_t)n * HW * C + s.c;
      const T* gp = g + (size_t)n * HW * C + s.c;
#pragma unroll 4
      for (int r = s.r_begin + s.lane; r < s.r_end; r += p.lanes) {
        float norm, dy;
        grad_of<Grad>(to_f<T>(xp[(size_t)r * C]), to_f<T>(gp[(size_t)r * C]), mu, iv, sc, bi,
                      norm, dy);
        s1 += dy;
        s2 = fmaf(dy, norm, s2);
      }
    }
    sums[0][threadIdx.x] = s1;
    sums[1][threadIdx.x] = s2;
    __syncthreads();
    if ((int)threadIdx.x < p.tile && s.c < C) {
      const size_t at = ((size_t)n * p.chunks + s.k) * C + s.c;
      w.part[at] = lane_order_sum(sums[0], p);
      w.part[half + at] = lane_order_sum(sums[1], p);
    }
    __syncthreads();
  }
}

// Per (item, group): each channel's sums of dy (its item's dbias) and of
// dy * norm (dscale) over the chunks, written to the workspace (2, N, C)
// as the strip route writes them; m1 and m2, the group's channels' sums
// times scale over HW * cg, written per channel.
__global__ void __launch_bounds__(kThreads)
bwd_combine(const float* __restrict__ scale, const SplitBwd w, float* __restrict__ ws, int N,
            int HW, int C, int cg, int chunks) {
  __shared__ float scratch[kWarps];
  const int G = C / cg, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float cnt = (float)HW * (float)cg;
  const size_t half = (size_t)N * chunks * C, items = (size_t)N * C;
  for (size_t pair = blockIdx.x; pair < (size_t)N * G; pair += gridDim.x) {
    const size_t n = pair / G;
    const int c0 = (int)(pair % G) * cg;
    float e1 = 0.f, e2 = 0.f;
    for (int j = warp; j < cg; j += kWarps) {
      const int c = c0 + j;
      const float db = chunk_sum(w.part, n, c, C, chunks);
      const float ds = chunk_sum(w.part + half, n, c, C, chunks);
      if (lane == 0) {
        ws[n * C + c] = ds;
        ws[items + n * C + c] = db;
      }
      e1 += db * scale[c];
      e2 += ds * scale[c];
    }
    const float m1 = warp_order_sum(scratch, e1) / cnt;
    const float m2 = warp_order_sum(scratch, e2) / cnt;
    for (int j = threadIdx.x; j < cg; j += kThreads) {
      w.m[n * C + c0 + j] = m1;
      w.m[items + n * C + c0 + j] = m2;
    }
  }
}

// dx = inv * (dy * scale - m1 - norm * m2), rounded once to T.
template <typename T, typename Grad>
__global__ void __launch_bounds__(kThreads)
bwd_apply(const T* __restrict__ x, const T* __restrict__ g, const gnstrip::BwdArgs<T> a,
          const SplitBwd w, int N, int HW, int C) {
  const size_t per_item = (size_t)HW * C, stride = (size_t)gridDim.x * kThreads;
  const size_t items = (size_t)N * C;
  const int dc = (int)(stride % C);
  const size_t e0 = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    const size_t base = (size_t)n * per_item, nc = (size_t)n * C;
    int c = (int)(e0 % C);
    for (size_t e = e0; e < per_item; e += stride) {
      float norm, dy;
      const float iv = a.inv[nc + c], sc = a.scale[c];
      grad_of<Grad>(to_f<T>(x[base + e]), to_f<T>(g[base + e]), a.mean[nc + c], iv, sc,
                    a.bias[c], norm, dy);
      a.dx[base + e] = from_f<T>(iv * (dy * sc - w.m[nc + c] - norm * w.m[items + nc + c]));
      c += dc;
      if (c >= C) c -= C;
    }
  }
}

// Grid of the element-wise passes: enough blocks to cover an item's
// elements (at most 4096 a row, a grid loop beyond), one row an item.
inline dim3 apply_grid(int N, int HW, int C) {
  const size_t blocks = ((size_t)HW * C + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < 4096 ? blocks : 4096), (unsigned)(N < kMaxGridY ? N : kMaxGridY));
}

inline unsigned pair_grid(int N, int G) {
  const size_t pairs = (size_t)N * G;
  return (unsigned)(pairs < (1u << 20) ? pairs : (1u << 20));
}

// The forward's five launches. ws: N * chunks * C floats. Returns 0 or a
// CUDA error code.
template <typename T, typename Epi>
int launch(const T* x, const Epi& epi, float* ws, int N, int HW, int C, int G, const Plan& p,
           float eps, cudaStream_t st) {
  const int cg = G > 0 && C % G == 0 ? C / G : 0;
  if (!plan_ok(N, HW, C, cg, p)) return (int)cudaErrorInvalidValue;
  const dim3 partial((unsigned)((C + p.tile - 1) / p.tile * p.chunks),
                     (unsigned)(N < kMaxGridY ? N : kMaxGridY));
  stats_partial<T, 0><<<partial, kThreads, 0, st>>>(x, nullptr, ws, N, HW, C, p);
  stats_combine<0><<<pair_grid(N, G), kThreads, 0, st>>>(ws, epi.mean_c, epi.inv_c, N, HW, C, cg,
                                                         p.chunks, eps);
  stats_partial<T, 1><<<partial, kThreads, 0, st>>>(x, epi.mean_c, ws, N, HW, C, p);
  stats_combine<1><<<pair_grid(N, G), kThreads, 0, st>>>(ws, epi.mean_c, epi.inv_c, N, HW, C, cg,
                                                         p.chunks, eps);
  apply<T, Epi><<<apply_grid(N, HW, C), kThreads, 0, st>>>(x, epi, N, HW, C);
  return (int)cudaGetLastError();
}

// The backward's four launches. ws: (2, N, C) per-item sums, as the strip
// route's; split_ws: 2 * N * chunks * C + 2 * N * C floats. Returns 0 or a
// CUDA error code.
template <typename T, typename Grad>
int launch_bwd(const T* x, const T* g, const gnstrip::BwdArgs<T>& a, float* split_ws,
               float* dscale, float* dbias, int N, int HW, int C, int G, const Plan& p,
               cudaStream_t st) {
  const int cg = G > 0 && C % G == 0 ? C / G : 0;
  if (!plan_ok(N, HW, C, cg, p)) return (int)cudaErrorInvalidValue;
  const SplitBwd w{split_ws, split_ws + 2 * (size_t)N * p.chunks * C};
  const dim3 partial((unsigned)((C + p.tile - 1) / p.tile * p.chunks),
                     (unsigned)(N < kMaxGridY ? N : kMaxGridY));
  bwd_partial<T, Grad><<<partial, kThreads, 0, st>>>(x, g, a, w, N, HW, C, p);
  bwd_combine<<<pair_grid(N, G), kThreads, 0, st>>>(a.scale, w, a.ws, N, HW, C, cg, p.chunks);
  bwd_apply<T, Grad><<<apply_grid(N, HW, C), kThreads, 0, st>>>(x, g, a, w, N, HW, C);
  const unsigned sums = (unsigned)((2 * (size_t)C * gnstrip::kSumLanes + kThreads - 1) / kThreads);
  gnstrip::item_sum_kernel<<<sums, kThreads, 0, st>>>(a.ws, dscale, dbias, N, C);
  return (int)cudaGetLastError();
}

}  // namespace gnsplit
