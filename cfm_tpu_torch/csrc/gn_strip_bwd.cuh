// The GroupNorm backward over strips of whole groups kept on chip (sm_90a):
// kernel #9's body (groupnorm.cu gives it the SiLU's derivative), on the
// pieces of gn_strip.cuh that the forward #8 runs on.
//
// Per (item, group), with norm = (x - mean) * inv recomputed from the
// saved per-channel statistics and dy the gradient through the activation
// (Grad::row, for the 16 bytes of a row a thread holds), in f32:
//   the column sums over the item's pixels of dy (the item's dbias) and of
//   dy * norm (its dscale); the group means m1 = sum(scale * dy) / count
//   and m2 = sum(scale * dy * norm) / count, count = HW * cg;
//   dx = inv * (dy * scale - m1 - norm * m2), rounded once to T.
//
// A block takes ``items`` items and a strip of W channels, as the forward's
// blocks do. Its rows of x and of the output gradient g arrive once by TMA:
// two rank-3 maps over (N, HW, C), box b of both on mbarrier b. Both passes
// read the on-chip copies with 16-byte vectors (a thread's rows of a box
// after that box's barrier, so the row loop carries no wait); dx leaves in
// 16-byte stores. Where x and g together exceed a block's share (96 KB), a
// cluster of 2-8 blocks splits the strip's rows, and 16 (a non-portable
// cluster size) only where 8 blocks' shared memory cannot hold a strip of
// the narrowest width, so every shape the forward's plan takes has a
// backward plan. At small maps a block takes items until the grid is one
// wave: those calls are bound by a block's chain of barriers, not bytes.
// Each block sums its rows per channel (the row slots and lanes of
// lane_totals, first dy, then dy * norm, through one buffer), and the two
// sums cross the cluster in one exchange through distributed shared memory,
// added in rank order: every block of a cluster, and every rerun, gets the
// same m1 and m2. The SiLU's derivative is recomputed in the second pass:
// keeping dy in f32 beside x and g would double a bf16 share's bytes. Its
// sigmoid's IEEE division is groupnorm.cu's rcp_newton (the same bits
// without the division's branch an element, which had kept the compiler
// from interleaving a row's eight elements).
//
// dscale and dbias sum over all items. Rank 0 of each cluster writes its
// items' column sums once to a workspace (2, N, C); item_sum_kernel, a
// second launch, adds them over the items in a fixed order. It is a
// programmatic dependent launch: its blocks start as the strip kernel's
// finish and wait (griddepcontrol) for that grid to complete, which hides
// most of a launch at the small maps. No atomics anywhere: a rerun gives
// the same bits. The sum moved into the strip kernel (the last block of a
// strip, elected by a counter, adding its items) took longer at every
// path's sizes: one block then adds every item of its strip.
//
// What bounds it: bytes (x and g read once, dx written once). Per element,
// both passes recompute norm and the exact SiLU's derivative (expf and an
// IEEE division, as the plain version has them): about 40 f32 operations
// against 6 bytes in bf16.

#pragma once

#include "gn_strip.cuh"

namespace gnstrip {

constexpr int kMaxClusterBwd = 16;
constexpr int kSumLanes = 32;  // lanes of item_sum_kernel a column: a warp

// A tile rounded up to 128 bytes, so g's tile starts where TMA can write.
__host__ __device__ inline size_t round128(size_t b) { return (b + 127) & ~(size_t)127; }

// Shared memory of a backward block: the tiles of x and g, the row-slot
// partial sums (then the group means m1, m2), the block's per-channel sums
// of dy and dy * norm and the cluster's times scale, the barriers; plus 128
// bytes of alignment.
inline size_t smem_bytes_bwd(const Plan& p, int itemsize) {
  const size_t tile = round128((size_t)p.items * p.boxes * p.box_rows * p.width * itemsize);
  const size_t vec = (size_t)p.items * p.width * sizeof(float);
  return 128 + 2 * tile + (size_t)kThreads * (16 / itemsize) * sizeof(float) + 4 * vec +
         kMaxBoxes * sizeof(uint64_t);
}

template <typename T>
struct BwdArgs {
  const float* scale;  // (C,)
  const float* bias;   // (C,)
  const float* mean;   // (N, C), each channel its group's mean
  const float* inv;    // (N, C), each channel its group's 1 / std
  T* dx;               // (N, HW, C)
  float* ws;           // (2, N, C): each item's column sums of dy * norm, then of dy
};

template <typename T, typename Grad>
__global__ void __launch_bounds__(kThreads, 2)
strip_bwd_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                 const BwdArgs<T> a, int N, int HW, int C, int cg, const Plan p, int n_begin) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align128(smem_raw);
  const int W = p.width, rows_alloc = p.boxes * p.box_rows, IW = p.items * W;
  const size_t tile = round128((size_t)p.items * rows_alloc * W * sizeof(T));
  T* xs = reinterpret_cast<T*>(base);
  T* gs = reinterpret_cast<T*>(base + tile);
  float* part = reinterpret_cast<float*>(base + 2 * tile);  // [thread][V], one sum at a time
  float* col = part + kThreads * V;  // [sum][item][channel], read by the cluster
  float* tot = col + 2 * IW;         // the same summed over the cluster, times scale
  uint64_t* bar = reinterpret_cast<uint64_t*>(tot + 2 * IW);
  float* m1 = part;  // the group means, once the partial sums are read
  float* m2 = part + IW;

  const int tid = threadIdx.x;
  const int cs = p.cluster, strip = blockIdx.x / cs;
  const uint32_t rank = sm90::cluster_rank();
  const int c0 = strip * W, n0 = n_begin + blockIdx.y * p.items;
  const int r_begin = (int)rank * p.rows, nrows = min(p.rows, HW - r_begin);
  {
    const CUtensorMap* const maps[2] = {&xmap, &gmap};
    T* const tiles[2] = {xs, gs};
    load_share<T, 2>(maps, tiles, bar, p, c0, r_begin, n0);
  }

  const Lanes s(p, V);
  const int it = s.it, R = s.R, j = s.j, r0 = s.r0;
  const int n = n0 + it, Ws = min(W, C - c0);
  const bool active = r0 < R && n < N && j * V < Ws;
  const size_t off = (size_t)it * rows_alloc * W + j * V;
  const T* xi = xs + off;
  const T* gi = gs + off;
  float* mine = part + tid * V;

  // The scale of the channels this thread combines below (sums i = tid,
  // tid + kThreads of channels i % IW), read while the boxes land.
  float comb_sc[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int w = (tid + h * kThreads) % IW % W;
    if (tid + h * kThreads < 2 * IW && w < Ws) comb_sc[h] = a.scale[c0 + w];
  }

  float mu[V], iv[V], sc[V], bi[V], s1[V], s2[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    mu[u] = iv[u] = sc[u] = bi[u] = s1[u] = s2[u] = 0.f;
    if (active) {
      const int c = c0 + j * V + u;
      mu[u] = a.mean[(size_t)n * C + c];
      iv[u] = a.inv[(size_t)n * C + c];
      sc[u] = a.scale[c];
      bi[u] = a.bias[c];
    }
  }

  // Pass 1: each thread's rows in order, sum(dy) and sum(dy * norm), one
  // box's rows after its barrier (no wait inside the row loop, so its
  // shared-memory loads can run ahead).
  for (int b = 0, r = r0; b < p.boxes; ++b) {
    sm90::mbar_wait(&bar[b], 0);
    const int end = active ? min(nrows, (b + 1) * p.box_rows) : 0;
    for (; r < end; r += R) {
      float xv[V], gv[V], norm[V], d[V];
      load16<T>(xi + (size_t)r * W, xv);
      load16<T>(gi + (size_t)r * W, gv);
#pragma unroll
      for (int u = 0; u < V; ++u) norm[u] = (xv[u] - mu[u]) * iv[u];
      Grad::row(gv, norm, sc, bi, d);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        s1[u] += d[u];
        s2[u] = fmaf(d[u], norm[u], s2[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < V; ++u) mine[u] = s1[u];
  __syncthreads();
  lane_totals(part, col, s, V);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < V; ++u) mine[u] = s2[u];
  __syncthreads();
  lane_totals(part, col + IW, s, V);
  strip_sync(cs);
  // Sum i of channel k = i % IW over the cluster: rank 0 writes it out (the
  // item's dbias, then dscale, part), and tot keeps it times scale.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * kThreads;
    if (i >= 2 * IW) break;
    const float t = rank_sum<kMaxClusterBwd>(&col[i], cs);
    const int k = i % IW, w = k % W, nc = n0 + k / W;
    if (w < Ws && nc < N) {
      if (rank == 0) a.ws[((size_t)(i < IW ? N : 0) + nc) * C + c0 + w] = t;
      tot[i] = t * comb_sc[h];
    }
  }
  strip_arrive(cs);  // done reading the other blocks' sums
  __syncthreads();

  // Channel tid's group means, its group's channels in order.
  if (tid < IW && tid % W < Ws && n0 + tid / W < N) {
    const int g0 = group_start(tid, W, cg);
    float e1 = 0.f, e2 = 0.f;
    for (int k = g0; k < g0 + cg; ++k) {
      e1 += tot[k];
      e2 += tot[IW + k];
    }
    const float cnt = (float)HW * (float)cg;
    m1[tid] = e1 / cnt;
    m2[tid] = e2 / cnt;
  }
  __syncthreads();

  // Pass 2: dx = inv * (dy * scale - m1 - norm * m2).
  if (active) {
    float e1[V], e2[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      e1[u] = m1[it * W + j * V + u];
      e2[u] = m2[it * W + j * V + u];
    }
    T* out = a.dx + ((size_t)n * HW + r_begin) * C + c0 + j * V;
    for (int r = r0; r < nrows; r += R) {
      float xv[V], gv[V], norm[V], d[V];
      load16<T>(xi + (size_t)r * W, xv);
      load16<T>(gi + (size_t)r * W, gv);
#pragma unroll
      for (int u = 0; u < V; ++u) norm[u] = (xv[u] - mu[u]) * iv[u];
      Grad::row(gv, norm, sc, bi, d);
#pragma unroll
      for (int u = 0; u < V; ++u) xv[u] = iv[u] * (d[u] * sc[u] - e1[u] - norm[u] * e2[u]);
      store16<T>(out + (size_t)r * C, xv);
    }
  }
  asm volatile("griddepcontrol.launch_dependents;");  // the item sum may start
  strip_wait(cs);  // no block leaves while another may still read its sums
}

// dscale[c] (k = c) and dbias[c] (k = C + c): the items' column sums in ws
// added in a fixed order. kSumLanes lanes take a column, lane l the items
// l, l + kSumLanes, ... in order; then the lanes pairwise (xor 16, ..., 1).
__global__ void __launch_bounds__(kThreads)
item_sum_kernel(const float* __restrict__ ws, float* __restrict__ dscale,
                float* __restrict__ dbias, int N, int C) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the strip kernel done, its sums seen
  const int t = blockIdx.x * kThreads + threadIdx.x, k = t / kSumLanes, lane = t % kSumLanes;
  float acc = 0.f;
  if (k < 2 * C) {
    const float* src = ws + (size_t)(k / C) * N * C + k % C;
    for (int n = lane; n < N; n += kSumLanes) acc += src[(size_t)n * C];
  }
  for (int o = kSumLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0 && k < 2 * C) {
    if (k < C) dscale[k] = acc;
    else dbias[k - C] = acc;
  }
}

// Checks the plan against the shape, launches the strip kernel with its
// cluster, then the item sum as its programmatic dependent. Returns 0 or a
// CUDA error code.
template <typename T, typename Grad>
int launch_bwd(const T* x, const T* g, const BwdArgs<T>& a, float* dscale, float* dbias, int N,
               int HW, int C, int G, const Plan& p, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int cg = G > 0 && C % G == 0 ? C / G : 0;
  const auto misaligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 != 0; };
  if (!plan_ok(N, HW, C, cg, V, p, kMaxClusterBwd) || misaligned(x) || misaligned(g) ||
      misaligned(a.dx))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  if (int err = encode_strip_map<T>(&xmap, x, N, HW, C, p)) return err;
  if (int err = encode_strip_map<T>(&gmap, g, N, HW, C, p)) return err;
  const unsigned columns = (unsigned)((C + p.width - 1) / p.width * p.cluster);
  if (int err = for_item_rows(N, p, columns, [&](dim3 grid, int n_begin) {
        return launch_clusters(strip_bwd_kernel<T, Grad>, grid, p.cluster,
                               smem_bytes_bwd(p, sizeof(T)), st, xmap, gmap, a, N, HW, C, cg, p,
                               n_begin);
      }))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * C * kSumLanes + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, item_sum_kernel, (const float*)a.ws, dscale, dbias,
                                         N, C))
    return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace gnstrip
