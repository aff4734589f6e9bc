// GroupNorm over strips of whole groups kept on chip (sm_90a), shared by the
// GroupNorm + SiLU forward #8 (groupnorm.cu) and the GroupNorm stages of the
// attention-block forward #1 and backward #2 (attn_block_fwd.cu,
// attn_block_bwd.cu), which differ only in the per-element epilogue. The
// backward #9 (gn_strip_bwd.cuh) runs on the same pieces: the box loads
// (load_share), the row-slot and lane sums (Lanes, lane_totals),
// the rank-order cluster combine (rank_sum, strip_sync), the plan check and the
// clustered launch (plan_ok, launch_clusters).
//
// x is (N, HW, C) with groups of cg = C / G contiguous channels. A block
// takes ``items`` items and a strip of W channels: whole groups, W a
// multiple of 16 bytes (8 bf16 or 4 f32 channels), so every thread moves 16
// bytes a load. The strip's rows arrive once from device memory by TMA (a
// rank-3 map over (N, HW, C), boxes of at most 256 rows, one mbarrier a box)
// and stay in shared memory: both statistics passes and the output pass read
// the on-chip copy (where a share takes several boxes, each holds a multiple
// of 8 rows, so each starts on a 128-byte boundary). Where one block's share
// would be too large (a 32-channel strip at 64x64 is 256 KB in bf16), a
// thread-block cluster of 2-8 blocks splits the strip's rows; each block
// sums its rows per channel, and the blocks read each other's per-channel
// sums through distributed shared memory, always in rank order, so every
// block and every rerun gets the same bits. At small HW a block takes
// several items so the grid still fills the card. The plan (W, cluster,
// items, rows) comes from strip_plan in cfm_tpu_torch/ops/groupnorm.py.
// A block takes one share: a persistent block taking item groups in turn,
// the next one's share arriving while the current one is computed on, ran
// slower on an H100 (fewer blocks in flight, each turn's two cluster
// exchanges in series).
//
// Arithmetic, per (item, group), in f32: the mean, then the mean of
// (x - mean)^2 (two passes, recentred, never E[x^2] - E[x]^2), then
// inv = 1 / sqrt(var + eps). Summation order: each thread adds its rows of
// a channel in row order (rows r0, r0 + R, ...); L lanes of a warp add a
// channel's R row slots (L the least power of two with 4 L >= R, at most
// 32), lane l the slots l, l + L, ... in order, then the L lanes pairwise
// (a butterfly: xor L / 2, ..., 1); the cluster's blocks are added in rank
// order, then the group's channels in channel order, and the total is
// divided by HW * cg.
//
// What bounds it: bytes. x is read from device memory once and the output
// written once (16-byte stores); the statistics cost a few shared-memory
// reads and block and cluster barriers. The exact SiLU (expf and an IEEE
// division, as the plain version) adds a range reduction, an exponential
// and a refined reciprocal to every element.

#pragma once

#include <utility>

#include "sm90_attention.cuh"

namespace gnstrip {

using sm90::bf16;

constexpr int kThreads = 256;
constexpr int kMaxBoxes = 32;

// A block's work (strip_plan in cfm_tpu_torch/ops/groupnorm.py).
struct Plan {
  int width;     // W: channels of a strip
  int cluster;   // blocks of a cluster, splitting one strip's rows
  int items;     // items of a block (1 where cluster > 1)
  int rows;      // rows of a block's share (HW where items > 1)
  int box_rows;  // rows of one TMA box
  int boxes;     // boxes of a share
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// 16 bytes of T as floats, and back.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < 16 / (int)sizeof(T); ++u) v[u] = to_f<T>(e[u]);
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&v)[16 / sizeof(T)]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int u = 0; u < 16 / (int)sizeof(T); ++u) e[u] = from_f<T>(v[u]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Shared memory of a block: the strip tile, the row-slot partial sums, the
// per-channel sums of both passes (read by the cluster), the totals, the
// per-channel mean and inv, the barriers; plus 128 bytes of alignment.
inline size_t smem_bytes(const Plan& p, int itemsize) {
  const size_t tile = round16((size_t)p.items * p.boxes * p.box_rows * p.width * itemsize);
  const size_t vec = (size_t)p.items * p.width * sizeof(float);
  return 128 + tile + (size_t)kThreads * (16 / itemsize) * sizeof(float) + 5 * vec +
         kMaxBoxes * sizeof(uint64_t);
}

__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  return p + ((128 - (sm90::smem_addr(p) & 127)) & 127);
}

// The share's boxes of K tensors (maps[k] into tiles[k], rows [r_begin,
// r_begin + rows) of items n0 ...): thread 0 arms one mbarrier a box and
// issues box b of every tensor on barrier b; the block syncs before anyone
// waits on a barrier.
template <typename T, int K>
__device__ __forceinline__ void load_share(const CUtensorMap* const (&maps)[K],
                                           T* const (&tiles)[K], uint64_t* bar, const Plan& p,
                                           int c0, int r_begin, int n0) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < p.boxes; ++b) sm90::mbar_init(&bar[b], 1);
    sm90::mbar_fence_init();
    const uint32_t box_bytes = (uint32_t)(p.items * p.box_rows * p.width * sizeof(T));
    for (int b = 0; b < p.boxes; ++b) {
      sm90::mbar_expect_tx(&bar[b], K * box_bytes);
#pragma unroll
      for (int k = 0; k < K; ++k)
        sm90::tma_load_3d(tiles[k] + (size_t)b * p.box_rows * p.width, maps[k], &bar[b], c0,
                          r_begin + b * p.box_rows, n0);
    }
  }
  __syncthreads();
}

// A block's threads over its share. Thread tl of item it's Ti threads reads
// 16-byte column j of rows r0, r0 + R, ...; the chunks a warp reads are
// contiguous. L lanes of a warp add a channel's R row-slot sums (L the
// least power of two with 4 L >= R, at most 32).
struct Lanes {
  int W, IW, Ti, it, tl, nv, R, j, r0, L;
  __device__ Lanes(const Plan& p, int V) {
    W = p.width;
    IW = p.items * W;
    Ti = kThreads / p.items;
    it = threadIdx.x / Ti;
    tl = threadIdx.x % Ti;
    nv = W / V;
    R = Ti / nv;
    j = tl % nv;
    r0 = tl / nv;
    L = 1;
    while (L < 32 && 4 * L < R) L <<= 1;
  }
};

// Channel c < IW (item c / W, column c % W) of one sum whose per-thread
// partials (V a thread) are in ``part``: lane l of its L lanes adds the
// row slots l, l + L, ... in order, then the L lanes pairwise (xor L / 2,
// ..., 1); the total goes to out[c]. The caller syncs before and after.
__device__ __forceinline__ void lane_totals(const float* part, float* out, const Lanes& s, int V) {
  const int tid = threadIdx.x, lane = tid & 31, L = s.L, per_warp = 32 / L;
  for (int c0w = (tid >> 5) * per_warp; c0w < s.IW; c0w += (kThreads / 32) * per_warp) {
    const int c = c0w + lane / L, w = c % s.W;
    const float* slots = part + (size_t)(c / s.W) * s.Ti * V;
    float a = 0.f;
    if (c < s.IW)
      for (int rr = lane % L; rr < s.R; rr += L) a += slots[(rr * s.nv + w / V) * V + w % V];
    for (int o = L >> 1; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane % L == 0 && c < s.IW) out[c] = a;
  }
}

// The cluster's barriers, or the block's where the cluster is one block
// (launched then without a cluster): at the small maps the cluster's
// barriers and reads cost a block about a microsecond.
__device__ __forceinline__ void strip_sync(int cs) {
  if (cs > 1) sm90::cluster_sync();
  else __syncthreads();
}
__device__ __forceinline__ void strip_arrive(int cs) {
  if (cs > 1) sm90::cluster_arrive();
}
__device__ __forceinline__ void strip_wait(int cs) {
  if (cs > 1) sm90::cluster_wait();
}

// *p summed over the cluster's cs blocks in rank order (after a cluster
// sync that makes every block's *p visible).
template <int kMaxCluster>
__device__ __forceinline__ float rank_sum(const float* p, int cs) {
  if (cs == 1) return 0.f + *p;  // the same sum, read from the block's own memory
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < cs ? sm90::ld_cluster(p, r) : 0.f;
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < cs) t += v[r];
  return t;
}

// The first channel of channel c's group (c < IW, groups of cg channels
// within each item's W).
__device__ __forceinline__ int group_start(int c, int W, int cg) {
  return c - c % W + (c % W) / cg * cg;
}

template <typename T, typename Epi>
__global__ void __launch_bounds__(kThreads, 4)
strip_kernel(const __grid_constant__ CUtensorMap xmap, const Epi epi, int N, int HW, int C, int cg,
             const Plan p, float eps, int n_begin) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align128(smem_raw);
  const int W = p.width, rows_alloc = p.boxes * p.box_rows, IW = p.items * W;
  T* xs = reinterpret_cast<T*>(base);
  float* part = reinterpret_cast<float*>(base + round16((size_t)p.items * rows_alloc * W * sizeof(T)));
  float* col = part + kThreads * V;  // [pass][item][channel]
  float* tot = col + 2 * IW;
  float* mean = tot + IW;
  float* inv = mean + IW;
  uint64_t* bar = reinterpret_cast<uint64_t*>(inv + IW);

  const int tid = threadIdx.x;
  const int cs = p.cluster, strip = blockIdx.x / cs;
  const uint32_t rank = sm90::cluster_rank();
  const int c0 = strip * W, n0 = n_begin + blockIdx.y * p.items;
  const int r_begin = (int)rank * p.rows, nrows = min(p.rows, HW - r_begin);
  {
    const CUtensorMap* const maps[1] = {&xmap};
    T* const tiles[1] = {xs};
    load_share<T, 1>(maps, tiles, bar, p, c0, r_begin, n0);
  }

  const Lanes s(p, V);
  const int it = s.it, tl = s.tl, R = s.R, j = s.j, r0 = s.r0;
  const int n = n0 + it, Ws = min(W, C - c0);
  const bool active = r0 < R && n < N && j * V < Ws;
  const T* xi = xs + (size_t)it * rows_alloc * W + j * V;
  const float cnt = (float)HW * (float)cg;
  float* mine = part + tid * V;

  // One pass's column totals: the row slots and lanes (lane_totals), then
  // the cluster's blocks in rank order into tot.
  auto column_totals = [&](float* pass_col) {
    lane_totals(part, pass_col, s, V);
    strip_sync(cs);
    if (tid < IW) tot[tid] = rank_sum<8>(&pass_col[tid], cs);
  };
  // The total of channel c's group, its channels in order.
  auto group_total = [&](int c) {
    const int g0 = group_start(c, W, cg);
    float g = 0.f;
    for (int k = g0; k < g0 + cg; ++k) g += tot[k];
    return g;
  };

  float sv[V];
#pragma unroll
  for (int u = 0; u < V; ++u) sv[u] = 0.f;
  if (active)
    for (int r = r0; r < nrows; r += R) {
      sm90::mbar_wait(&bar[r / p.box_rows], 0);
      float v[V];
      load16<T>(xi + (size_t)r * W, v);
#pragma unroll
      for (int u = 0; u < V; ++u) sv[u] += v[u];
    }
#pragma unroll
  for (int u = 0; u < V; ++u) mine[u] = sv[u];
  __syncthreads();
  column_totals(col);
  __syncthreads();
  if (tid < IW) mean[tid] = group_total(tid) / cnt;
  __syncthreads();

  float mu[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    mu[u] = mean[it * W + j * V + u];
    sv[u] = 0.f;
  }
  if (active)
    for (int r = r0; r < nrows; r += R) {
      float v[V];
      load16<T>(xi + (size_t)r * W, v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float d = v[u] - mu[u];
        sv[u] = fmaf(d, d, sv[u]);
      }
    }
#pragma unroll
  for (int u = 0; u < V; ++u) mine[u] = sv[u];
  __syncthreads();
  column_totals(col + IW);
  strip_arrive(cs);  // done reading the other blocks' sums
  __syncthreads();
  if (tid < IW) inv[tid] = 1.f / sqrtf(group_total(tid) / cnt + eps);
  __syncthreads();

  if (rank == 0 && tl < Ws && n < N) epi.stats((size_t)n * C + c0 + tl, mean[it * W + tl], inv[it * W + tl]);
  if (active) {
    float iv[V], sc[V], bi[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int c = c0 + j * V + u;
      iv[u] = inv[it * W + j * V + u];
      sc[u] = epi.scale[c];
      bi[u] = epi.bias[c];
    }
    T* out = epi.out + ((size_t)n * HW + r_begin) * C + c0 + j * V;
    for (int r = r0; r < nrows; r += R) {
      float v[V];
      load16<T>(xi + (size_t)r * W, v);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = Epi::apply(v[u], mu[u], iv[u], sc[u], bi[u]);
      store16<T>(out + (size_t)r * C, v);
    }
  }
  strip_wait(cs);  // no block leaves while another may still read its sums
}

// Whether the plan fits the shape: whole groups, 16-byte columns, boxes of
// at most 256 rows, a cluster of at most max_cluster blocks covering HW,
// several items only where one box holds an item's rows.
inline bool plan_ok(int N, int HW, int C, int cg, int V, const Plan& p, int max_cluster) {
  return N > 0 && HW > 0 && cg > 0 && C % V == 0 && p.width > 0 &&
         p.width % V == 0 && p.width % cg == 0 && p.width <= 256 && p.items >= 1 &&
         p.items * p.width <= kThreads && p.cluster >= 1 && p.cluster <= max_cluster &&
         (long long)p.rows * p.cluster >= HW && p.box_rows >= 1 && p.box_rows <= 256 &&
         p.boxes >= 1 && p.boxes <= kMaxBoxes && p.boxes * p.box_rows >= p.rows &&
         (p.boxes == 1 || p.box_rows % 8 == 0) &&
         (p.items == 1 || (p.cluster == 1 && p.rows == HW && p.boxes == 1 &&
                           p.box_rows == HW && p.items <= 256));
}

// The rank-3 map over (N, HW, C) of x (or any tensor of its shape) whose
// boxes are the plan's (W channels, box_rows rows, items items).
template <typename T>
int encode_strip_map(CUtensorMap* map, const T* x, int N, int HW, int C, const Plan& p) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)HW, (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)HW * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)p.width, (cuuint32_t)p.box_rows, (cuuint32_t)p.items};
  return sm90::encode_map(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                              : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          3, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Launches ``kernel`` with ``smem`` bytes of dynamic shared memory on a grid
// of (strips x cluster, item groups) blocks in clusters of ``cluster``
// along x (a plain launch where the cluster is one block). A cluster that
// cannot be co-scheduled would never launch: that is asked once for each
// kernel, cluster size and shared-memory size (so not again under graph
// capture). Returns 0 or a CUDA error code.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), dim3 grid, int cluster, size_t smem,
                    cudaStream_t st, Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8 && (err = cudaFuncSetAttribute(
                          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  struct Known {
    const void* fn;
    int cluster;
    size_t smem;
  };
  static Known known[64];
  static int n_known = 0;
  if (cluster > 1) {
    bool seen = false;
    for (int i = 0; i < n_known && i < 64 && !seen; ++i)
      seen = known[i].fn == (const void*)kernel && known[i].cluster == cluster &&
             known[i].smem == smem;
    if (!seen) {
      int clusters = 0;
      if ((err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg)) !=
          cudaSuccess)
        return (int)err;
      if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
      known[n_known % 64] = Known{(const void*)kernel, cluster, smem};
      ++n_known;
    }
  }
  if ((err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...)) != cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

// Launches ``launch_one(grid, n_begin)`` for the item groups of the grid's
// rows: one launch, or one for each 65535 rows beyond (a grid's limit).
// Returns 0 or the first CUDA error code.
template <typename F>
int for_item_rows(int N, const Plan& p, unsigned columns, F&& launch_one) {
  constexpr int kMaxRows = 65535;
  const int groups = (N + p.items - 1) / p.items;
  for (int g0 = 0; g0 < groups; g0 += kMaxRows) {
    const int rows = groups - g0 < kMaxRows ? groups - g0 : kMaxRows;
    if (int err = launch_one(dim3(columns, (unsigned)rows, 1), g0 * p.items)) return err;
  }
  return 0;
}

// Checks the plan against the shape and launches the kernel with its
// cluster. Returns 0 or a CUDA error code.
template <typename T, typename Epi>
int launch(const T* x, const Epi& epi, int N, int HW, int C, int G, const Plan& p, float eps,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int cg = G > 0 && C % G == 0 ? C / G : 0;
  if (!plan_ok(N, HW, C, cg, V, p, 8) || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  if (int err = encode_strip_map<T>(&xmap, x, N, HW, C, p)) return err;
  const unsigned columns = (unsigned)((C + p.width - 1) / p.width * p.cluster);
  return for_item_rows(N, p, columns, [&](dim3 grid, int n_begin) {
    return launch_clusters(strip_kernel<T, Epi>, grid, p.cluster, smem_bytes(p, sizeof(T)), st,
                           xmap, epi, N, HW, C, cg, p, eps, n_begin);
  });
}

}  // namespace gnstrip
