// Exact min-cost assignment by the epsilon-scaled forward auction for
// n = 1024..4096 on Hopper (sm_90a): one persistent thread block per solve.
//
// Replaces the TPU kernel
// cfm_tpu/ops/pallas_auction.py:pallas_auction_assignment_tiled (body
// _make_tiled_kernel). It returns the identical permutation, ties included,
// and the identical round count as its plain PyTorch version
// (cfm_tpu_torch/ops/auction.py:auction_assignment_tiled_reference), which
// transcribes the TPU kernel's round:
//   - every unassigned row (one that owns no column) takes its best value
//     v = benefit[i, j] - price[j] at the FIRST column among the maxima, and
//     the second value as the max over every other column (with a tie,
//     second == best);
//   - it bids (price[best] + (best - second)) + eps on that column, rounded
//     at each step as the TPU adds;
//   - each column with bids goes to the highest bid, ties to the earlier
//     row tile and within it to the first row, so to the smallest row; its
//     price becomes that bid and its previous owner owns nothing;
//   - when every column is owned and eps > eps_final, eps /= 4 and every
//     owner is reset, prices kept (12 phases by default);
//   - the loop stops when all columns are owned at eps_final, or after
//     200 n + 20000 rounds (rows left without a column get the n sentinel).
//
// What bounds it. The TPU kernel streams the benefit matrix tile by tile
// through every round because Mosaic needs dense (tile, n) temporaries and
// VMEM cannot hold (n, n) ones. A round has two to eight candidate rows
// after the first few of each phase, so a solve is tens of thousands of
// dependent rounds (22k at the 2-D evaluation's n = 2048): the latency of
// one round bounds it, not bytes or arithmetic. The state is compact and
// lives in a block's shared memory (36 B a column, and 16 more for the wide
// rounds' words in a cluster: 212 KB at n = 4096): price, owner, the column
// of each row, one packed 64-bit bid word per column (auction_common.cuh),
// the candidate rows of this round and the next, and the columns that
// received bids. Only the rows that bid are read
// (float4 loads from global memory; the benefit stays L2-resident up to
// n = 2048, 16 MB, and comes from HBM at n = 4096, 64 MB). No host read
// until the solve ends.
//
// The round, chosen each round by its candidate count b:
//   - Few candidates (b <= 32) at n >= 2048: the idle warps share the rows.
//     Each row gets w = 32 / b rounded down to a power of two warps, each
//     over a contiguous slice of n / w columns, and writes its partial
//     (best, first column, second) to shared memory; after the block
//     barrier warp 0 alone merges each row's w partials (lane l holds warp
//     l's; a shuffle tree over the row's lanes), bids, takes each column's
//     winner from the packed atomicMax and settles the columns from the
//     winners' lanes, appending the bidders and the evicted owners by
//     ballot. The merge rule of merge() (auction_common.cuh) is commutative
//     and associative, so the result is the one-pass scan's bits whatever w
//     and the order (tests/test_torch_auction.py holds that on the CPU).
//   - Wide rounds (each phase's first rounds) at 2048 <= n <= 4096: a
//     thread-block cluster of two, one block an SM, each block holding a
//     replica of the state. Every block runs the few-candidate rounds on
//     its own replica (the same code, the same bits, no communication). In
//     a wide round block k scans the candidates k, k + 2, ..., one warp a
//     row, and bids into its own words (double-buffered by the wide round's
//     parity, as a block may start the next wide round before the other
//     has read this one's); after a cluster barrier every block takes, for
//     each column, the larger of the two blocks' words through distributed
//     shared memory, and settles all columns in column order, listing the
//     bidders in the candidates' order and the evicted owners in the
//     columns', so the replicas, and the next round's split of the rows,
//     stay the same; a second barrier lets each block clear its words.
//   - Otherwise (wide rounds, and every round at n < 2048; n > 4096): one
//     warp a row over all n columns, bids by atomics, then every thread
//     settles the listed columns, in one block.
// Two block barriers a round, two cluster barriers more a wide round.
//
// Measured on an H100 (probes/tiled_auction.py; its figures in PERF.md),
// on the 2-D evaluation's W1 cost: a few-candidate round costs a
// nearly fixed number of cycles wherever its rows come from, while the
// one-warp round grows with n, so the shared round pays from n = 2048 and
// not at 1024. Shorter scans did not shorten the round (slices for 32, 16,
// 8 or 4 warps, four or eight independent accumulators a lane with all of
// its loads issued at once, named barriers a row: no faster, or slower):
// the cycles go to the round's chain of dependent shared-memory steps,
// shuffles and barriers, which the probe's microbenchmark times one by one.
// The wide rounds stream the benefit from L2 through one SM; a cluster of
// two halves that and measured faster than clusters of 1, 4 or 8 (more
// blocks read more words and wait at each barrier). Bidding by 64-bit
// atomicMax straight into one block's words across the cluster
// (atom.shared::cluster) gave wrong permutations that changed from run to
// run, so each block bids locally and the settle takes the max.
//
// Candidates. The rows unassigned at the start of round t + 1 are the rows
// that bid in round t and lost, and the previous owners of the columns won
// in round t. Each bidder appends itself to the next round's list and each
// evicted owner is appended by the winner pass; the next round skips the
// bidders that won (they own a column by then). The order of the list does
// not matter: each column's winner comes from the packed atomicMax.
//
// The kernel also counts its row scans (one per bid), which chip_smoke.py
// turns into the solve's work for the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_common.cuh"

namespace {

using namespace auction;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Rounds of at most kWarps candidates take the few-candidate round at
// n >= kShareN; below, a row's one-warp scan is short enough that the wide
// round is faster (measured on an H100: PERF.md).
constexpr int kShareN = 2048;
// At kShareN <= n <= kSettle * kThreads the wide rounds run on a cluster of
// kCluster blocks, each thread settling kSettle columns.
constexpr int kCluster = 2;
constexpr int kSettle = 4;

__host__ __device__ constexpr bool clustered(int n) {
  return n >= kShareN && n <= kSettle * kThreads;
}

// One pass over the ``q4`` float4s of a row slice starting at float4 ``q0``:
// the warp's best value, its first column and the second value, the same in
// every lane on return. Lane l folds float4s l, l + 32, ... in order of
// column, as fold() needs; the unrolled loop issues four loads a lane before
// it folds them.
__device__ __forceinline__ void scan_slice(const float4* __restrict__ row, const float4* p4, int q0,
                                           int q4, int lane, float& v1, int& j1, float& v2) {
  v1 = -INFINITY;
  j1 = 0x7fffffff;
  v2 = kNeg;  // the TPU's max over j != first, with the first masked to kNeg
#pragma unroll 4
  for (int q = q0 + lane; q < q0 + q4; q += 32) {
    const float4 b = __ldg(row + q);
    const float4 p = p4[q];
    const int j = 4 * q;
    fold(__fsub_rn(b.x, p.x), j, v1, j1, v2);
    fold(__fsub_rn(b.y, p.y), j + 1, v1, j1, v2);
    fold(__fsub_rn(b.z, p.z), j + 2, v1, j1, v2);
    fold(__fsub_rn(b.w, p.w), j + 3, v1, j1, v2);
  }
  warp_merge(v1, j1, v2);
}

// Distributed shared memory: the address of ``p`` in the cluster's block
// ``rank``, and loads there.
__device__ __forceinline__ uint32_t dsmem(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ unsigned long long dsmem_load(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t dsmem_load32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every thread of the cluster, not necessarily converged within its warp
// (the .aligned forms require a converged warp; these follow divergent
// loops).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

// The exclusive prefix of ``v`` over the block in thread order, and the
// total. ``red`` holds kWarps ints; every thread calls it.
__device__ __forceinline__ int block_scan(int v, int* red, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int w = lane < kWarps ? red[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  total = __shfl_sync(0xffffffffu, w, kWarps - 1);
  const int before = warp ? __shfl_sync(0xffffffffu, w, warp - 1) : 0;
  __syncthreads();  // ``red`` may be reused
  return before + x - v;
}

// CLUSTER: kCluster blocks, each on its own SM, each holding a replica of
// the state. A few-candidate round runs in every block on its replica (the
// same code, the same bits, no communication); in a wide round the blocks
// split the candidate rows, bid into rank 0's bid words, read them back and
// settle the columns in column order, so every replica stays the same.
template <bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
auction_tiled_kernel(const float* __restrict__ benefit, const float* __restrict__ eps0_p,
                     const float* __restrict__ eps_final_p, int* __restrict__ perm,
                     int* __restrict__ rounds_out, unsigned long long* __restrict__ scans_out,
                     int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bids = reinterpret_cast<unsigned long long*>(smem_raw);  // n
  float* price = reinterpret_cast<float*>(bids + n);                           // n
  int* owner = reinterpret_cast<int*>(price + n);  // row owning column j, or -1
  int* assign = owner + n;                         // column of row i, or -1
  int* cand = assign + n;                          // 2 x n: candidate rows, by round parity
  int* cols = cand + 2 * n;                        // 2 x n: columns with bids, by round parity
  // CLUSTER: 2 x n bid words of the wide rounds, by their parity (rank 0's are used)
  unsigned long long* wide_words = reinterpret_cast<unsigned long long*>(cols + 2 * n);
  __shared__ float s_v1[kWarps], s_v2[kWarps];     // the warps' partials (few candidates)
  __shared__ int s_j1[kWarps], s_red[kWarps];
  __shared__ int s_cand[2], s_cols[2];
  __shared__ int s_assigned;  // columns assigned so far, over all phases (never reset)
  __shared__ int s_round;     // CLUSTER: the round a block is in at a wide round's first barrier
  __shared__ unsigned long long s_scans;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = CLUSTER ? cluster_rank() : 0;
  for (int j = tid; j < n; j += kThreads) {
    bids[j] = 0ull;
    price[j] = 0.f;
    owner[j] = -1;
    assign[j] = -1;
    cand[j] = j;
    if (CLUSTER) wide_words[j] = wide_words[n + j] = 0ull;
  }
  if (tid == 0) {
    s_cand[0] = n;
    s_cand[1] = 0;
    s_cols[0] = s_cols[1] = 0;
    s_assigned = 0;
    s_scans = 0ull;
  }
  float eps = *eps0_p;
  const float eps_final = *eps_final_p;
  const int cap = 200 * n + 20000;
  const float4* p4 = reinterpret_cast<const float4*>(price);
  int rounds = 0, base = 0;  // base: s_assigned at the start of this phase
  int wide = 0;              // CLUSTER: wide rounds so far
  unsigned long long scans = 0ull;
  if constexpr (CLUSTER) cluster_sync();  // every replica set up before rank 0's words take bids
  else __syncthreads();

  while (s_assigned - base < n && rounds < cap) {
    const int b = rounds & 1;
    const int* cur = cand + b * n;
    int* nxt = cand + (b ^ 1) * n;
    const int ncur = s_cand[b];
    if (ncur <= kWarps && n >= kShareN) {
      // Few candidates: w warps a row, each over a slice of n / w columns,
      // their partials to shared memory; then warp 0 alone merges them,
      // bids and settles the columns, so the round has two block barriers
      // and no atomics between warps.
      const int w = 1 << (31 - __clz(kWarps / max(ncur, 1)));
      const int i = warp / w, q4 = n / 4 / w;
      if (i < ncur) {
        const int r = cur[i];
        float v1 = -INFINITY, v2 = kNeg;
        int j1 = 0x7fffffff;
        if (assign[r] < 0)  // else it won its column in the previous round
          scan_slice(reinterpret_cast<const float4*>(benefit + (size_t)r * n), p4, (warp % w) * q4,
                     q4, lane, v1, j1, v2);
        if (lane == 0) {
          s_v1[warp] = v1;
          s_j1[warp] = j1;
          s_v2[warp] = v2;
        }
      }
      __syncthreads();
      if (warp == 0) {
        // Lane l holds warp l's partial; lanes l .. l + w - 1 are one row's.
        const bool held = lane < ncur * w;
        float v1 = held ? s_v1[lane] : -INFINITY, v2 = held ? s_v2[lane] : kNeg;
        int j1 = held ? s_j1[lane] : 0x7fffffff;
        for (int o = w >> 1; o > 0; o >>= 1)
          merge(v1, j1, v2, __shfl_xor_sync(0xffffffffu, v1, o),
                __shfl_xor_sync(0xffffffffu, j1, o), __shfl_xor_sync(0xffffffffu, v2, o));
        const int r = held && lane % w == 0 ? cur[lane / w] : -1;
        const bool bidder = r >= 0 && assign[r] < 0;
        const unsigned bidders = __ballot_sync(0xffffffffu, bidder);
        const int at = s_cand[b ^ 1];  // 0: this round appends nothing else
        if (bidder) {
          scans += rank == 0;  // every replica scans the row; rank 0 counts it
          nxt[at + __popc(bidders & ((1u << lane) - 1u))] = r;
          const float bid = bid_value(price[j1], v1, v2, eps);
          if (bid > kNeg) atomicMax(&bids[j1], pack_bid(bid, r));
        }
        __syncwarp();
        // Each column with bids goes to its best bidder, settled by the
        // winner's lane (not the first to bid, which varies from run to run:
        // the order of the evicted rows in the next list must not).
        const unsigned long long word = bidder ? bids[j1] : 0ull;
        const bool lists = bidder && word != 0ull && packed_row(word) == r;
        __syncwarp();
        const int prev = lists ? owner[j1] : -1;
        const unsigned listed = __ballot_sync(0xffffffffu, lists);
        const unsigned evicts = __ballot_sync(0xffffffffu, prev >= 0);
        if (lists) {
          if (prev >= 0) {
            assign[prev] = -1;
            nxt[at + __popc(bidders) + __popc(evicts & ((1u << lane) - 1u))] = prev;
          }
          const int wr = packed_row(word);
          owner[j1] = wr;
          assign[wr] = j1;
          price[j1] = packed_bid(word);
          bids[j1] = 0ull;
        }
        if (lane == 0) {
          s_cand[b ^ 1] = at + __popc(bidders) + __popc(evicts);
          s_assigned += __popc(listed) - __popc(evicts);
          s_cand[b] = 0;
          s_cols[b ^ 1] = 0;  // the next round's list of columns, if it is a wide one
        }
      }
    } else if constexpr (CLUSTER) {
      // Wide round across the cluster: block ``rank`` scans the candidates
      // i = rank, rank + kCluster, ... and bids into its own wide-round
      // words (of this wide round's parity: a block may start the next
      // wide round before another has cleared this one's). Every block
      // lists the bidders in the order of the candidates, then settles every
      // column in column order from the largest of the blocks' words.
      unsigned long long* words = wide_words + (wide & 1) * n;
      for (int i = (int)rank + kCluster * warp; i < ncur; i += kCluster * kWarps) {
        const int r = cur[i];
        if (assign[r] >= 0) continue;  // it won its column in the previous round
        float v1, v2;
        int j1;
        scan_slice(reinterpret_cast<const float4*>(benefit + (size_t)r * n), p4, 0, n / 4, lane,
                   v1, j1, v2);
        if (lane == 0) {
          ++scans;
          const float bid = bid_value(price[j1], v1, v2, eps);
          if (bid > kNeg) atomicMax(&words[j1], pack_bid(bid, r));
        }
      }
      const int per = (ncur + kThreads - 1) / kThreads, i0 = tid * per;
      int mine = 0;
      for (int i = i0; i < min(ncur, i0 + per); ++i) mine += assign[cur[i]] < 0;
      int nb;
      int at = block_scan(mine, s_red, nb);
      for (int i = i0; i < min(ncur, i0 + per); ++i)
        if (assign[cur[i]] < 0) nxt[at++] = cur[i];
      if (tid == 0) s_round = rounds;
      cluster_sync();  // every bid is in its block's words
      // The replicas must be in the same round: a fault, never a deadlock.
      if (tid == 0 && (int)dsmem_load32(dsmem(&s_round, 0)) != rounds) __trap();
      // Thread t settles columns t kSettle .. t kSettle + kSettle - 1.
      const int j0 = tid * kSettle;
      unsigned long long word[kSettle];
      int ev = 0, won = 0;
#pragma unroll
      for (int u = 0; u < kSettle; ++u) {
        word[u] = 0ull;
        if (j0 + u < n)
          for (int q = 0; q < kCluster; ++q)
            word[u] = max(word[u], dsmem_load(dsmem(&words[j0 + u], q)));
        if (word[u]) {
          ev += owner[j0 + u] >= 0;
          ++won;
        }
      }
      int nev;
      at = nb + block_scan(ev, s_red, nev);
#pragma unroll
      for (int u = 0; u < kSettle; ++u)
        if (word[u]) {
          const int j = j0 + u, prev = owner[j], wr = packed_row(word[u]);
          if (prev >= 0) {
            assign[prev] = -1;
            nxt[at++] = prev;
          }
          owner[j] = wr;
          assign[wr] = j;
          price[j] = packed_bid(word[u]);
        }
      if (won - ev) atomicAdd(&s_assigned, won - ev);
      if (tid == 0) {
        s_cand[b ^ 1] = nb + nev;
        s_cand[b] = 0;
        s_cols[b ^ 1] = 0;
      }
      cluster_sync();  // every block has read the words: each clears its own
      for (int j = tid; j < n; j += kThreads) words[j] = 0ull;
      ++wide;
    } else {
      // Many candidates (each phase's first rounds), or short rows: one warp
      // a row, bids by atomics, then every thread settles the listed columns.
      int* bid_cols = cols + b * n;
      for (int i = warp; i < ncur; i += kWarps) {
        const int r = cur[i];
        if (assign[r] >= 0) continue;  // it won its column in the previous round
        float v1, v2;
        int j1;
        scan_slice(reinterpret_cast<const float4*>(benefit + (size_t)r * n), p4, 0, n / 4, lane,
                   v1, j1, v2);
        if (lane == 0) {
          ++scans;
          nxt[atomicAdd(&s_cand[b ^ 1], 1)] = r;
          const float bid = bid_value(price[j1], v1, v2, eps);
          if (bid > kNeg && atomicMax(&bids[j1], pack_bid(bid, r)) == 0ull)
            bid_cols[atomicAdd(&s_cols[b], 1)] = j1;  // the column's first bid lists it
        }
      }
      __syncthreads();
      const int ncols = s_cols[b];
      for (int k = tid; k < ncols; k += kThreads) {
        const int j = bid_cols[k];
        const unsigned long long word = bids[j];
        const int r = packed_row(word);
        const int prev = owner[j];
        if (prev >= 0) {
          assign[prev] = -1;
          nxt[atomicAdd(&s_cand[b ^ 1], 1)] = prev;
        } else {
          atomicAdd(&s_assigned, 1);
        }
        owner[j] = r;
        assign[r] = j;
        price[j] = packed_bid(word);
        bids[j] = 0ull;
      }
      if (tid == 0) {
        s_cand[b] = 0;       // read into ncur before the barrier above
        s_cols[b ^ 1] = 0;   // last read in the previous round's winner pass
      }
    }
    __syncthreads();
    ++rounds;
    if (s_assigned - base == n && eps > eps_final) {  // the same in every thread
      base += n;
      eps = eps / 4.0f;
      for (int j = tid; j < n; j += kThreads) {
        owner[j] = -1;
        assign[j] = -1;
        nxt[j] = j;
      }
      if (tid == 0) s_cand[b ^ 1] = n;
      __syncthreads();
    }
  }
  if (scans) atomicAdd(&s_scans, scans);
  if constexpr (CLUSTER) {
    cluster_sync();  // every block's count is in
    if (rank == 0 && tid == 0) {
      unsigned long long total = 0ull;
      for (int k = 0; k < kCluster; ++k) total += dsmem_load(dsmem(&s_scans, k));
      s_scans = total;
    }
    cluster_sync();  // no block leaves while rank 0 reads its count
  } else {
    __syncthreads();
  }
  if (rank == 0) {
    for (int i = tid; i < n; i += kThreads) perm[i] = assign[i] >= 0 ? assign[i] : n;
    if (tid == 0) {
      *rounds_out = rounds;
      *scans_out = s_scans;
    }
  }
}

size_t smem_bytes(int n) {
  return (size_t)n * (8 + 4 + 4 + 4 + 2 * 4 + 2 * 4 + (clustered(n) ? 2 * 8 : 0));
}

}  // namespace

extern "C" {

// benefit: (n, n) f32 = -cost, n > 0 a multiple of 128; eps0, eps_final: one
// f32 each, on the device. perm: (n,) int32 out, the column of each row (n
// for a row left without one at the round cap); rounds: one int32 out;
// scans: one uint64 out, the row scans (bids) of the solve. Returns 0 or the
// CUDA error code.
int auction_tiled_solve(const float* benefit, const float* eps0, const float* eps_final,
                        int* perm, int* rounds, unsigned long long* scans, int n, void* stream) {
  if (n <= 0 || n % 128 != 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  const size_t smem = smem_bytes(n);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const bool cluster = clustered(n);
  auto kernel = cluster ? auction_tiled_kernel<true> : auction_tiled_kernel<false>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster ? kCluster : 1, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster ? kCluster : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, benefit, eps0, eps_final, perm, rounds, scans, n)) !=
      cudaSuccess)
    return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
