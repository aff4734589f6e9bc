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
// Design. The TPU kernel streams the benefit matrix tile by tile through
// every round because Mosaic needs dense (tile, n) temporaries and VMEM
// cannot hold (n, n) ones. A round has about ten bidders after the first
// few of each phase, so a solve is tens of thousands of dependent rounds:
// latency bounds it, not bytes or arithmetic. Here the state is compact and
// lives in one block's shared memory (36 B a column, 144 KB at n = 4096):
// price, owner, the column of each row, one packed 64-bit bid word per
// column (auction_common.cuh), the candidate rows of this round and the
// next, and the columns that received bids. Only the rows that bid are read
// (float4 loads from global memory; the benefit stays L2-resident up to
// n = 2048, 16 MB, and comes from HBM at n = 4096, 64 MB), one warp a row in
// ONE pass that keeps the best value, its first column and the second value.
// The winner pass walks only the columns that received bids. Two block-wide
// barriers a round; no host read until the solve ends.
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

// One pass over row r: the warp's best value, its first column and the
// second value, the same in every lane on return.
__device__ __forceinline__ void scan_row(const float* __restrict__ benefit, const float* price,
                                         int r, int n, int lane, float& v1, int& j1, float& v2) {
  const float4* row = reinterpret_cast<const float4*>(benefit + (size_t)r * n);
  const float4* p4 = reinterpret_cast<const float4*>(price);
  v1 = -INFINITY;
  j1 = n;
  v2 = kNeg;  // the TPU's max over j != first, with the first masked to kNeg
#pragma unroll 4
  for (int q = lane; q < n / 4; q += 32) {
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
  __shared__ int s_cand[2], s_cols[2];
  __shared__ int s_assigned;  // columns assigned so far, over all phases (never reset)
  __shared__ unsigned long long s_scans;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < n; j += kThreads) {
    bids[j] = 0ull;
    price[j] = 0.f;
    owner[j] = -1;
    assign[j] = -1;
    cand[j] = j;
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
  int rounds = 0, base = 0;  // base: s_assigned at the start of this phase
  unsigned long long scans = 0ull;
  __syncthreads();

  while (s_assigned - base < n && rounds < cap) {
    const int b = rounds & 1;
    const int* cur = cand + b * n;
    int* nxt = cand + (b ^ 1) * n;
    int* bid_cols = cols + b * n;
    const int ncur = s_cand[b];
    // Bids: one warp per unassigned candidate row.
    for (int i = warp; i < ncur; i += kWarps) {
      const int r = cur[i];
      if (assign[r] >= 0) continue;  // it won its column in the previous round
      float v1, v2;
      int j1;
      scan_row(benefit, price, r, n, lane, v1, j1, v2);
      if (lane == 0) {
        ++scans;
        nxt[atomicAdd(&s_cand[b ^ 1], 1)] = r;
        const float bid = bid_value(price[j1], v1, v2, eps);
        if (bid > kNeg && atomicMax(&bids[j1], pack_bid(bid, r)) == 0ull)
          bid_cols[atomicAdd(&s_cols[b], 1)] = j1;  // the column's first bid lists it
      }
    }
    __syncthreads();
    // Each column with bids goes to its best bidder.
    const int ncols = s_cols[b];
    for (int k = tid; k < ncols; k += kThreads) {
      const int j = bid_cols[k];
      const unsigned long long w = bids[j];
      const int r = packed_row(w);
      const int prev = owner[j];
      if (prev >= 0) {
        assign[prev] = -1;
        nxt[atomicAdd(&s_cand[b ^ 1], 1)] = prev;
      } else {
        atomicAdd(&s_assigned, 1);
      }
      owner[j] = r;
      assign[r] = j;
      price[j] = packed_bid(w);
      bids[j] = 0ull;
    }
    if (tid == 0) {
      s_cand[b] = 0;       // read into ncur before the barrier above
      s_cols[b ^ 1] = 0;   // last read in the previous round's winner pass
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
  if (lane == 0 && scans) atomicAdd(&s_scans, scans);
  for (int i = tid; i < n; i += kThreads) perm[i] = assign[i] >= 0 ? assign[i] : n;
  __syncthreads();
  if (tid == 0) {
    *rounds_out = rounds;
    *scans_out = s_scans;
  }
}

size_t smem_bytes(int n) { return (size_t)n * (8 + 4 + 4 + 4 + 2 * 4 + 2 * 4); }

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
  if ((err = cudaFuncSetAttribute(auction_tiled_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  auction_tiled_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      benefit, eps0, eps_final, perm, rounds, scans, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
