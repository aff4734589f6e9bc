// Exact min-cost assignment by an epsilon-scaled forward auction on Hopper
// (sm_90a), one thread block per solve, the whole call in one launch.
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_auction.py:pallas_auction_assignment
// (bodies _auction_kernel and _round_body). It returns the identical
// permutation and round count, ties included, as its plain PyTorch version
// (cfm_tpu_torch/ops/auction.py:auction_assignment_onehot), which transcribes
// the TPU kernel's round:
//   - benefit = -cost; eps0 = max(max(benefit) - min(benefit), 1e-12) / 2 and
//     eps_final = eps0 / 4^(phases - 1), in f32 as _eps_schedule computes them
//     (max and min are exact and the divisions are by powers of two);
//   - every unassigned row i takes its best value v = benefit[i, j] - price[j]
//     at the FIRST column among the maxima, and the second value as the max
//     over every other column (with a tie, second == best);
//   - it bids  bid = (price[best] + (best - second)) + eps  on that column,
//     in that order, rounded at each step (__fadd_rn/__fsub_rn: the TPU adds,
//     it does not fuse);
//   - each column with bids goes to the highest bid, ties to the FIRST row;
//     its price becomes that bid and its previous owner is unassigned;
//   - when every row is assigned and eps > eps_final, eps /= 4 and the
//     assignment restarts with the prices kept (12 phases by default);
//   - the loop stops when all rows are assigned at eps_final, or after
//     200 n + 20000 rounds; then a partial matching is completed as
//     _sanitize_perm does it: the k-th unassigned row takes the k-th unowned
//     column (the identity on a converged solve).
//
// What bounds it. A solve is hundreds to thousands of dependent rounds, and
// after the first rounds of a phase a round has one to a few bidders (at
// n = 256 on the 2-D path: median 2, 90th percentile about 20). So a round is
// latency, a chain of dependent shared-memory loads, shuffles, atomics and
// two barriers: about 1,800 cycles on the H100, of which the bidder's scan
// is a half. Not bytes or arithmetic; chip_smoke.py's bound (row scans x n
// element operations over the card's f32 rate) is loose.
//
// Design.
//   - Static row ownership, threads sized to n: 2 to 16 warps (8 rows a warp
//     up to n = 128), warp w owns rows w * rpw .. w * rpw + rpw - 1, lane l
//     the row w * rpw + l. Each round a warp reads its rows' assignments once,
//     takes a ballot of the unassigned ones and scans them one after the
//     other; nothing is listed or appended.
//   - The benefit in shared memory as far as it fits: the first ls rows of
//     each warp (every row up to n = 236; 13 of 16 at n = 256, within the
//     232,448-byte opt-in limit). The other rows are read from the cost in
//     global memory (L2-resident, 1 MB at n = 512), negated on load. Holding
//     them in registers instead (8 columns a lane, up to 3 rows a warp, at
//     n <= 256) ran no faster at n = 256 (PERF.md).
//   - One pass per bidding row keeps (best, first column, second) and one
//     shuffle tree merges them (auction_common.cuh, as auction_tiled.cu).
//   - The winners resolve: after the barrier, each bidding lane reads its
//     column's packed bid word and, if its row is the winner, takes the
//     column, evicts the owner it read before the barrier and sets the
//     price. The bid words alternate between two buffers by round parity,
//     and each winner clears its word during the next round, when every
//     bidder has read it. The round's second barrier ORs whether a bidder
//     lost or an owner was evicted: whether a row is left unassigned.
//   - The wrapper's work is in the launch: the cost is negated on load, the
//     epsilon schedule comes from an in-kernel max/min, the completion is
//     done at the end, and the permutation is written as int64 beside the
//     round count and the row scans. A call is this one launch.
//   - Tried and dropped (slower, or no faster, at both of the main paths'
//     n; PERF.md): warp 0 running the rounds alone, without barriers
//     or atomics, once at most 4 rows are unassigned (its bidders' scans
//     then run one after the other on one warp); the lanes merged by three
//     redux.sync reductions instead of the shuffle tree; several bidders'
//     rows scanned in one interleaved pass; the best column's price carried
//     through the merge; a spinning barrier on shared memory; one barrier a
//     round, each row reading its outcome and the prices from the last
//     round's bid words (three buffers) instead of a winners' pass.
//
// Per-column winner without a second scan: one 64-bit atomicMax of the
// packed bid word per bidding row (auction_common.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "auction_common.cuh"

namespace {

using namespace auction;

constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = 32 * kMaxWarps;

// One pass over a row read through ``row`` (negated when it is the cost in
// global memory): the warp's (best, first column, second).
template <bool kNegate>
__device__ __forceinline__ void scan_row(const float* __restrict__ row, const float* price, int n,
                                         int lane, float& v1, int& j1, float& v2) {
  v1 = -INFINITY;
  j1 = n;
  v2 = kNeg;  // the TPU's max over j != first, with the first masked to kNeg
#pragma unroll 8
  for (int j = lane; j < n; j += 32) {
    const float b = kNegate ? -__ldg(row + j) : row[j];
    fold(__fsub_rn(b, price[j]), j, v1, j1, v2);
  }
  warp_merge(v1, j1, v2);
}

// rpw rows a warp: the first ls in shared memory (slot w * ls + l), the
// rest read from global memory.
__global__ void __launch_bounds__(kMaxThreads, 1)
auction_kernel(const float* __restrict__ cost, long long* __restrict__ out, int n,
               int num_phases, int rpw, int ls) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bids = reinterpret_cast<unsigned long long*>(smem_raw);  // 2 x n
  float* price = reinterpret_cast<float*>(bids + 2 * n);                       // n
  int* owner = reinterpret_cast<int*>(price + n);  // row owning column j, or -1
  int* assign = owner + n;                         // column of row i, or -1
  float* rows_s = reinterpret_cast<float*>(assign + n);  // warps x ls rows of the benefit
  __shared__ unsigned long long s_scans;
  __shared__ float s_max[kMaxWarps], s_min[kMaxWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int my_row = warp * rpw + lane;
  const bool mine = lane < rpw && my_row < n;

  // Load: the benefit (-cost) into shared memory, and the max and min over
  // all of it for the epsilon schedule.
  float bmax = -INFINITY, bmin = INFINITY;
  for (int e = tid; e < n * n; e += nthreads) {
    const float b = -__ldg(cost + e);
    bmax = fmaxf(bmax, b);
    bmin = fminf(bmin, b);
    const int r = e / n, l = r % rpw;
    if (l < ls) rows_s[((r / rpw) * ls + l) * n + e % n] = b;
  }
  for (int o = 16; o > 0; o >>= 1) {
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
    bmin = fminf(bmin, __shfl_xor_sync(0xffffffffu, bmin, o));
  }
  if (lane == 0) {
    s_max[warp] = bmax;
    s_min[warp] = bmin;
  }
  for (int j = tid; j < n; j += nthreads) {
    bids[j] = bids[n + j] = 0ull;
    price[j] = 0.f;
    owner[j] = -1;
    assign[j] = -1;
  }
  if (tid == 0) s_scans = 0ull;
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    bmax = fmaxf(bmax, s_max[w]);
    bmin = fminf(bmin, s_min[w]);
  }
  // _eps_schedule: clamp(max - min, 1e-12) / 2, then / 4^(phases - 1).
  float eps = __fmul_rn(fmaxf(__fsub_rn(bmax, bmin), 1e-12f), 0.5f);
  float div = 1.f;
  for (int p = 1; p < num_phases; ++p) div *= 4.f;
  const float eps_final = __fdiv_rn(eps, div);
  const int cap = 200 * n + 20000;
  int rounds = 0;
  int clear = -1;            // the bid word this lane's row won last round
  bool left = true;          // some row owns no column (the same in every thread)
  unsigned long long scans = 0ull;

  while (left && rounds < cap) {
    unsigned long long* word = bids + (rounds & 1) * n;
    if (clear >= 0) {  // last round's word, read by every bidder before the barrier
      bids[((rounds & 1) ^ 1) * n + clear] = 0ull;
      clear = -1;
    }
    // Bids: the warp scans its unassigned rows one after the other.
    const bool bidding = mine && assign[my_row] < 0;
    float my_bid = kNeg;
    int my_col = 0, my_prev = -1;
    for (unsigned todo = __ballot_sync(0xffffffffu, bidding); todo; todo &= todo - 1) {
      const int l = __ffs(todo) - 1, r = warp * rpw + l;
      float v1, v2;
      int j1;
      if (l < ls)
        scan_row<false>(rows_s + (size_t)(warp * ls + l) * n, price, n, lane, v1, j1, v2);
      else
        scan_row<true>(cost + (size_t)r * n, price, n, lane, v1, j1, v2);
      const float bid = bid_value(price[j1], v1, v2, eps);
      if (lane == l) {
        my_bid = bid;
        my_col = j1;
        my_prev = owner[j1];  // the column's owner at the round's start
      }
      if (lane == 0) {
        ++scans;
        if (bid > kNeg) atomicMax(&word[j1], pack_bid(bid, r));
      }
    }
    __syncthreads();
    // The winners take their columns.
    const bool won = my_bid > kNeg && packed_row(word[my_col]) == my_row;
    if (won) {
      if (my_prev >= 0) assign[my_prev] = -1;
      owner[my_col] = my_row;
      assign[my_row] = my_col;
      price[my_col] = my_bid;
      clear = my_col;
    }
    // A row owns no column after the round if a bidder lost or a winner
    // evicted an owner: the barrier's OR tells every thread.
    left = __syncthreads_or((bidding && !won) || (won && my_prev >= 0));
    ++rounds;
    if (!left && eps > eps_final) {  // the same in every thread
      left = true;
      eps = eps / 4.0f;
      for (int j = tid; j < n; j += nthreads) {
        owner[j] = -1;
        assign[j] = -1;
      }
      __syncthreads();
    }
  }
  if (lane == 0 && scans) atomicAdd(&s_scans, scans);
  // At the round cap: the k-th unassigned row takes the k-th unowned column.
  if (tid == 0 && left) {
    int j = 0;
    for (int i = 0; i < n; ++i) {
      if (assign[i] >= 0) continue;
      while (owner[j] >= 0) ++j;
      assign[i] = j;
      owner[j] = i;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += nthreads) out[i] = assign[i];
  if (tid == 0) {
    out[n] = rounds;
    out[n + 1] = (long long)s_scans;
  }
}

size_t state_bytes(int n) { return (size_t)n * (2 * 8 + 4 + 4 + 4); }

}  // namespace

extern "C" {

// cost: (n, n) f32, 0 < n <= 512, on the device. out: (n + 2,) int64: the
// column of each row, then the round count, then the row scans (bids).
// Returns 0 or the CUDA error code.
int auction_solve(const float* cost, long long* out, int n, int num_phases, void* stream) {
  if (n <= 0 || n > 512) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  int warps = (n + 7) / 8;  // 8 rows a warp up to n = 128 (16 warps were faster than 8 there)
  warps = warps < 2 ? 2 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int rpw = (n + warps - 1) / warps;  // <= 32
  const size_t budget = (size_t)optin - 1024;  // the static shared memory's room
  const size_t state = state_bytes(n);
  if (state > budget) return (int)cudaErrorInvalidValue;
  int ls = (int)((budget - state) / ((size_t)n * 4) / warps);  // shared-memory rows a warp
  if (ls > rpw) ls = rpw;
  const size_t smem = state + (size_t)warps * ls * n * 4;
  if ((err = cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  auction_kernel<<<1, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, out, n, num_phases, rpw, ls);
  return (int)cudaGetLastError();
}

}  // extern "C"
