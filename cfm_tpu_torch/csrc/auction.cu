// Exact min-cost assignment by an epsilon-scaled forward auction on Hopper
// (sm_90a), one thread block per solve.
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_auction.py:pallas_auction_assignment
// (bodies _auction_kernel and _round_body). It returns the identical
// permutation, ties included, as its plain PyTorch version
// (cfm_tpu_torch/ops/auction.py:auction_assignment_onehot), which transcribes
// the TPU kernel's round:
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
//     200 n + 20000 rounds.
//
// State. The TPU kernel keeps a dense one-hot (n, n) assignment because
// Mosaic has no scatter. Here the state is compact and lives in shared
// memory: the price and the owner of each column, the column of each row,
// and one 64-bit bid word per column. The benefit matrix is kept in shared
// memory too when it fits (64 KB at n = 128, up to n ~ 236 within 227 KB);
// above that its rows are read from global memory, where they stay
// L2-resident for n <= 512.
//
// Per-column winner without a second scan. A bidding row packs
// (order-preserving bits of its bid) << 32 | ~row into a word and applies
// atomicMax on its column's word. The maximum is the highest bid and, among
// equal bids, the smallest row: the same winner as the TPU kernel's
// first-row rule, whatever order the atomics land in. Zero bids are made +0
// first, so -0 and +0 tie as they compare.
//
// What bounds it. A solve is thousands of short rounds, each two or three
// block-wide barriers plus a row scan per unassigned row: latency, not bytes
// or arithmetic. One block per solve is the design for the coupling's single
// solve per step; the bound chip_smoke.py reports (rounds x n^2 element
// operations over the card's non-tensor f32 rate) is loose.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kNeg = -3.0e38f;  // the TPU kernel's "no bid" value

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit_g, const float* __restrict__ eps0_p,
               const float* __restrict__ eps_final_p, int* __restrict__ perm,
               int* __restrict__ rounds_out, int n, int resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* bids = reinterpret_cast<unsigned long long*>(smem_raw);  // n
  float* prices = reinterpret_cast<float*>(bids + n);                          // n
  int* owner = reinterpret_cast<int*>(prices + n);   // row owning column j, or -1
  int* assign = owner + n;                           // column of row i, or -1
  float* benefit_s = reinterpret_cast<float*>(assign + n);  // n * n when resident
  __shared__ int s_assigned;  // rows assigned so far, over all phases (never reset)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
  for (int j = tid; j < n; j += kThreads) {
    bids[j] = 0ull;
    prices[j] = 0.f;
    owner[j] = -1;
    assign[j] = -1;
  }
  if (resident)
    for (int e = tid; e < n * n; e += kThreads) benefit_s[e] = benefit_g[e];
  if (tid == 0) s_assigned = 0;
  const float* benefit = resident ? benefit_s : benefit_g;
  float eps = *eps0_p;
  const float eps_final = *eps_final_p;
  const int cap = 200 * n + 20000;
  int rounds = 0, base = 0;  // base: s_assigned at the start of this phase
  __syncthreads();

  while (s_assigned - base < n && rounds < cap) {
    // Bids: one warp per unassigned row.
    for (int r = warp; r < n; r += nwarps) {
      if (assign[r] >= 0) continue;
      const float* row = benefit + (size_t)r * n;
      float bv = -INFINITY;
      int bj = n;
      for (int j = lane; j < n; j += 32) {
        const float v = __fsub_rn(row[j], prices[j]);
        if (v > bv) { bv = v; bj = j; }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (ov > bv || (ov == bv && oj < bj)) { bv = ov; bj = oj; }
      }
      float sv = kNeg;
      for (int j = lane; j < n; j += 32)
        if (j != bj) sv = fmaxf(sv, __fsub_rn(row[j], prices[j]));
      for (int o = 16; o > 0; o >>= 1) sv = fmaxf(sv, __shfl_xor_sync(0xffffffffu, sv, o));
      if (lane == 0) {
        float bid = __fadd_rn(__fadd_rn(prices[bj], __fsub_rn(bv, sv)), eps);
        if (bid == 0.f) bid = 0.f;  // -0 -> +0: equal bids must pack equal
        if (bid > kNeg)
          atomicMax(&bids[bj], ((unsigned long long)order_bits(bid) << 32) |
                                   (unsigned long long)(~(uint32_t)r));
      }
    }
    __syncthreads();
    // Each column with bids goes to its best bidder.
    for (int j = tid; j < n; j += kThreads) {
      const unsigned long long w = bids[j];
      if (w) {
        const int r = (int)(~(uint32_t)(w & 0xffffffffull));
        const int prev = owner[j];
        if (prev >= 0)
          assign[prev] = -1;
        else
          atomicAdd(&s_assigned, 1);
        owner[j] = r;
        assign[r] = j;
        prices[j] = from_order_bits((uint32_t)(w >> 32));
        bids[j] = 0ull;
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
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += kThreads) perm[i] = assign[i] >= 0 ? assign[i] : n;
  if (tid == 0) *rounds_out = rounds;
}

size_t smem_bytes(int n, int resident) {
  return (size_t)n * (8 + 4 + 4 + 4) + (resident ? (size_t)n * n * 4 : 0);
}

}  // namespace

extern "C" {

// benefit: (n, n) f32 = -cost; eps0, eps_final: one f32 each, on the device.
// perm: (n,) int32 out, the column of each row (n for a row left unowned at
// the round cap); rounds: one int32 out. Returns 0 or the CUDA error code.
int auction_solve(const float* benefit, const float* eps0, const float* eps_final,
                  int* perm, int* rounds, int n, void* stream) {
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  const int resident = smem_bytes(n, 1) <= (size_t)optin ? 1 : 0;
  const size_t smem = smem_bytes(n, resident);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  auction_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      benefit, eps0, eps_final, perm, rounds, n, resident);
  return (int)cudaGetLastError();
}

}  // extern "C"
