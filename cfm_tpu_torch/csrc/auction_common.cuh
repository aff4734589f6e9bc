// Pieces shared by the two auction kernels (auction.cu, auction_tiled.cu):
// the TPU kernels' "no bid" value, the one-pass (best, first column, second)
// scan of a bidding row, the bid arithmetic in the TPU's order of rounding,
// and the packed 64-bit bid word whose atomicMax picks each column's winner.
//
// A bidding row packs (order-preserving bits of its bid) << 32 | ~row and
// applies atomicMax on its column's word. The maximum is the highest bid
// and, among equal bids, the smallest row: the TPU kernels' first-row rule
// (first tile, then first row within it), whatever order the atomics land
// in. A zero bid is made +0 first, so -0 and +0 pack equal as they compare.
// A packed word is never 0 for a finite bid, so 0 marks a column without bids.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace auction {

constexpr float kNeg = -3.0e38f;  // the TPU kernels' "no bid" value

// Fold value v of column j into a lane's (best, first column, second).
// Columns arrive in increasing order, so a later equal value is not first
// and becomes the second (second == best on a tie).
__device__ __forceinline__ void fold(float v, int j, float& v1, int& j1, float& v2) {
  if (v > v1) {
    v2 = fmaxf(v2, v1);
    v1 = v;
    j1 = j;
  } else {
    v2 = fmaxf(v2, v);
  }
}

// Merge the lanes' (best, first column, second) across the warp: the larger
// best wins, the smaller column on a tie, and the loser's best joins the
// second. The same in every lane on return.
__device__ __forceinline__ void warp_merge(float& v1, int& j1, float& v2) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov1 = __shfl_xor_sync(0xffffffffu, v1, o);
    const int oj1 = __shfl_xor_sync(0xffffffffu, j1, o);
    const float ov2 = __shfl_xor_sync(0xffffffffu, v2, o);
    if (ov1 > v1 || (ov1 == v1 && oj1 < j1)) {
      v2 = fmaxf(ov2, v1);
      v1 = ov1;
      j1 = oj1;
    } else {
      v2 = fmaxf(v2, ov1);
    }
  }
}

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// bid = (price[best] + (best - second)) + eps, rounded at each step as the
// TPU adds (no fused or reassociated arithmetic).
__device__ __forceinline__ float bid_value(float best_price, float v1, float v2, float eps) {
  float bid = __fadd_rn(__fadd_rn(best_price, __fsub_rn(v1, v2)), eps);
  if (bid == 0.f) bid = 0.f;  // -0 -> +0: equal bids must pack equal
  return bid;
}

__device__ __forceinline__ unsigned long long pack_bid(float bid, int row) {
  return ((unsigned long long)order_bits(bid) << 32) | (unsigned long long)(~(uint32_t)row);
}

__device__ __forceinline__ int packed_row(unsigned long long w) {
  return (int)(~(uint32_t)(w & 0xffffffffull));
}

__device__ __forceinline__ float packed_bid(unsigned long long w) {
  return from_order_bits((uint32_t)(w >> 32));
}

}  // namespace auction
