// Forward of the UNet AttentionBlock on Hopper (sm_90a):
//   y = x + OutProj(MHA(QKVProj(GroupNorm(x))))
//
// Replaces the TPU kernel cfm_tpu/ops/pallas_attn_block.py:_fwd_kernel
// (launched by _fwd_impl). It computes the same function with the same
// rounding points as that kernel, which its plain PyTorch version
// (cfm_tpu_torch/ops/attn_block.py:attention_block_reference) spells out:
//   - GroupNorm statistics in f32, two passes (mean, then centred variance);
//   - tokens rounded to the model dtype T;
//   - qkv = round_T(tokens_T @ round_T(wq), f32 accumulate) + round_T(bq),
//     the add done in f32 and rounded to T;
//   - per head: logits in f32 times 1/sqrt(D), softmax in f32 as e / sum(e),
//     the weights rounded to T, then w @ v accumulated in f32;
//   - the concatenated context rounded to T;
//   - y = T(x + (ctx_T @ round_T(wo) + bo)), all in f32 before the cast.
// T is float or __nv_bfloat16. Products of T values are exact in f32, so an
// f32 FMA on rounded operands is the TPU's "T inputs, f32 accumulate".
//
// What bounds it on this card. Per batch item at the CIFAR-10 recipe shape
// (S=256, C=256, H=4, D=64) the work is ~201 MFLOP against 256 KB of x and y
// in bf16: ~800 FLOP per byte, far above the H100's ~295 FLOP/byte ridge, so
// the bound is arithmetic (tensor-core peak). One item does not fit one SM
// the way it fits the TPU's VMEM (x is 128 KB in bf16, wq 384 KB, against
// 227 KB of shared memory), so the TPU kernel's "whole item resident" plan
// is not carried over. The design is a chain of kernels on one stream, each
// tiled for shared memory. bf16 (the paths' dtype), five launches a call:
//   (a) GroupNorm: the strip kernel of #8 (gn_strip.cuh) with this block's
//       epilogue: a strip of whole groups read once by TMA into shared
//       memory (a cluster splitting its rows where one block cannot hold
//       it), the two-pass statistics on chip, then the tokens
//       round_T((((x - mean) * rstd) * gscale) + gbias), each step rounded
//       as the TPU kernel rounds, written once as a bf16 (N, S, C) buffer
//       (the context's scratch, free until stage (c)). Writing them costs
//       2 N S C bytes each way (0.04 ms at 3.35 TB/s at N = 512) and lets
//       stage (b) load its A tiles by TMA; forming them in registers as
//       wgmma's A operand would repeat the GroupNorm for each of the
//       3HD / 128 column tiles.
//   (w) the weights rounded to bf16 as they lie, wq and wo in one launch:
//       wgmma reads a (K, N) row-major weight tile MN-major, so nothing is
//       transposed;
//   (b) qkv GEMM: TMA + wgmma (tma_gemm_kernel below), the bias epilogue
//       qkv = T(round_T(acc) + round_T(bq)), written (N, S, 3HD);
//   (c) attention: kernel #3's attention_resident (S <= 256) or
//       attention_streamed (sm90_attention_fwd.cuh) through BlockLayout:
//       rank-3 tensor maps over (N, S, 3HD) and (N, S, HD), so a ragged S
//       loads zeros past an item's rows, masks those keys and stores no
//       row past S. Their softmax is exp2 of the logits scaled by
//       scale * log2 e, times the correctly rounded reciprocal of the sum:
//       a bf16 weight differs from e / sum(e)'s only at a rounding tie
//       (tests/test_torch_attn_block.py counts them). Head dims other than
//       64 and 128 run the FMA attention kernel (attn_block_common.cuh);
//   (d) out GEMM: the same kernel with y = T(x + (acc + bo)).
// float32 keeps the FMA path (a tensor core would make the products TF32):
// gn_stats, the tiled FMA GEMM with GroupNorm applied on load, the FMA
// attention kernel, the FMA out GEMM (attn_block_common.cuh).
//
// The GEMM (M x Nc = A (M x K) B (K x Nc), bf16, f32 accumulate): a block
// computes 128 x 128 with two consumer warpgroups (64 rows each, wgmma
// m64n128k16 over B's two 64-column panels) and one producer warp that
// keeps a ring of three 64-deep K stages full by TMA (128-byte swizzle; A
// read K-major, B MN-major), full and empty mbarriers between them. Two
// m64n64 products instead of one m64n128, or one group of products kept in
// flight while the next stage is waited for, measured no faster on an H100
// (PERF.md). The epilogue rounds into the warpgroup's own A panels of
// stages 0 and 1, which no one reads any more, and stores them by TMA. Two
// blocks an SM. The column tiles of a row tile are neighbours in the grid,
// so they run together and A comes from device memory once (ordered the
// other way, A was read again for each column tile).

#include "attn_block_common.cuh"
#include "gn_strip.cuh"
#include "sm90_attention_fwd.cuh"

namespace {

// Stage (c)'s rows in the (N, S, 3HD) qkv buffer and the (N, S, HD) context,
// for the FMA attention kernel.
AttnLayout block_layout(int S, int H, int D) {
  const int HD = H * D;
  return AttnLayout{S * 3 * HD, D, HD, 3 * HD, S * HD, D, HD};
}

// (a)'s epilogue: the tokens, rounded as GnTokens rounds them.
struct TokensOut {
  bf16* out;
  const float* scale;
  const float* bias;
  __device__ void stats(size_t, float, float) const {}
  __device__ static float apply(float x, float mu, float inv, float sc, float bi) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), inv), sc), bi);
  }
};

// (w): wq (C x 3HD) then wo (HD x C), f32, rounded into wb as they lie.
__global__ void round_weights_kernel(const float4* __restrict__ wq, const float4* __restrict__ wo,
                                     uint2* __restrict__ wb, int nq, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float4 v = i < nq ? wq[i] : wo[i - nq];
    wb[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// (b) epilogue: qkv = T(round_T(acc) + round_T(bq)).
struct QkvEpi {
  const float* bq;
  __device__ float2 operator()(float a0, float a1, int, int n) const {
    return make_float2(sm90::round_bf16(a0) + sm90::round_bf16(bq[n]),
                       sm90::round_bf16(a1) + sm90::round_bf16(bq[n + 1]));
  }
};

// (d) epilogue: y = T(x + (acc + bo)).
struct ResidualEpi {
  const bf16* x;
  const float* bo;
  int ld, M;
  __device__ float2 operator()(float a0, float a1, int m, int n) const {
    if (m >= M) return make_float2(0.f, 0.f);
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (size_t)m * ld + n));
    return make_float2(xv.x + (a0 + bo[n]), xv.y + (a1 + bo[n + 1]));
  }
};

constexpr int kStages = 3;
constexpr int kGemmThreads = 288;  // two consumer warpgroups, one producer warp
constexpr int kStageElems = 4 * sm90::kPanelElems;  // A: 128 rows x 64; B: 64 x 128
constexpr size_t kGemmSmem = 1024 + kStages * 4 * sm90::kPanelBytes + 2 * kStages * sizeof(uint64_t);

template <class Epi>
__global__ void __launch_bounds__(kGemmThreads, 2)
tma_gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            const __grid_constant__ CUtensorMap out_map, const Epi epi, int K) {
  extern __shared__ uint8_t smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(sm90::align_1024(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageElems);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128, KT = K / 64;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (warp == 8) {  // the producer
    if ((tid & 31) == 0)
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) sm90::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        bf16* st = ring + s * kStageElems;
        sm90::mbar_expect_tx(&full[s], 4 * sm90::kPanelBytes);
        sm90::tma_load(st, &a_map, &full[s], 64 * kt, m0);
        sm90::tma_load(st + sm90::kPanelElems, &a_map, &full[s], 64 * kt, m0 + 64);
        sm90::tma_load(st + 2 * sm90::kPanelElems, &b_map, &full[s], n0, 64 * kt);
        sm90::tma_load(st + 3 * sm90::kPanelElems, &b_map, &full[s], n0 + 64, 64 * kt);
      }
    return;
  }
  const int wg = warp >> 2;  // rows m0 + 64 wg .. + 63
  float acc[64];
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    sm90::mbar_wait(&full[s], (kt / kStages) & 1);
    const bf16* A = ring + s * kStageElems + wg * sm90::kPanelElems;
    const bf16* B = ring + s * kStageElems + 2 * sm90::kPanelElems;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::mma_ss_mn128(acc, sm90::desc_k(A, kk), sm90::desc_mn(B, kk, 0), kt > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::mbar_arrive(&empty[s]);
  }
  sm90::fence_regs(acc);
  // Epilogue: panel p into this warpgroup's A panel of stage p.
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, wrow = 16 * (warp & 3) + g;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    bf16* tile = ring + p * kStageElems + wg * sm90::kPanelElems;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = wrow + 8 * sm90::half_of(i), c = sm90::col_of(i, t);
      const float2 v = epi(acc[32 * p + i], acc[32 * p + i + 1], m0 + 64 * wg + r, n0 + 64 * p + c);
      *reinterpret_cast<uint32_t*>(tile + sm90::swizzled(r, c)) = sm90::pack2(v.x, v.y);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if ((tid & 127) == 0) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
      sm90::tma_store(&out_map, ring + p * kStageElems + wg * sm90::kPanelElems, n0 + 64 * p,
                      m0 + 64 * wg);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// out (M x Nc) = A (M x K) B (K x Nc), all bf16 row-major; Nc a multiple of
// 128, K of 64.
template <class Epi>
int tma_gemm(const bf16* a, const bf16* b, bf16* out, int M, int Nc, int K, const Epi& epi,
         cudaStream_t st) {
  CUtensorMap a_map, b_map, out_map;
  if (int err = sm90::make_tile_map(&a_map, a, K, M)) return err;
  if (int err = sm90::make_tile_map(&b_map, b, Nc, K)) return err;
  if (int err = sm90::make_tile_map(&out_map, out, Nc, M)) return err;
  if (int err = sm90::set_smem(tma_gemm_kernel<Epi>, kGemmSmem)) return err;
  tma_gemm_kernel<Epi><<<dim3(Nc / 128, (M + 127) / 128), kGemmThreads, kGemmSmem, st>>>(
      a_map, b_map, out_map, epi, K);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* x, const float* gscale, const float* gbias, const float* wq,
                const float* bq, const float* wo, const float* bo, bf16* y, bf16* qkv, bf16* ctx,
                bf16* wb, int N, int S, int C, int H, int G, float scale,
                const gnstrip::Plan& plan, cudaStream_t stream) {
  const int D = C / H, HD = H * D, M = N * S;
  if (C % 128 || D % 64) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (int e = gnstrip::launch<bf16>(x, TokensOut{ctx, gscale, gbias}, N, S, C, G, plan, 1e-5f,
                                    stream))
    return e;
  const int nq = C * 3 * HD / 4, n = nq + HD * C / 4;
  round_weights_kernel<<<n < 262144 ? (n + 255) / 256 : 1024, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(wq), reinterpret_cast<const float4*>(wo),
      reinterpret_cast<uint2*>(wb), nq, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bf16* wqb = wb;
  bf16* wob = wb + (size_t)C * 3 * HD;
  if (int e = tma_gemm(ctx, wqb, qkv, M, 3 * HD, C, QkvEpi{bq}, stream)) return e;
  if (D == 64 || D == 128) {
    CUtensorMap qkv_map, ctx_map;
    if (int e = sm90::make_item_map(&qkv_map, qkv, 3 * HD, S, N)) return e;
    if (int e = sm90::make_item_map(&ctx_map, ctx, HD, S, N)) return e;
    const sm90::BlockLayout lay{H, S};
    if (int e = D == 64 ? sm90::launch_tensor_core<64>(qkv_map, ctx_map, lay, N, scale, stream)
                        : sm90::launch_tensor_core<128>(qkv_map, ctx_map, lay, N, scale, stream))
      return e;
  } else if (int e = launch_attention<bf16>(qkv, ctx, block_layout(S, H, D), N, S, H, D, scale,
                                            stream)) {
    return e;
  }
  return tma_gemm(ctx, wob, y, M, C, HD, ResidualEpi{x, bo, C, M}, stream);
}

int launch_f32(const float* x, const float* gscale, const float* gbias, const float* wq,
               const float* bq, const float* wo, const float* bo, float* y, const float* mean,
               const float* rstd, float* qkv, float* ctx, int N, int S, int C, int H, int G,
               float scale, cudaStream_t stream) {
  const int D = C / H, HD = H * D, M = N * S;
  cudaError_t err;
  gemm_kernel<<<dim3((M + BM - 1) / BM, (3 * HD + BN - 1) / BN), kThreads, 0, stream>>>(
      M, 3 * HD, C, GnTokens<float>{x, mean, rstd, gscale, gbias, S, C, G, C / G},
      RoundedWeight<float>{wq, 3 * HD}, QkvOut<float>{qkv, bq, 3 * HD});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = (cudaError_t)launch_attention<float>(qkv, ctx, block_layout(S, H, D), N, S, H, D,
                                                  scale, stream)))
    return (int)err;
  gemm_kernel<<<dim3((M + BM - 1) / BM, (C + BN - 1) / BN), kThreads, 0, stream>>>(
      M, C, HD, Rows<float>{ctx, HD}, RoundedWeight<float>{wo, C},
      ResidualOut<float>{x, y, bo, C});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the attention stage needs (0 = float32, 1 = bfloat16); the
// wrapper refuses shapes above the card's per-block limit before launching.
size_t attn_block_fwd_smem(int S, int D, int dtype) {
  if (dtype == 1 && D == 64) return sm90::tensor_core_smem<64>(S);
  if (dtype == 1 && D == 128) return sm90::tensor_core_smem<128>(S);
  return attention_smem(S, D);
}

// x, y: (N, S, C) in the model dtype (0 = float32, 1 = bfloat16), contiguous
// and 16-byte aligned. gscale, gbias, bo: (C,) f32; wq: (C, 3HD) f32; bq:
// (3HD,) f32; wo: (HD, C) f32, wq and wo 16-byte aligned. Scratch: qkv
// N*S*3HD and ctx N*S*HD in the model dtype; for float32 stats 2*N*G f32,
// for bfloat16 wb 4*C*C bf16 (the rounded weights) and the GroupNorm plan
// (width, cluster, items, rows, box_rows, boxes) of strip_plan. Returns 0 or
// the first CUDA error code.
int attn_block_fwd(const void* x, const float* gscale, const float* gbias, const float* wq,
                   const float* bq, const float* wo, const float* bo, void* y, float* stats,
                   void* qkv, void* ctx, void* wb, int N, int S, int C, int H, int G, float scale,
                   int dtype, int width, int cluster, int items, int rows, int box_rows,
                   int boxes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    float* mean = stats;
    float* rstd = stats + (size_t)N * G;
    gn_stats_kernel<float><<<N * G, kThreads, 0, st>>>(static_cast<const float*>(x), mean, rstd,
                                                       S, C, G, 1e-5f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_f32(static_cast<const float*>(x), gscale, gbias, wq, bq, wo, bo,
                      static_cast<float*>(y), mean, rstd, static_cast<float*>(qkv),
                      static_cast<float*>(ctx), N, S, C, H, G, scale, st);
  }
  if (dtype == 1)
    return launch_bf16(static_cast<const bf16*>(x), gscale, gbias, wq, bq, wo, bo,
                       static_cast<bf16*>(y), static_cast<bf16*>(qkv), static_cast<bf16*>(ctx),
                       static_cast<bf16*>(wb), N, S, C, H, G, scale,
                       gnstrip::Plan{width, cluster, items, rows, box_rows, boxes}, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
