// Flash Sinkhorn on Hopper (sm_90a): log-domain entropic-OT potentials for the
// squared-Euclidean cost, with the whole iteration loop in one persistent
// cooperative launch.
//
// Replaces the TPU kernel cfm_tpu/ops/flash_sinkhorn.py:_flash_sinkhorn_pallas
// (body _flash_kernel). Its plain PyTorch version is
// cfm_tpu_torch/ops/flash_sinkhorn.py:flash_sinkhorn_reference. Given centred
// f32 clouds x (n, d) and y (m, d), log-marginals loga, logb, and reg, tol as
// device scalars:
//   f, g = 0; it = 0
//   while it < num_iters:
//     f_i = reg * (loga_i - LSE_j((g_j - c_ij) / reg))      (the f pass)
//     g_j = reg * (logb_j - LSE_i((f_i - c_ij) / reg))      (the g pass, new f)
//     err = sum_i |exp(LSE_j((g_j - c_ij) / reg) + f_i / reg) - exp(loga_i)|
//     it += 1; stop if !(err > tol)                         (NaN stops too)
// with c_ij = (|x_i|^2 + |y_j|^2) - 2 x_i.y_j built in registers, never
// stored: the (n, m) cost and plan never exist in memory.
//
// Two passes and two grid barriers an iteration. The error of iteration t
// and the f pass of iteration t + 1 take the same LSE (rows of x against the
// same g), so one fused pass computes both: each row's error against the f of
// the last f pass, and the next f, into a second buffer. After the barrier
// every block sums the blocks' error partials in one fixed order, so all of
// them take the same stop decision and a rerun repeats the bits; on a stop
// the last f stands (the TPU kernel's result), else the buffers swap. At the
// iteration cap the last iteration runs no error pass. So a solve is one
// f pass, then per iteration a g pass and (but for the last) a fused pass.
//
// Design. A block takes tiles of 4 rows: 2 rows a thread, 2 row groups of 4
// warps, the 128 threads of a group striding over the other cloud's points,
// so each point read feeds 2 independent online LSEs. A thread takes 8
// points at a time, updates its running maxima once for them, then takes 16
// independent exps; the running max starts at -3e38, the TPU kernel's _NEG.
// The logits stay in natural units, (pot - c) * (1 / reg) as the plain
// version rounds them: folding log2 e into the scale (one multiply less an
// entry) moved the tol-1e-6 stop at (1000, 1536, reg 0.5) two iterations
// from the plain version's, where the row error's f32 noise decides it.
// Lanes, then the group's warps, merge (max, sum) pairs in a fixed order.
//   - At d = 2 with both clouds within 110 KB of shared memory (2048 + 2048
//     points take 64 KB) each block stages both clouds with their squared
//     norms once, as float4 (x0, x1, |x|^2, 0). The potentials, rewritten
//     every pass by every block, are read from L2 in the inner loop
//     (__ldcg), their latency hidden behind the other warps' arithmetic:
//     staging each into shared memory after its barrier by a 1-D bulk
//     asynchronous copy (TMA cp.async.bulk on an mbarrier) put the copy's
//     latency on the critical path twice an iteration and ran 13-25% slower
//     (PERF.md).
//   - Otherwise the other cloud is tiled: each tile of its points (their
//     coordinates, norms and potentials) is staged in shared memory by the
//     block's threads; any d, with the coordinates left in global memory
//     where d is too large for a tile of 32 points. At d != 2 the squared
//     norms come from the wrapper, rounded as the plain version rounds them:
//     the stop at tol 1e-6 hangs on the row error's f32 noise, which a norm
//     one ulp off moves (at d = 2 the kernel's own norms are the same bits).
//
// What bounds it. Per iteration 2 n m entries, each d FMAs for the dot
// product, a few adds and one exp (the special-function unit's 16 a clock
// and SM against 128 f32 lanes): arithmetic, not bytes. At n = m = 2048 a
// pass is 4M entries spread over the card's 264 resident blocks, a few
// microseconds, so the two grid barriers and the row merges are a large
// part of an iteration.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int R = 2;                    // rows a thread (faster than 4 at the path's shape)
constexpr int kGroups = 2;              // row groups of a block
constexpr int kGroupWarps = kWarps / kGroups;
constexpr int RB = R * kGroups;         // rows of a tile
constexpr int CS = kThreads / kGroups;  // column slots of a row group
constexpr int CH = 8;                   // points a thread takes per running-max update
constexpr int kMaxBlocks = 2048;        // room for the error partials
constexpr float kNeg = -3.0e38f;
constexpr size_t kResidentBytes = 110 * 1024;
constexpr size_t kTileBytes = 96 * 1024;

struct Params {
  const float* x;      // (n, d)
  const float* y;      // (m, d)
  const float* loga;   // (n,)
  const float* logb;   // (m,)
  const float* sqx;    // d != 2: (n,) squared norms, as the plain version rounds them
  const float* sqy;    // d != 2: (m,)
  const float* scal;   // {reg, tol}
  float* f;            // (n,) out
  float* f2;           // (n,) the second f buffer
  float* g;            // (m,) out
  float* partial;      // (kMaxBlocks,) the blocks' error partials
  int* iters;          // (1,) out
  int n, m, d, num_iters;
  int resident;        // d = 2: both clouds staged once
  int tj;              // points of a tile of the other cloud (tiled mode)
  int coords_smem;     // d != 2: a tile's coordinates in shared memory
};

// One side of a pass: the rows whose LSE is taken, the columns it runs over.
struct Side {
  const float* pts;    // (count, d) in global memory
  const float* sq;     // d != 2: (count,) squared norms in global memory
  const float4* cloud; // d = 2, resident: (count,) (p0, p1, |p|^2, 0) in shared memory
  const float* pot;    // the potential in global memory (read as columns)
  const float* logm;   // log-marginal (read as rows)
  int count;
};

__device__ __forceinline__ float sqnorm2(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

// Merge (m2, s2) into (m, s): running max and sum.
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float nm = fmaxf(m, m2);
  s = s * __expf(m - nm) + s2 * __expf(m2 - nm);
  m = nm;
}

// Fold a chunk of CH logits of each of the thread's rows: one update of the
// running max, then CH independent exps.
__device__ __forceinline__ void fold_chunk(float (&z)[R][CH], float (&mr)[R], float (&sr)[R]) {
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    float cm = z[rr][0];
#pragma unroll
    for (int c = 1; c < CH; ++c) cm = fmaxf(cm, z[rr][c]);
    const float nm = fmaxf(mr[rr], cm);
    float acc = sr[rr] * __expf(mr[rr] - nm);
#pragma unroll
    for (int c = 0; c < CH; ++c) acc += __expf(z[rr][c] - nm);
    sr[rr] = acc;
    mr[rr] = nm;
  }
}

// Columns [0, jn) of a d = 2 cloud held as float4 in shared memory, their
// potential read through ``pot_at``.
template <typename Pot>
__device__ __forceinline__ void columns2(const float4* col, Pot pot_at, int jn, int cs,
                                         const float (&x0)[R], const float (&x1)[R],
                                         const float (&sx)[R], float inv_reg, float (&mr)[R],
                                         float (&sr)[R]) {
  for (int q0 = cs; q0 < jn; q0 += CS * CH) {
    float z[R][CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = q0 + CS * c;
      if (j < jn) {
        const float4 v = col[j];
        const float pj = pot_at(j);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float dot = fmaf(x1[rr], v.y, __fmul_rn(x0[rr], v.x));
          const float cost = __fsub_rn(__fadd_rn(sx[rr], v.z), 2.f * dot);
          z[rr][c] = __fmul_rn(__fsub_rn(pj, cost), inv_reg);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) z[rr][c] = -INFINITY;
      }
    }
    fold_chunk(z, mr, sr);
  }
}

// Columns [0, jn) of a tile at any d: coordinate k of point j at
// coords[k * ck + j * cj], row rr's coordinates at xr[rr][k].
__device__ __forceinline__ void columns_d(const float* coords, int ck, int cj, const float* sq,
                                          const float* pot, int jn, int d, int cs,
                                          const float* const (&xr)[R], const float (&sx)[R],
                                          float inv_reg,
                                          float (&mr)[R], float (&sr)[R]) {
  for (int q0 = cs; q0 < jn; q0 += CS * CH) {
    float z[R][CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = q0 + CS * c;
      if (j < jn) {
        float dot[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) dot[rr] = 0.f;
        for (int k = 0; k < d; ++k) {
          const float yk = coords[(size_t)k * ck + (size_t)j * cj];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) dot[rr] = fmaf(xr[rr][k], yk, dot[rr]);
        }
        const float sy = sq[j], pj = pot[j];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float cost = __fsub_rn(__fadd_rn(sx[rr], sy), 2.f * dot[rr]);
          z[rr][c] = __fmul_rn(__fsub_rn(pj, cost), inv_reg);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) z[rr][c] = -INFINITY;
      }
    }
    fold_chunk(z, mr, sr);
  }
}

struct Smem {
  float4* tcol;      // d = 2 tiled: (tj,) staged points
  float* tcoords;    // d != 2 tiled: (d, tj) staged coordinates (coords_smem)
  float* tsq;        // d != 2 tiled: (tj,) squared norms
  float* tpot;       // tiled: (tj,) potentials
  float* rowbuf;     // d != 2: (RB, d) the tile's rows (coords_smem)
};

// One pass: for each row i of ``rows``, lse_i = LSE_j((pot_j - c_ij) / reg)
// over the points j of ``cols``; then out_i = reg * (logm_i - lse_i), and in
// the fused pass (f_old set) the row's error against f_old. Returns the
// block's error sum (fused pass; the same fixed order every run).
template <int D>
__device__ float lse_pass(const Params& p, const Side& rows, const Side& cols, const Smem& sm,
                          float* out, const float* f_old, float reg, float inv_reg) {
  __shared__ float red_m[kWarps][R], red_s[kWarps][R];
  __shared__ float errs[RB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp / kGroupWarps, cs = tid % CS;
  const int d = p.d, nr = rows.count, nc = cols.count;
  float blk_err = 0.f;
  for (int tile = blockIdx.x; tile * RB < nr; tile += gridDim.x) {
    const int i0 = tile * RB + group * R;  // this thread's first row
    float mr[R], sr[R], sx[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      mr[rr] = kNeg;
      sr[rr] = 0.f;
    }
    if constexpr (D == 2) {
      float x0[R], x1[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int i = min(i0 + rr, nr - 1);
        if (p.resident) {
          const float4 v = rows.cloud[i];
          x0[rr] = v.x;
          x1[rr] = v.y;
          sx[rr] = v.z;
        } else {
          x0[rr] = __ldg(rows.pts + 2 * i);
          x1[rr] = __ldg(rows.pts + 2 * i + 1);
          sx[rr] = sqnorm2(x0[rr], x1[rr]);
        }
      }
      if (p.resident) {
        const float* pot = cols.pot;  // written by every block: through L2
        columns2(cols.cloud, [pot](int j) { return __ldcg(pot + j); }, nc, cs, x0, x1, sx,
                 inv_reg, mr, sr);
      } else {
        for (int j0 = 0; j0 < nc; j0 += p.tj) {
          const int jn = min(p.tj, nc - j0);
          __syncthreads();  // the previous tile's readers are done
          for (int jj = tid; jj < jn; jj += kThreads) {
            const float a = __ldg(cols.pts + 2 * (j0 + jj));
            const float b = __ldg(cols.pts + 2 * (j0 + jj) + 1);
            sm.tcol[jj] = make_float4(a, b, sqnorm2(a, b), 0.f);
            sm.tpot[jj] = __ldcg(cols.pot + j0 + jj);
          }
          __syncthreads();
          const float* tpot = sm.tpot;
          columns2(sm.tcol, [tpot](int j) { return tpot[j]; }, jn, cs, x0, x1, sx, inv_reg,
                   mr, sr);
        }
      }
    } else {
      // The tile's rows: in shared memory when a tile fits, else in global memory.
      const float* xr[R];
      if (p.coords_smem) {
        __syncthreads();  // the previous tile's readers are done
        for (int e = tid; e < RB * d; e += kThreads) {
          const int i = tile * RB + e / d;
          sm.rowbuf[e] = i < nr ? __ldg(rows.pts + (size_t)i * d + e % d) : 0.f;
        }
        __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int i = min(i0 + rr, nr - 1);
        xr[rr] = p.coords_smem ? sm.rowbuf + (group * R + rr) * d : rows.pts + (size_t)i * d;
        sx[rr] = __ldg(rows.sq + i);
      }
      for (int j0 = 0; j0 < nc; j0 += p.tj) {
        const int jn = min(p.tj, nc - j0);
        const float* cpts = cols.pts + (size_t)j0 * d;
        __syncthreads();
        if (p.coords_smem)
          for (int e = tid; e < jn * d; e += kThreads)
            sm.tcoords[(e % d) * p.tj + e / d] = __ldg(cpts + e);
        for (int jj = tid; jj < jn; jj += kThreads) {
          sm.tpot[jj] = __ldcg(cols.pot + j0 + jj);
          sm.tsq[jj] = __ldg(cols.sq + j0 + jj);
        }
        __syncthreads();
        if (p.coords_smem)
          columns_d(sm.tcoords, p.tj, 1, sm.tsq, sm.tpot, jn, d, cs, xr, sx, inv_reg, mr, sr);
        else
          columns_d(cpts, 1, d, sm.tsq, sm.tpot, jn, d, cs, xr, sx, inv_reg, mr, sr);
      }
    }
    // Merge across the lanes, then across the group's warps in order.
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mr[rr], o);
        const float os = __shfl_xor_sync(0xffffffffu, sr[rr], o);
        merge(mr[rr], sr[rr], om, os);
      }
      if (lane == 0) {
        red_m[warp][rr] = mr[rr];
        red_s[warp][rr] = sr[rr];
      }
    }
    __syncthreads();
    if (tid < RB) {
      const int g = tid / R, rr = tid % R, i = tile * RB + tid;
      float m = red_m[g * kGroupWarps][rr], s = red_s[g * kGroupWarps][rr];
      for (int w = 1; w < kGroupWarps; ++w)
        merge(m, s, red_m[g * kGroupWarps + w][rr], red_s[g * kGroupWarps + w][rr]);
      float e = 0.f;
      if (i < nr) {
        const float lse = m + logf(s);
        const float lm = __ldg(rows.logm + i);
        out[i] = reg * (lm - lse);
        if (f_old) e = fabsf(expf(lse + __ldcg(f_old + i) * inv_reg) - expf(lm));
      }
      errs[tid] = e;
    }
    __syncthreads();
    if (f_old && tid == 0)
      for (int t = 0; t < RB; ++t) blk_err += errs[t];
  }
  return blk_err;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_sinkhorn_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_err;
  const float reg = p.scal[0], tol = p.scal[1], inv_reg = 1.f / reg;
  const int tid = threadIdx.x;
  const int gthread = blockIdx.x * kThreads + tid, nthreads = gridDim.x * kThreads;
  const int n = p.n, m = p.m;

  Side xs{p.x, p.sqx, nullptr, nullptr, p.loga, n};
  Side ys{p.y, p.sqy, nullptr, p.g, p.logb, m};
  Smem sm{};
  if (p.resident) {  // (n + m) float4 points
    float4* cx = reinterpret_cast<float4*>(smem_raw);
    float4* cy = cx + n;
    for (int i = tid; i < n; i += kThreads) {
      const float a = __ldg(p.x + 2 * i), b = __ldg(p.x + 2 * i + 1);
      cx[i] = make_float4(a, b, sqnorm2(a, b), 0.f);
    }
    for (int j = tid; j < m; j += kThreads) {
      const float a = __ldg(p.y + 2 * j), b = __ldg(p.y + 2 * j + 1);
      cy[j] = make_float4(a, b, sqnorm2(a, b), 0.f);
    }
    xs.cloud = cx;
    ys.cloud = cy;
  } else if (D == 2) {
    sm.tcol = reinterpret_cast<float4*>(smem_raw);
    sm.tpot = reinterpret_cast<float*>(sm.tcol + p.tj);
  } else {
    float* base = reinterpret_cast<float*>(smem_raw);
    sm.tsq = base;
    sm.tpot = base + p.tj;
    sm.tcoords = base + 2 * p.tj;
    sm.rowbuf = sm.tcoords + (size_t)p.d * p.tj;
  }
  if (p.num_iters <= 0) {
    for (int i = gthread; i < n; i += nthreads) p.f[i] = 0.f;
    for (int j = gthread; j < m; j += nthreads) p.g[j] = 0.f;
    if (gthread == 0) *p.iters = 0;
    return;
  }
  for (int j = gthread; j < m; j += nthreads) p.g[j] = 0.f;
  grid.sync();

  float* fcur = p.f;
  float* fnext = p.f2;
  xs.pot = fcur;
  lse_pass<D>(p, xs, ys, sm, fcur, nullptr, reg, inv_reg);  // f from g = 0
  grid.sync();
  int it = 0;
  while (true) {
    xs.pot = fcur;
    lse_pass<D>(p, ys, xs, sm, p.g, nullptr, reg, inv_reg);  // g from the new f
    grid.sync();
    ++it;
    if (it >= p.num_iters) break;  // the cap: no error pass
    // The row errors against f, and the next f, from one LSE a row.
    const float e = lse_pass<D>(p, xs, ys, sm, fnext, fcur, reg, inv_reg);
    if (tid == 0) p.partial[blockIdx.x] = e;
    grid.sync();
    if (tid < 32) {  // every block sums the partials in the same order
      float acc = 0.f;
      for (int b = tid; b < (int)gridDim.x; b += 32) acc += __ldcg(p.partial + b);
      for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (tid == 0) s_err = acc;
    }
    __syncthreads();
    const float err = s_err;
    if (!(err > tol)) break;  // f is the last f pass's, as the TPU kernel returns it
    float* t = fcur;
    fcur = fnext;
    fnext = t;
  }
  if (fcur != p.f)
    for (int i = gthread; i < n; i += nthreads) p.f[i] = __ldcg(fcur + i);
  if (gthread == 0) *p.iters = it;
}

template <int D>
cudaError_t launch(Params& p, cudaStream_t stream) {
  const auto kernel = flash_sinkhorn_kernel<D>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  size_t smem;
  const size_t resident = 16 * (size_t)(p.n + p.m);
  p.resident = D == 2 && resident <= kResidentBytes;
  p.coords_smem = 0;
  if (p.resident) {
    p.tj = 0;
    smem = resident;
  } else if (D == 2) {
    p.tj = 4096;
    smem = 20 * (size_t)p.tj;
  } else {
    // A tile of tj points: coordinates (when they fit), norms and potentials,
    // plus the row tile's coordinates.
    const size_t per_point = 4 * ((size_t)p.d + 2), rows = 4 * (size_t)RB * p.d;
    size_t tj = kTileBytes > rows ? (kTileBytes - rows) / per_point : 0;
    tj = tj > 1024 ? 1024 : tj / 32 * 32;
    if (tj >= 32) {
      p.coords_smem = 1;
      p.tj = (int)tj;
      smem = 8 * tj + 4 * (size_t)p.d * tj + rows;
    } else {
      p.tj = 1024;
      smem = 8 * (size_t)p.tj;
    }
  }
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  const int rows = p.n > p.m ? p.n : p.m;
  const int wanted = (rows + RB - 1) / RB;
  int blocks = per_sm * sms;
  if (blocks > wanted) blocks = wanted;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Potentials f (n,), g (m,) and the iteration count (iters[0]) of the
// entropic OT between the centred clouds x (n, d), y (m, d); sqx, sqy their
// squared norms (null at d = 2, where the kernel computes them); scal =
// {reg, tol} on the device. scratch: (n rounded up to 4) + 2048 f32, the second f
// buffer and the blocks' error partials. Returns a CUDA error code (0 on
// success).
extern "C" int flash_sinkhorn_solve(const float* x, const float* y, const float* loga,
                                    const float* logb, const float* sqx, const float* sqy,
                                    const float* scal, float* f, float* g,
                                    float* scratch, int* iters, int n, int m, int d,
                                    int num_iters, cudaStream_t stream) {
  if (n < 1 || m < 1 || d < 1 || (d != 2 && (!sqx || !sqy)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.y = y;
  p.loga = loga;
  p.logb = logb;
  p.sqx = sqx;
  p.sqy = sqy;
  p.scal = scal;
  p.f = f;
  p.f2 = scratch;
  p.g = g;
  p.partial = scratch + ((n + 3) & ~3);
  p.iters = iters;
  p.n = n;
  p.m = m;
  p.d = d;
  p.num_iters = num_iters;
  cudaError_t err;
  if (d != 2)
    err = launch<0>(p, stream);
  else
    err = launch<2>(p, stream);
  return static_cast<int>(err);
}
