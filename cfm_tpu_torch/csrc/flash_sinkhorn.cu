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
// Design. The TPU kernel runs one program that loops over (Ti, Tj) tiles in
// VMEM. Here every pass is spread over the whole card: one warp owns one row
// (a row of x in the f and error passes, a row of y in the g pass) and its 32
// lanes stride over the other cloud's points, each keeping an online
// logsumexp (running max from -3e38, as the TPU kernel's _NEG, and a running
// sum), merged across the warp by shuffles at the end of the row. The other
// cloud is read transposed (d, m) so that neighbouring lanes read
// neighbouring addresses; the clouds and their squared norms are read-only
// (__ldg), the potentials are rewritten every pass and read through L2
// (__ldcg). Passes are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()), so the grid is sized from the
// occupancy query and launched with cudaLaunchCooperativeKernel: every block
// is resident. The error pass writes each row's |row sum - a_i| to a scratch
// vector; after the barrier every block sums it in the same fixed order
// (strided partials, then a shared-memory tree), so all blocks reach the
// same err, take the same stop decision and reruns are bit-identical. The
// loop never reads anything back to the host; the iteration count is left on
// the device.
//
// Scope. Any n, m >= 1 and d >= 1 with n*d, m*d < 2^31; no cloud is kept in
// shared memory, so there is no point budget of the kernel's own (routing
// keeps the TPU kernel's 4*d*(n+m) <= 8 MiB). d = 2, the 2-D path's, keeps the
// row's coordinates in registers; other d loop over the coordinates.
//
// What bounds it. Per iteration 3 n m entries, each d FMAs for the dot
// product, a few adds and multiplies and one exp: operations on the f32
// pipes (and the exp on the special-function unit), not bytes (the clouds
// are kilobytes and L2-resident). At n = m = 2048 one pass is 4M entries
// over ~2k warps, so the three grid barriers per iteration are a large part
// of the time. A simple kernel first: fusing the error pass into the next f
// pass (they share the same LSE), tensor-core dot products for large d and
// fewer barriers are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct Cloud {
  const float* rows;     // (nrows, d): the points whose LSE is taken
  const float* colsT;    // (d, ncols): the other cloud, transposed
  const float* sq_rows;  // (nrows,)
  const float* sq_cols;  // (ncols,)
  int ncols;
};

// LSE over the columns of (pot_j - c_ij) * inv_reg for row i, on one warp;
// every lane returns the same value.
template <int D>
__device__ __forceinline__ float row_lse(const Cloud& c, const float* pot, int i, int d,
                                         float inv_reg, int lane) {
  float xr[D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = __ldg(c.rows + (size_t)i * D + k);
  }
  const float sx = __ldg(c.sq_rows + i);
  float mx = kNeg, s = 0.f;
  for (int j = lane; j < c.ncols; j += 32) {
    float dot = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) dot = fmaf(xr[k], __ldg(c.colsT + (size_t)k * c.ncols + j), dot);
    } else {
      for (int k = 0; k < d; ++k)
        dot = fmaf(__ldg(c.rows + (size_t)i * d + k), __ldg(c.colsT + (size_t)k * c.ncols + j),
                   dot);
    }
    const float cost = (sx + __ldg(c.sq_cols + j)) - 2.f * dot;
    const float z = (__ldcg(pot + j) - cost) * inv_reg;
    if (z > mx) {
      s = s * __expf(mx - z) + 1.f;
      mx = z;
    } else {
      s += __expf(z - mx);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float om = __shfl_xor_sync(kFull, mx, off);
    const float os = __shfl_xor_sync(kFull, s, off);
    const float nm = fmaxf(mx, om);
    s = s * __expf(mx - nm) + os * __expf(om - nm);
    mx = nm;
  }
  return mx + logf(s);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_sinkhorn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ xT, const float* __restrict__ yT,
                      const float* __restrict__ sqx, const float* __restrict__ sqy,
                      const float* __restrict__ loga, const float* __restrict__ logb,
                      const float* __restrict__ scal, float* f, float* g, float* rowerr,
                      int* __restrict__ iters_out, int n, int m, int d, int num_iters) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[kThreads];
  const float reg = scal[0], tol = scal[1], inv_reg = 1.f / reg;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gthread = blockIdx.x * kThreads + tid, nthreads = gridDim.x * kThreads;
  const int gwarp = blockIdx.x * kWarps + (tid >> 5), nwarps = gridDim.x * kWarps;
  const Cloud rows_x{x, yT, sqx, sqy, m};  // rows of x against the columns of y
  const Cloud rows_y{y, xT, sqy, sqx, n};  // rows of y against the columns of x

  for (int i = gthread; i < n; i += nthreads) f[i] = 0.f;
  for (int j = gthread; j < m; j += nthreads) g[j] = 0.f;
  grid.sync();

  int it = 0;
  while (it < num_iters) {
    for (int i = gwarp; i < n; i += nwarps) {  // f from the old g
      const float lse = row_lse<D>(rows_x, g, i, d, inv_reg, lane);
      if (lane == 0) f[i] = reg * (__ldg(loga + i) - lse);
    }
    grid.sync();
    for (int j = gwarp; j < m; j += nwarps) {  // g from the new f
      const float lse = row_lse<D>(rows_y, f, j, d, inv_reg, lane);
      if (lane == 0) g[j] = reg * (__ldg(logb + j) - lse);
    }
    grid.sync();
    for (int i = gwarp; i < n; i += nwarps) {  // the implied plan's row error
      const float lse = row_lse<D>(rows_x, g, i, d, inv_reg, lane) + __ldcg(f + i) * inv_reg;
      if (lane == 0) rowerr[i] = fabsf(expf(lse) - expf(__ldg(loga + i)));
    }
    grid.sync();
    ++it;
    // Every block sums the row errors in the same fixed order.
    float part = 0.f;
    for (int i = tid; i < n; i += kThreads) part += __ldcg(rowerr + i);
    red[tid] = part;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    const float err = red[0];
    __syncthreads();
    if (!(err > tol)) break;
  }
  if (blockIdx.x == 0 && tid == 0) *iters_out = it;
}

template <int D>
cudaError_t launch(void** args, int n, int m, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&flash_sinkhorn_kernel<D>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_sinkhorn_kernel<D>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const int rows = n > m ? n : m;
  const int wanted = (rows + kWarps - 1) / kWarps;
  int blocks = per_sm * sms;
  if (blocks > wanted) blocks = wanted;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Potentials f (n,), g (m,) and the iteration count (iters[0]) of the
// entropic OT between the centred clouds; scal = {reg, tol} on the device;
// rowerr (n,) is scratch. Returns a CUDA error code (0 on success).
extern "C" int flash_sinkhorn_solve(const float* x, const float* y, const float* xT,
                                    const float* yT, const float* sqx, const float* sqy,
                                    const float* loga, const float* logb, const float* scal,
                                    float* f, float* g, float* rowerr, int* iters, int n, int m,
                                    int d, int num_iters, cudaStream_t stream) {
  void* args[] = {(void*)&x,    (void*)&y,    (void*)&xT,     (void*)&yT,    (void*)&sqx,
                  (void*)&sqy,  (void*)&loga, (void*)&logb,   (void*)&scal,  (void*)&f,
                  (void*)&g,    (void*)&rowerr, (void*)&iters, (void*)&n,    (void*)&m,
                  (void*)&d,    (void*)&num_iters};
  const cudaError_t err = d == 2 ? launch<2>(args, n, m, stream) : launch<0>(args, n, m, stream);
  return static_cast<int>(err);
}
