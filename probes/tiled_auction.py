#!/usr/bin/env python3
"""Chip probe for the row-tiled auction (kernel #6): where a solve's time goes.

    python3 probes/tiled_auction.py          # one CUDA card
    python3 probes/tiled_auction.py --cpu    # the row-cache estimate only

On the card it builds, with ``ops/_build.py``'s flags, copies of
``cfm_tpu_torch/csrc/auction_tiled.cu`` that differ from it in one constant
(the n from which rounds of at most 32 candidates share the rows' columns,
``kShareN``; the cluster size of the wide rounds, ``kCluster``; the block
size, ``kThreads``), each also built with a histogram of every round's
``clock64`` cycles (thread 0, from the round's start to its end) by its
candidate count. Each copy must give the built kernel's permutation, round
count and row scans on the 2-D evaluation's W1 cost at n = 1024, 2048 and
4096 (``chip_smoke.eval_cost``); then all are timed in turns (CUDA events
around the solve) and their rounds and cycles printed by candidate bucket.
A microbenchmark times the steps a round chains: block barriers at 128-1024
threads, a named barrier, a dependent L2 load over a 16 MB chain, a
dependent shared load, a dependent shared 64-bit atomicMax and a shuffle.

On the CPU (``--cpu``, and also on the card) it runs the plain version at
n = 2048 on the CPU, records the rows that bid in each round, and prints the
share of row scans an LRU cache of the k most recent bidding rows would
have served.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "build", "probe_tiled_auction")
BUCKETS = (1, 4, 8, 16, 32, 128, 1 << 30)
LABELS = ("1", "2-4", "5-8", "9-16", "17-32", "33-128", "129+")

HIST = """
__device__ unsigned long long g_hist[16];
extern "C" int hist_get(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_hist, sizeof(g_hist));
}
extern "C" int hist_reset() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_hist, z, sizeof(z));
}
"""

MICRO = r"""
#include <cuda_runtime.h>
__global__ void k_sync(long long* out, int iters) {
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) out[0] = (clock64() - t0) / iters;
}
__global__ void k_named(long long* out, int iters, int count) {
  long long t0 = clock64();
  if ((int)threadIdx.x < count)
    for (int i = 0; i < iters; ++i) asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
  if (threadIdx.x == 0) out[0] = (clock64() - t0) / iters;
}
__global__ void k_l2(const int* __restrict__ next, long long* out, int iters) {
  if (threadIdx.x) return;
  int p = 0;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) p = __ldcg(next + p);
  out[0] = (clock64() - t0) / iters;
  out[1] = p;
}
__global__ void k_smem(long long* out, int iters) {
  __shared__ int s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = (i * 97 + 13) & 1023;
  __syncthreads();
  if (threadIdx.x) return;
  volatile int* vs = s;
  int p = 0;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) p = vs[p];
  out[0] = (clock64() - t0) / iters;
  out[1] = p;
}
__global__ void k_atomic(long long* out, int iters) {
  __shared__ unsigned long long w[64];
  if (threadIdx.x < 64) w[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x) return;
  unsigned long long v = 1;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) v = atomicMax(&w[v & 63], v + i) + 1;
  out[0] = (clock64() - t0) / iters;
  out[1] = (long long)v;
}
__global__ void k_shfl(long long* out, int iters) {
  float v = threadIdx.x;
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) v += __shfl_xor_sync(0xffffffffu, v, 1 + (i & 15));
  if (threadIdx.x == 0) { out[0] = (clock64() - t0) / iters; out[1] = (long long)v; }
}
extern "C" int micro(long long* out, const int* chain) {
  const int it = 4096;
  k_sync<<<1, 1024>>>(out + 0, it);
  k_sync<<<1, 512>>>(out + 2, it);
  k_sync<<<1, 256>>>(out + 4, it);
  k_sync<<<1, 128>>>(out + 6, it);
  k_named<<<1, 1024>>>(out + 8, it, 256);
  k_l2<<<1, 32>>>(chain, out + 10, 1 << 14);
  k_l2<<<1, 32>>>(chain, out + 10, 1 << 14);
  k_smem<<<1, 1024>>>(out + 12, it);
  k_atomic<<<1, 1024>>>(out + 14, it);
  k_shfl<<<1, 1024>>>(out + 16, it);
  return (int)cudaDeviceSynchronize();
}
"""
MICRO_NAMES = ("block barrier, 1024 threads", "block barrier, 512", "block barrier, 256",
               "block barrier, 128", "named barrier, 256 of 1024",
               "dependent L2 load (16 MB chain)", "dependent shared load",
               "dependent shared 64-bit atomicMax", "dependent shuffle + add")


def log(*a):
    print(*a, flush=True)


def instrument(src: str) -> str:
    """The kernel with each round's cycles added to g_hist by candidates."""
    src = src.replace("namespace {\n", HIST + "namespace {\n", 1)
    src = src.replace("const int ncur = s_cand[b];",
                      "const int ncur = s_cand[b]; const long long t0_ = clock64();", 1)
    bk = " : ".join(f"ncur <= {e} ? {i}" for i, e in enumerate(BUCKETS[:-1]))
    src = src.replace("    ++rounds;\n", "    if (tid == 0 && rank == 0) { const int bk = " + bk
                      + f" : {len(BUCKETS) - 1}; g_hist[2 * bk] += clock64() - t0_;"
                      " g_hist[2 * bk + 1] += 1; }\n    ++rounds;\n", 1)
    if src.count("g_hist[2 * bk]") != 1:
        raise RuntimeError("the kernel's round no longer has the anchors this probe edits")
    return src


def with_constant(src: str, name: str, value: int) -> str:
    old = next((l for l in src.splitlines() if l.startswith(f"constexpr int {name} = ")), None)
    if old is None:
        raise RuntimeError(f"no constant {name} in auction_tiled.cu")
    return src.replace(old, f"constexpr int {name} = {value};", 1)


def build(name: str, src: str):
    from cfm_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"{name}.so")
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def solve(lib, cost):
    import torch
    from cfm_tpu_torch.ops import auction as au

    n = cost.shape[0]
    benefit = (-cost.float()).contiguous()
    eps0, eps_final = au._eps_schedule(benefit, 12)
    perm = torch.empty(n, dtype=torch.int32, device="cuda")
    rounds = torch.empty(1, dtype=torch.int32, device="cuda")
    scans = torch.empty(1, dtype=torch.int64, device="cuda")
    err = lib.auction_tiled_solve(benefit.data_ptr(), eps0.data_ptr(), eps_final.data_ptr(),
                                  perm.data_ptr(), rounds.data_ptr(), scans.data_ptr(), n,
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return perm, rounds, scans


def card() -> None:
    import torch

    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"card: {smi.strip()}")
    src = open(os.path.join(ROOT, "cfm_tpu_torch", "csrc", "auction_tiled.cu")).read()
    variants = {"as built": src,
                "few-candidate rounds from n = 1024": with_constant(src, "kShareN", 1024),
                "cluster of 1": with_constant(src, "kCluster", 1),
                "cluster of 4": with_constant(src, "kCluster", 4),
                "cluster of 8": with_constant(src, "kCluster", 8),
                "512 threads": with_constant(src, "kThreads", 512)}
    jobs = {}
    for i, (name, text) in enumerate(variants.items()):
        jobs[name] = build(f"v{i}", instrument(text))
    micro = build("micro", MICRO)
    libs = {}
    for name, (proc, path) in list(jobs.items()) + [("micro", micro)]:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(path)
        if name != "micro":
            lib = libs[name]
            lib.auction_tiled_solve.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                                        ctypes.c_void_p]
            lib.hist_get.argtypes = [ctypes.c_void_p]
            lib.hist_reset.argtypes = []
            for fn in (lib.auction_tiled_solve, lib.hist_get, lib.hist_reset):
                fn.restype = ctypes.c_int
    for n in (1024, 2048, 4096):
        cost = cs.eval_cost(n, seed=n + 1)
        ref = solve(libs["as built"], cost)
        torch.cuda.synchronize()
        for name in variants:
            got = solve(libs[name], cost)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
                    and int(got[2]) == int(ref[2])):
                raise AssertionError(f"{name} differs from the built kernel at n = {n}")
        times = {name: [] for name in variants}
        for name in list(variants) + list(reversed(variants)):
            times[name].append(cs.cuda_ms(lambda: solve(libs[name], cost), iters=2, warmup=1))
        rounds = int(ref[1])
        log(f"n = {n}, W1 evaluation cost, {rounds} rounds; the same permutation, rounds and "
            f"row scans in every variant")
        for name in variants:
            lib = libs[name]
            h = (ctypes.c_ulonglong * 16)()
            if lib.hist_reset():
                raise RuntimeError("hist_reset failed")
            solve(lib, cost)
            torch.cuda.synchronize()
            if lib.hist_get(ctypes.cast(h, ctypes.c_void_p)):
                raise RuntimeError("hist_get failed")
            total = sum(h[0:14:2])
            ms = sum(times[name]) / 2
            log(f"  {name}: {ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times[name])}), "
                f"{1e3 * ms / rounds:.3f} us a round; by candidates: " + " | ".join(
                    f"{LABELS[k]} {h[2 * k + 1]} rounds, {h[2 * k] / max(h[2 * k + 1], 1):.0f} "
                    f"cycles each, {100 * h[2 * k] / total:.1f}%" for k in range(len(LABELS))))
    n = 4 * 1024 * 1024  # a 16 MB cycle through every element
    perm = torch.randperm(n, device="cuda").to(torch.int32)
    chain = torch.empty(n, dtype=torch.int32, device="cuda")
    chain[perm] = torch.roll(perm, -1)
    out = torch.zeros(20, dtype=torch.int64, device="cuda")
    libs["micro"].micro.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    libs["micro"].micro.restype = ctypes.c_int
    if libs["micro"].micro(out.data_ptr(), chain.data_ptr()):
        raise RuntimeError("the microbenchmark failed")
    o = out.tolist()
    log("microbenchmark, cycles: " + "; ".join(f"{name} {o[2 * i]}"
                                               for i, name in enumerate(MICRO_NAMES)))


def row_cache(n: int = 2048) -> None:
    """The share of row scans an LRU of recent bidding rows would serve."""
    import torch

    from cfm_tpu_torch.data.toy import sample_moons
    from cfm_tpu_torch.ops import auction as au
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost

    g = torch.Generator().manual_seed(n + 1)
    cost = torch.sqrt(sq_euclidean_cost(sample_moons(g, n), sample_moons(g, n)) + 1e-30)
    bidders = []
    real_nonzero = torch.nonzero

    def recording(t, *a, **k):  # the plain version lists each round's bidders by nonzero
        r = real_nonzero(t, *a, **k)
        if t.dtype == torch.bool and t.dim() == 1 and t.shape[0] == n:
            bidders.append(r[:, 0].tolist())
        return r

    torch.nonzero = recording
    try:
        _, rounds = au.auction_assignment_tiled_reference(cost)
    finally:
        torch.nonzero = real_nonzero
    for k in (8, 19, 47):
        cache, hits, scans = collections.OrderedDict(), 0, 0
        for rows in bidders:
            for r in rows:
                scans += 1
                if r in cache:
                    cache.move_to_end(r)
                    hits += 1
                else:
                    cache[r] = True
                    if len(cache) > k:
                        cache.popitem(last=False)
        log(f"row cache (CPU, n = {n}, {rounds} rounds, {scans} row scans): an LRU of {k} rows "
            f"serves {100 * hits / scans:.1f}% of them")


def main() -> int:
    sys.path.insert(0, ROOT)
    if "--cpu" not in sys.argv:
        import torch

        if not torch.cuda.is_available():
            print("probes/tiled_auction.py: no CUDA device (pass --cpu for the CPU part)",
                  file=sys.stderr)
            return 1
        card()
    row_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
