#!/usr/bin/env python3
"""Chip probe for the GroupNorm + SiLU backward (kernel #9): the built kernel
against an older build and against variants, at every shape the paths give.

    python3 probes/gn_bwd.py --check                     # one CUDA card
    python3 probes/gn_bwd.py --parent DIR [--variants | --forward]

``--check`` builds ``cfm_tpu_torch/csrc`` (every source: #1 and #2 share
``gn_strip.cuh``), holds #8 and #9 against their plain versions at every
recorded shape with both reruns bit-identical (``chip_smoke.check_gn``),
and #1 and #2 against theirs (``check_attn_block``, ``check_attn_block_bwd``).

``--parent DIR`` times the built #9 against the ``gn_silu_bwd`` of another
build of ``groupnorm.cu``: DIR holds that file and its headers (for example
the parent commit's ``cfm_tpu_torch/csrc`` from ``git archive``), and its C
entry point takes no plan (the first design). At every shape the six paths
give ``GroupNorm32`` (``chip_smoke.record_gn_shapes``), in CUDA graphs
(``chip_smoke.graph_ms``), in turns: the other build, this one, this one,
the other. It prints each shape's times and bound and each training path's
sums over a step's calls.

``--parent DIR --forward`` instead times the kernels that share
``gn_strip.cuh`` with #9, built from DIR (the parent commit's whole
``csrc``) and from the tree, in turns: #8 at every recorded shape with each
path's sums, #1 and #2 at CIFAR-10's training shape and ImageNet-64's 8x8.

``--variants`` first checks the sigmoid's reciprocal (``rcp_newton`` in
``groupnorm.cu``) against ``1.f / b`` at every f32 value of [1, 2^120),
then also times, in the same turns, plans and copies of the kernel that
differ from the built one in one respect: the backward's share
(``SHARE_BYTES_BWD`` at 64 and 128 KB), small maps taking items by the
forward's rule, the first design's IEEE division an element, cluster
launches, barriers and reads also for clusters of one block, the item sum
as a plain launch (not a programmatic dependent one), and, as a ceiling
only, the approximate ``__expf``. Then each kernel's device time a
call at a few shapes (``torch.profiler``), and where a block's time goes
there (a copy with ``%globaltimer`` stamps).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "build", "probe_gn_bwd")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# Copies of the kernel that differ from the built one in a few lines: (file,
# old, new) replacements.
SOURCE_VARIANTS = {
    # the first design's sigmoid: the IEEE division, with its branch, an element
    "division an element": [("groupnorm.cu", "newton = newton && b[u] < 0x1p120f;",
                             "newton = false;")],
    # a cluster launch, cluster barriers and reads also where the cluster is
    # one block
    "clusters of one block": [
        ("gn_strip.cuh", "cfg.numAttrs = cluster > 1 ? 1 : 0;", "cfg.numAttrs = 1;"),
        ("gn_strip.cuh", "  if (cs > 1) sm90::cluster_sync();\n  else", "  sm90::cluster_sync();\n  if (0)"),
        ("gn_strip.cuh", "  if (cs > 1) sm90::cluster_arrive();", "  sm90::cluster_arrive();"),
        ("gn_strip.cuh", "  if (cs > 1) sm90::cluster_wait();", "  sm90::cluster_wait();"),
        ("gn_strip.cuh", "  if (cs == 1) return 0.f + *p;", "")],
    # the item sum as a plain launch after the strip kernel
    "item sum a plain launch": [
        ("gn_strip_bwd.cuh", "  attr[0].val.programmaticStreamSerializationAllowed = 1;",
         "  attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    # not the exact SiLU: how much of the time expf takes
    "__expf (not exact)": [("groupnorm.cu", "b[u] = 1.f + expf(-y[u]);",
                            "b[u] = 1.f + __expf(-y[u]);")],
}
# The built kernel with %globaltimer stamps by thread 0 of every block: 0 at
# entry, 1 when the first box has landed, 2 after pass 1 (the barrier after
# it), 3 after the first lane sums, 4 after the second and the cluster
# sync, 5 after the combine, 6 after the group means, 7 after pass 2, 8 at
# exit.
_STAMP = r"""__device__ unsigned long long g_stamps[1 << 21];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
    if (b < (1u << 17)) g_stamps[b * 16 + i] = t;
  }
}
"""
STAMPS = 9
STAMPED = [
    ("gn_strip_bwd.cuh", "template <typename T, typename Grad>\n__global__",
     _STAMP + "template <typename T, typename Grad>\n__global__"),
    ("gn_strip_bwd.cuh", "  {\n    const CUtensorMap* const maps[2]",
     "  stamp(0);\n  {\n    const CUtensorMap* const maps[2]"),
    ("gn_strip_bwd.cuh", "    sm90::mbar_wait(&bar[b], 0);",
     "    sm90::mbar_wait(&bar[b], 0);\n    if (b == 0) stamp(1);"),
    ("gn_strip_bwd.cuh", "mine[u] = s1[u];\n  __syncthreads();\n  lane_totals(part, col, s, V);\n"
     "  __syncthreads();",
     "mine[u] = s1[u];\n  __syncthreads();\n  stamp(2);\n  lane_totals(part, col, s, V);\n"
     "  __syncthreads();\n  stamp(3);"),
    ("gn_strip_bwd.cuh", "  lane_totals(part, col + IW, s, V);\n  strip_sync(cs);",
     "  lane_totals(part, col + IW, s, V);\n  strip_sync(cs);\n  stamp(4);"),
    ("gn_strip_bwd.cuh", "  strip_arrive(cs);  // done reading the other blocks' sums\n  __syncthreads();",
     "  strip_arrive(cs);\n  __syncthreads();\n  stamp(5);"),
    ("gn_strip_bwd.cuh", "  // Pass 2: dx", "  stamp(6);\n  // Pass 2: dx"),
    ("gn_strip_bwd.cuh", "  strip_wait(cs);  // no block leaves while another may still read its sums\n}",
     "  stamp(7);\n  strip_wait(cs);\n  stamp(8);\n}"),
    ("groupnorm.cu", "}  // extern \"C\"",
     "int stamps_get(unsigned long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, gnstrip::g_stamps, (size_t)n * 8);\n}\n"
     "}  // extern \"C\""),
]


def forward_items(plan_fn):
    """strip_plan with the backward taking items by the forward's rule:
    while the grid keeps MIN_BLOCKS blocks and a share SHARE_BYTES_BWD."""
    from cfm_tpu_torch.ops import groupnorm as gn

    def plan(n, hw, c, num_groups, itemsize, backward=False):
        p = plan_fn(n, hw, c, num_groups, itemsize, backward)
        if not backward or p.cluster > 1 or hw > gn.MAX_BOX_ROWS:
            return p
        strips, items = -(-c // p.width), 1
        while (items < gn.MAX_ITEMS and 2 * items * hw * p.width * itemsize * 2
               <= gn.SHARE_BYTES_BWD and 2 * items * p.width <= 256
               and strips * -(-n // (2 * items)) >= gn.MIN_BLOCKS):
            items *= 2
        return p._replace(items=items)
    return plan


# Every f32 b = 2^k (1 + m 2^-23), 0 <= k < 120, all 2^23 mantissas m: does
# groupnorm.cu's rcp_newton give the bits of 1.f / b (div.rn.f32)?
RCP_CHECK = r"""
#include "groupnorm.cu"
__global__ void k(int lo, int hi, unsigned long long* bad) {
  unsigned long long n = 0;
  for (int e = lo; e < hi; ++e)
    for (unsigned m = blockIdx.x * blockDim.x + threadIdx.x; m < (1u << 23);
         m += gridDim.x * blockDim.x) {
      const float b = __int_as_float(((127 + e) << 23) | m);
      n += __float_as_int(rcp_newton(b)) != __float_as_int(1.f / b);
    }
  atomicAdd(bad, n);
}
extern "C" int rcp_check(int lo, int hi, unsigned long long* out) {
  unsigned long long* d;
  cudaMalloc(&d, 8);
  cudaMemset(d, 0, 8);
  k<<<528, 256>>>(lo, hi, d);
  cudaMemcpy(out, d, 8, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)cudaGetLastError();
}
"""


def build_copy(name, src_dir, patches=(), source="groupnorm"):
    """``<source>.cu`` from ``src_dir`` (with its headers beside it), with
    ``patches`` (file, old, new) applied, built with _build's flags into a
    library of its own."""
    from cfm_tpu_torch.ops import _build

    d = os.path.join(OUT, "".join(ch if ch.isalnum() else "_" for ch in name))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    for file, old, new in patches:
        path = os.path.join(d, file)
        text = open(path).read()
        if old is None:  # new = (first line, last line, text): that span replaced
            a, b = text.index(new[0]), text.index(new[1])
            text, old, new = text[:a] + "@@" + text[b:], "@@", new[2]
        if old not in text:
            raise RuntimeError(f"{name}: the patched line is not in {file}")
        open(path, "w").write(text.replace(old, new))
    lib = os.path.join(d, f"{source}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {name}: {line.strip()}")
    return ctypes.CDLL(lib)


def old_bwd(lib):
    """The first design's entry point: no plan, one launch pair."""
    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gn_silu_bwd.argtypes = [p] * 10 + [i] * 6 + [p]
    lib.gn_silu_bwd.restype = i

    def run(x, scale, bias, mean, inv, g, G, silu):
        n, h, w, c = x.shape
        dx, ds = torch.empty_like(x), torch.empty(c, device=x.device)
        db, ws = torch.empty_like(ds), torch.empty((2, n, c), device=x.device)
        err = lib.gn_silu_bwd(x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                              mean.data_ptr(), inv.data_ptr(), dx.data_ptr(), ds.data_ptr(),
                              db.data_ptr(), ws.data_ptr(), n, h * w, c, G, int(silu),
                              0 if x.dtype == torch.float32 else 1,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other build's gn_silu_bwd failed: CUDA error {err}")
        return dx, ds, db
    return run


def with_lib(lib, fn, name="groupnorm"):
    """``fn`` run with the wrapper's library ``name`` swapped for ``lib``."""
    from cfm_tpu_torch.ops import _build

    def run(*a, **k):
        _build.load(name)
        saved = _build._LIBS[name]
        _build._LIBS[name] = lib
        try:
            return fn(*a, **k)
        finally:
            _build._LIBS[name] = saved
    return run


def forward_turns(parent, gn, paths):
    """The kernels that share gn_strip.cuh with #9, built from ``parent`` and
    from the tree, in turns (parent, tree, tree, parent): #8 at every
    recorded shape of every path in CUDA graphs, with each path's sums over
    an evaluation; #1 and #2 at the CIFAR-10 training shape and
    ImageNet-64's 8x8, by device time (chip_smoke.time_attn_block and
    time_attn_block_bwd)."""
    import torch

    libs = {k: build_copy(f"parent {k}", parent, source=k)
            for k in ("groupnorm", "attn_block_fwd", "attn_block_bwd")}
    fwd = {"parent": with_lib(libs["groupnorm"], gn.fused_group_norm_silu_fwd),
           "tree": gn.fused_group_norm_silu_fwd}
    order = ("parent", "tree", "tree", "parent")
    times = {}
    for shape in dict.fromkeys(k for p in paths.values() for k in p):
        N, H, W, C, G, dt, silu = shape
        x, scale, bias, _ = cs.gn_inputs(N, H, W, C, getattr(torch, dt))
        with torch.no_grad():
            got = {k: [] for k in fwd}
            for k in order:
                got[k].append(cs.graph_ms(lambda: fwd[k](x, scale, bias, G, 1e-5, silu)))
        times[shape] = {k: sum(v) / len(v) for k, v in got.items()}
    for name, counts in paths.items():
        tot = {k: sum(n * times[s][k] for s, n in counts.items()) for k in fwd}
        cs.log(f"#8 summed over one {name} evaluation's {sum(counts.values())} calls: "
               + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()))
    for what, fn, lib, shapes in (
            ("#1", cs.time_attn_block, "attn_block_fwd", ((cs.TRAIN_BATCH, 256, 256, 4),
                                                          (cs.IMAGENET_BATCH, 64, 768, 12))),
            ("#2", cs.time_attn_block_bwd, "attn_block_bwd", ((cs.TRAIN_BATCH, 256, 256, 4),
                                                              (cs.IMAGENET_BATCH, 64, 768, 12)))):
        runs = {"parent": with_lib(libs[lib], fn, lib), "tree": fn}
        for N, S, C, H in shapes:
            got = {k: [] for k in runs}
            for k in order:
                got[k].append(runs[k](N, S=S, C=C, H=H)["ms"])
            cs.log(f"{what} N={N} S={S} C={C} H={H}, device time: " + ", ".join(
                f"{k} {sum(v) / len(v):.4f} ms ({', '.join(f'{t:.4f}' for t in v)})"
                for k, v in got.items()))


def with_attrs(fn, **attrs):
    """``fn`` run with ``ops.groupnorm``'s planner constants set to ``attrs``."""
    from cfm_tpu_torch.ops import groupnorm as gn

    def run(*a):
        saved = {k: getattr(gn, k) for k in attrs}
        for k, v in attrs.items():
            setattr(gn, k, v)
        try:
            return fn(*a)
        finally:
            for k, v in saved.items():
                setattr(gn, k, v)
    return run


def check_rcp():
    """groupnorm.cu's rcp_newton against 1.f / b at every f32 value of
    [1, 2^120)."""
    from cfm_tpu_torch.ops import _build

    src = os.path.join(OUT, "rcp_check.cu")
    os.makedirs(OUT, exist_ok=True)
    open(src, "w").write(RCP_CHECK)
    lib = os.path.join(OUT, "rcp_check.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).rcp_check
    out = (ctypes.c_ulonglong * 1)()
    if fn(0, 120, out):
        raise RuntimeError("rcp_check failed")
    cs.log(f"rcp_newton over the 120 x 2^23 f32 values of [1, 2^120): {out[0]} unlike 1.f / b")
    if out[0]:
        raise AssertionError("rcp_newton is not the IEEE division")


def stamp_report(lib, gn, shapes):
    """Where a block's time goes at the picked shapes: the stamped kernel run
    once, each phase's mean over the blocks, a block's mean span and the
    kernel's span."""
    import torch

    get = lib.stamps_get
    get.argtypes, get.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    picks = [s for s in shapes if (s[0], s[1], s[3], s[6]) in {
        (128, 7, 64, False), (128, 4, 256, True), (128, 32, 128, True), (32, 64, 576, True),
        (32, 8, 768, True), (80, 7, 128, True)}]
    run = with_lib(lib, gn.fused_group_norm_silu_bwd)
    for N, H, W, C, G, dt, silu in picks:
        x, scale, bias, dy = cs.gn_inputs(N, H, W, C, getattr(torch, dt))
        _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
        for _ in range(3):
            run(x, scale, bias, mean, inv, dy, G, silu)
        torch.cuda.synchronize()
        p = gn.strip_plan(N, H * W, C, G, x.element_size(), backward=True)
        blocks = -(-C // p.width) * p.cluster * -(-N // p.items)
        buf = (ctypes.c_ulonglong * (16 * blocks))()
        if get(buf, 16 * blocks):
            raise RuntimeError("stamps_get failed")
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(blocks, 16)[:, :STAMPS]
        t = (t - t[:, 0].min()) / 1e3  # us from the first block's entry
        phases = (t[:, 1:] - t[:, :-1]).mean(0).tolist()
        cs.log(f"#9 stamps N={N} {H}x{W}x{C} {dt} silu={silu} plan {tuple(p)}, {blocks} blocks: "
               f"kernel span {t[:, -1].max().item():.2f} us, a block "
               f"{(t[:, -1] - t[:, 0]).mean().item():.2f} us; phases (first box, pass 1, lane "
               f"sums, lane sums + cluster sync, combine, means, pass 2, cluster wait) "
               + ", ".join(f"{v:.2f}" for v in phases) + "; block entries at quantiles "
               "0.25/0.5/0.75/1: " + ", ".join(f"{t[:, 0].quantile(q).item():.2f}"
                                               for q in (0.25, 0.5, 0.75, 1.0)))


def profile_kernels(other, gn, shapes):
    """Each kernel's device time a call (torch.profiler, 20 calls) of the
    built #9 and the other build at a few training shapes: where a call's
    time goes between the strip kernel and the item sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    picks = [s for s in shapes if (s[0], s[1], s[3], s[6]) in {
        (128, 7, 64, False), (128, 4, 256, True), (128, 32, 128, True), (32, 64, 576, True),
        (32, 8, 768, True)}]
    for shape in picks:
        N, H, W, C, G, dt, silu = shape
        x, scale, bias, dy = cs.gn_inputs(N, H, W, C, getattr(torch, dt))
        with torch.no_grad():
            _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
            for name, fn in (("other", other), ("built", gn.fused_group_norm_silu_bwd)):
                for _ in range(3):
                    fn(x, scale, bias, mean, inv, dy, G, silu)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        fn(x, scale, bias, mean, inv, dy, G, silu)
                    torch.cuda.synchronize()
                rows = [(e.key, e.self_device_time_total / 20) for e in prof.key_averages()
                        if e.self_device_time_total > 0]
                cs.log(f"#9 profile N={N} {H}x{W}x{C} {dt} silu={silu}, {name}: " + "; ".join(
                    f"{k[:60]} {us:.2f} us" for k, us in sorted(rows, key=lambda r: -r[1])))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--forward", action="store_true",
                    help="time #8, #1 and #2 (gn_strip.cuh) against the parent's build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gn_bwd probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"card: {smi}")
    from cfm_tpu_torch.ops import _build
    from cfm_tpu_torch.ops import groupnorm as gn

    for name, b in _build.build_all().items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                cs.log(f"  {name}: {line.strip()}")
    imagenet = cs.seeded_model(cs.IMAGENET64, torch.bfloat16, "cuda", seed=0, dropout=0.1)
    paths = cs.record_gn_shapes(imagenet)
    del imagenet
    if args.check:
        cs.check_gn(paths)
        cs.check_attn_block()
        cs.check_attn_block_bwd()
        cs.log("checks passed")
    if not args.parent:
        return 0
    if args.forward:
        forward_turns(args.parent, gn, paths)
        return 0

    gn._lib()  # the built library, typed
    if args.variants:
        check_rcp()
    runs = {"other": old_bwd(build_copy("other", args.parent)),
            "built": gn.fused_group_norm_silu_bwd}
    if args.variants:
        csrc = os.path.join(ROOT, "cfm_tpu_torch", "csrc")
        with ThreadPoolExecutor(max_workers=len(SOURCE_VARIANTS)) as pool:
            libs = pool.map(lambda kv: build_copy(kv[0], csrc, kv[1]), SOURCE_VARIANTS.items())
            for name, lib in zip(SOURCE_VARIANTS, libs):
                runs[name] = with_lib(lib, gn.fused_group_norm_silu_bwd)
        runs["share 64 KB"] = with_attrs(gn.fused_group_norm_silu_bwd, SHARE_BYTES_BWD=64 * 1024)
        runs["share 128 KB"] = with_attrs(gn.fused_group_norm_silu_bwd,
                                          SHARE_BYTES_BWD=128 * 1024)
        runs["the forward's items rule"] = with_attrs(gn.fused_group_norm_silu_bwd,
                                                      strip_plan=forward_items(gn.strip_plan))
        stamped = build_copy("stamped", csrc, STAMPED)
    order = ["other"] + [k for k in runs if k != "other"]
    order += order[::-1]
    shapes = dict.fromkeys(k for p in paths.values() for k in p)
    times = {}
    for shape in shapes:
        N, H, W, C, G, dt, silu = shape
        x, scale, bias, dy = cs.gn_inputs(N, H, W, C, getattr(torch, dt))
        with torch.no_grad():
            _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
            ref = gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy, G, silu)
            got = {k: [] for k in runs}
            for k in order:
                fn = runs[k]
                if k != "other":  # every variant gives the built kernel's dx within TOL
                    out = fn(x, scale, bias, mean, inv, dy, G, silu)
                    tol = cs.TOL[dt]
                    if not bool(((out[0].float() - ref[0].float()).abs()
                                 <= tol + tol * ref[0].float().abs()).all()):
                        raise AssertionError(f"{k} disagrees at {shape}")
                    same = all(map(torch.equal, out, ref))
                    if k.startswith(("rcp", "no cluster", "carveout")) and not same:
                        cs.log(f"  {k} gives other bits than the built kernel at {shape}")
                got[k].append(cs.graph_ms(lambda: fn(x, scale, bias, mean, inv, dy, G, silu)))
        times[shape] = {k: sum(v) / len(v) for k, v in got.items()}
        bound = cs.gn_bound(N, H * W, C, x.element_size(), True)[0]
        times[shape]["bound"] = bound
        plan = tuple(gn.strip_plan(N, H * W, C, G, x.element_size(), backward=True))
        cs.log(f"#9 N={N} {H}x{W}x{C} {dt} silu={silu} plan {plan}: bound {bound:.4f} ms; "
               + ", ".join(f"{k} {v:.4f}" for k, v in times[shape].items() if k != "bound"))
    profile_kernels(runs["other"], gn, shapes)
    if args.variants:
        stamp_report(stamped, gn, shapes)
    for name, counts in paths.items():
        if "training" not in name:
            continue
        tot = {k: sum(n * times[s][k] for s, n in counts.items()) for k in times[next(iter(counts))]}
        cs.log(f"#9 summed over a {name} step's {sum(counts.values())} calls: "
               + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
