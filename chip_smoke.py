#!/usr/bin/env python3
"""Drive the PyTorch port (``cfm_tpu_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases; any failure raises, and the script exits non-zero without printing
a result:

1. The card: ``nvidia-smi`` name and power limit, torch's device name and
   count. Refuses to run without CUDA.
2. Builds every kernel from ``cfm_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and prints the build time and ``ptxas`` register and
   shared-memory lines.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes generation gives it and at a few others that take other branches
   of the kernel, in float32 (TF32 off) and bfloat16.
4. Times each kernel with CUDA events beside its plain version, one PyTorch
   library call of the same function (a yardstick the port never calls)
   and the bound (the larger of bytes over 3.35 TB/s and tensor-core FLOPs
   over 989 TFLOP/s, the H100 SXM data-sheet peaks).
5. Checks generation end to end on a small input: the same weights and
   noise on the card and on the CPU (plain versions) give uint8 images
   within one level and the same NFE.
6. The main path: generation at the CIFAR-10 recipe width (128 channels,
   mult (1, 2, 2, 2), 2 res blocks, 4 heads x 64, attention at 16x16, bf16)
   with random seeded weights, euler at 100 steps and dopri5 at rtol = atol
   = 1e-5. Every launch count is set to 0 just before and read just after;
   the attention-block kernel must have run 5 times per model evaluation.
7. Profiles one recipe-width model evaluation (batch 512, bf16) with
   ``torch.profiler`` and prints the device time by kernel and the share of
   the evaluation's wall time the device was busy.

The last three lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
GEN_BATCH = 512            # generation batch: the shape the main path gives the kernel
RECIPE = dict(dim=(32, 32, 3), num_channels=128, channel_mult=(1, 2, 2, 2), num_res_blocks=2,
              num_heads=4, num_head_channels=64, attention_resolutions="16")
SMALL = dict(dim=(16, 16, 3), num_channels=64, channel_mult=(1, 2, 2), num_res_blocks=1,
             num_heads=4, num_head_channels=64, attention_resolutions="8")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # abs and rel, kernel vs plain version


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_inputs(N, S, C, dtype, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    return dict(x=r(N, S, C).to(dtype), gscale=1 + 0.1 * r(1, C), gbias=0.1 * r(1, C),
                wq=r(C, 3 * C) / math.sqrt(C), bq=0.1 * r(1, 3 * C),
                wo=0.5 * r(C, C) / math.sqrt(C), bo=0.1 * r(1, C))


def check_attn_block(G=32):
    """Phase 3: kernel vs plain version at the generation shape, the gate's
    smallest S, a ragged key tile (S=72), and head dims 128 and 192 (the
    latter takes the FMA attention kernel in bf16). Returns the largest bf16
    error at the generation shape."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.ops import attn_block as ab

    worst = 0.0
    shapes = ((GEN_BATCH, 256, 256, 4), (64, 64, 256, 4), (8, 72, 128, 2), (8, 64, 256, 2),
              (4, 136, 384, 2))
    for N, S, C, H in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            t = block_inputs(N, S, C, dtype)
            args = list(t.values()) + [H, G]
            with torch.no_grad(), strict_f32():
                y = ab.fused_attention_block(*args)
                ref = ab.attention_block_reference(*args)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs()
            tol = TOL[str(dtype).split(".")[1]]
            bad = (err > tol + tol * ref.float().abs()).sum().item()
            log(f"attn_block_fwd N={N} S={S} C={C} H={H} {dtype}: max abs err "
                f"{err.max().item():.3e}, {bad} of {err.numel()} outside {tol} abs+rel")
            if bad or not torch.isfinite(y).all():
                raise AssertionError(f"attn_block_fwd disagrees with its plain version at "
                                     f"N={N} S={S} C={C} H={H} {dtype}")
            if dtype == torch.bfloat16 and N == GEN_BATCH:
                worst = err.max().item()
    return worst


def time_attn_block(H=4, G=32):
    """Phase 4 at the generation shape (N=GEN_BATCH, S=256, C=256), bf16."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import attn_block as ab

    N, S, C = GEN_BATCH, 256, 256
    D = C // H
    t = block_inputs(N, S, C, torch.bfloat16)
    args = list(t.values()) + [H, G]
    lp = {k: v.to(torch.bfloat16) for k, v in t.items()}

    def library():
        x = lp["x"]
        tok = F.group_norm(x.transpose(1, 2), G, lp["gscale"][0], lp["gbias"][0]).transpose(1, 2)
        q, k, v = F.linear(tok, lp["wq"].T, lp["bq"][0]).view(N, S, 3, H, D).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(N, S, C)
        return x + F.linear(ctx, lp["wo"].T, lp["bo"][0])

    with torch.no_grad():
        times = dict(ms=cuda_ms(lambda: ab.fused_attention_block(*args)),
                     plain_ms=cuda_ms(lambda: ab.attention_block_reference(*args), iters=5),
                     library_ms=cuda_ms(library))
        t32 = block_inputs(N, S, C, torch.float32)
        ms_f32 = cuda_ms(lambda: ab.fused_attention_block(*t32.values(), H, G), iters=10)
    flops = N * (2 * S * C * 3 * C + 2 * 2 * H * S * S * D + 2 * S * C * C)
    nbytes = 2 * N * S * C * 2 + 4 * (C * 3 * C + 3 * C + C * C + 3 * C)  # x, y bf16; f32 weights
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    log(f"attn_block_fwd timing N={N} S={S} C={C} bf16: kernel {times['ms']:.4f} ms "
        f"({flops / times['ms'] / 1e9:.2f} TFLOP/s, {100 * bound_ms / times['ms']:.2f}% of the "
        f"{bound_ms:.4f} ms bound by {bound_by}), plain {times['plain_ms']:.4f} ms, "
        f"library {times['library_ms']:.4f} ms; f32 kernel {ms_f32:.4f} ms")
    return dict(times, bound_ms=bound_ms, bound_by=bound_by)


def seeded_model(cfg, dtype, device, seed):
    """A UNet with random seeded weights; the zero-initialised layers (the
    ResBlock and output zero convs, the attention out-projections) get small
    seeded values so the field is non-trivial and smooth."""
    import torch
    from cfm_tpu_torch.models.unet import AttentionBlock, Conv, UNetModelWrapper

    model = UNetModelWrapper(**cfg, dtype=dtype, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            zero = [m.weight] if isinstance(m, Conv) and m.zero_init else []
            zero += [m.proj_weight] if isinstance(m, AttentionBlock) else []
            for p in zero:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3 / math.sqrt(p[0].numel()))
    return model.to(device)


def check_small_generation():
    """Phase 5: the same weights and noise on the card and on the CPU."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.generate import generate

    x0 = torch.randn((4,) + SMALL["dim"], generator=torch.Generator().manual_seed(3))
    with strict_f32():
        for method in ("euler", "dopri5"):
            out = {}
            for dev in ("cpu", "cuda"):
                model = seeded_model(SMALL, torch.float32, dev, seed=2)
                out[dev] = generate(model, 4, x_shape=SMALL["dim"], method=method, n_steps=4,
                                    x0=x0, device=dev)
            diff = (out["cuda"].images.cpu().int() - out["cpu"].images.int()).abs().max().item()
            log(f"small generation {method}: nfe cuda {out['cuda'].nfe} cpu {out['cpu'].nfe}, "
                f"max uint8 difference {diff}")
            if diff > 1 or out["cuda"].nfe != out["cpu"].nfe:
                raise AssertionError(f"small {method} generation: card and CPU disagree")


def main_path():
    """Phase 6: recipe-width generation; returns the kernels' launch counts."""
    import torch
    from cfm_tpu_torch.generate import generate
    from cfm_tpu_torch.ops import attn_block as ab

    model = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0)
    log(f"recipe UNet: {sum(p.numel() for p in model.parameters())} parameters, bf16")
    runs = (("euler", dict(method="euler", n_steps=100)),
            ("dopri5", dict(method="dopri5", rtol=1e-5, atol=1e-5, max_steps=200)))
    ab.fused_attention_block.launches = 0
    total_nfe = 0
    for name, kw in runs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        before = ab.fused_attention_block.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, GEN_BATCH, generator=gen, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        img = out.images
        launched = ab.fused_attention_block.launches - before
        log(f"generation {name}: {GEN_BATCH} images in {sec:.3f} s = {GEN_BATCH / sec:.2f} imgs/s, "
            f"NFE {out.nfe}, attn_block_fwd launches {launched}, uint8 mean "
            f"{img.float().mean().item():.2f} std {img.float().std().item():.2f}")
        if img.dtype != torch.uint8 or tuple(img.shape) != (GEN_BATCH, 32, 32, 3):
            raise AssertionError(f"{name}: images of {img.dtype} {tuple(img.shape)}")
        if img.float().std().item() < 1.0:
            raise AssertionError(f"{name}: images are constant")
        if launched != 5 * out.nfe:
            raise AssertionError(f"{name}: {launched} kernel launches for NFE {out.nfe}, "
                                 f"expected 5 per evaluation")
        total_nfe += out.nfe
    launches = ab.fused_attention_block.launches
    if launches != 5 * total_nfe or launches == 0:
        raise AssertionError(f"attn_block_fwd launched {launches} times for NFE {total_nfe}")
    return {"attn_block_fwd": launches}


def profile_evaluation(top=12):
    """Phase 7: device time by kernel over one recipe-width evaluation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0)
    x = torch.randn((GEN_BATCH, 32, 32, 3), device="cuda")
    t = torch.full((GEN_BATCH,), 0.5, device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            model(t, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(t, x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    log(f"profile of one evaluation: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%), {len(rows)} kernel names")
    groups = {}
    for us, _, key in rows:
        if "at::native" in key:
            group = "plain torch elementwise and reductions"
        elif any(k in key for k in ("mma_gemm_kernel", "attention_mma_kernel", "gn_stats_kernel",
                                    "round_transpose_kernel", "attention_kernel", "gemm_kernel")):
            group = "attn_block_fwd kernels"
        elif "fprop" in key or "conv" in key.lower():
            group = "cuDNN convolutions"
        else:
            group = "other (cuBLAS matmuls, ...)"
        groups[group] = groups.get(group, 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {group}")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% x{count:<4d} {key[:100]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{kind} x{count}")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cfm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")

    err = check_attn_block()
    timing = time_attn_block()
    check_small_generation()
    launches = main_path()
    profile_evaluation()

    kernels = [{
        "name": "attn_block_fwd", "route": "cuda",
        "source": "cfm_tpu_torch/csrc/attn_block_fwd.cu",
        "replaces": "cfm_tpu/ops/pallas_attn_block.py:97",
        "launches": launches["attn_block_fwd"], "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
