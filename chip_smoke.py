#!/usr/bin/env python3
"""Drive the PyTorch port (``cfm_tpu_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases; any failure raises, and the script exits non-zero without printing
a result:

1. The card: ``nvidia-smi`` name and power limit, torch's device name and
   count. Refuses to run without CUDA.
2. Builds every kernel from ``cfm_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once: the attention-block forward and backward, the
   multi-head attention forward and backward, the dense and the tiled
   auction, the GroupNorm forward and backward and flash Sinkhorn) and
   prints the build time and ``ptxas`` register and shared-memory lines.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at others that take other branches:
   the attention-block forward and backward in float32 (TF32 off) and
   bfloat16 (the backward's bf16 limit shown to catch do and ds rounded to
   bf16), at the CIFAR-10 shapes, at the ImageNet-64 8x8 shape (C = 768,
   12 heads) and at ragged S on both bf16 attention routes, the forward and
   the bf16 backward rerun for the same bits; the multi-head attention forward and backward
   (#3, #4) at the ImageNet-64 training and generation shapes and at others
   that take other branches, the gate's edges (S = 896 at D = 64, 768 at
   D = 128) among them, with the bf16 backward's rerun giving the same
   bits; the auction's
   permutation and round count, which must be identical, on a rerun too, on
   Gaussian, tied, duplicated and rank-1 costs up to n = 512, with its
   assignment cost against scipy's; the tiled auction's (#6) permutation and
   round count, identical to its plain version's, on the four kinds at
   n = 256, 1024 and 2048, and on the 2-D evaluation's W1 and W2 costs at
   1024 and 2048 (W1 at 4096 held to scipy's optimum only); and the
   GroupNorm(+SiLU) forward and
   backward (#8, #9) at every (N, H, W, C, dtype, SiLU) that one model
   evaluation of each path gives ``GroupNorm32`` (recorded by wrapping the
   wrapper for that pass; the ImageNet-64 paths included), plus a
   recentred-variance case in float32, the forward rerun for the same
   bits (its cluster combine has a fixed order); and flash Sinkhorn (#7)
   at the 2d_sf2m path's shape (n = m = 2048, d = 2, reg 2), at n != m with tails,
   at d = 32, with a non-uniform loga, at a small reg, at 4096 + 4096 2-D
   points (beyond the clouds' room in shared memory, so tiled) and at
   CIFAR-10's batch and width (128 points, d = 3072, too wide for a tile
   of coordinates in shared memory; scaled to the d = 32 case's costs):
   f and g within
   1e-4 relative + 1e-5 reg absolute of the plain version after 50
   iterations, and at tol 1e-6 stopping counts within 1 of each other and
   both implied plans within the tolerance, a rerun repeating the bits and
   the iteration count.
4. Times each kernel with CUDA events (the attention-block forward at the
   training and the generation batch and at ImageNet-64's 8x8 shape, and
   its backward at the CIFAR-10 and ImageNet-64 training shapes, by device
   time in turns with the library composition, with their device
   operations a call and their kernels' times; the multi-head attention forward and
   backward at the ImageNet-64 training shape, in turns with
   ``F.scaled_dot_product_attention`` and its backward, by device time from
   the profiler as well, with the backward's FMA variant of dq and dk; the
   GroupNorm kernels at every recorded shape of every path, by device time
   in CUDA graphs beside ``F.group_norm`` + ``F.silu``, and summed over
   each path's evaluation; the
   dense auction at n = 128 and at 2d_otcfm's n = 256, with its device
   time, device operations a call (one), rounds and row scans; the
   tiled auction at n = 1024, 2048 and 4096 on the W1 evaluation cost, with
   its rounds and row scans; flash Sinkhorn at the 2d_sf2m path's shape,
   with its iterations, device time and grid barriers an iteration, and
   100 iterations at 2048 and at 256 points) beside its plain
   version, one PyTorch library call of the same function where there is
   one (a yardstick the port never calls; for the auction, scipy's solver
   on the host) and the bound: the larger of bytes over 3.35 TB/s and
   operations over the peak rate for their type (989 TFLOP/s bf16 tensor
   cores, 67 TFLOP/s f32 without them; H100 SXM data-sheet peaks).
5. Checks generation end to end on small inputs: the same weights and
   noise on the card and on the CPU (plain versions) give uint8 images
   within one level and the same NFE, for a CIFAR-shaped model and for one
   that routes like ImageNet-64 (#3 at 16x16, #1 at 8x8, the plain
   composition at 4x4, scale-shift norm, ResBlock up/down sampling, 10
   classes). Then one train step of the first in f32 with the same draws
   and dropout masks on both, one class-conditional step, and one
   class-conditional step of the second: loss, updated parameters and EMA
   agree. Then one forward of ``AttentionPool2d``, ``SuperResModel`` and
   ``EncoderUNetModel`` (every pool) on the card against the CPU. Then one
   f32 2-D OT-CFM step of the preset's MLP (batch 256, the dense auction on
   the card) and W1 and W2 of two 2048-point clouds (the tiled auction on
   the card, scipy on the CPU), card against CPU.
6. The generation path: the CIFAR-10 recipe width (128 channels, mult
   (1, 2, 2, 2), 2 res blocks, 4 heads x 64, attention at 16x16, bf16) with
   random seeded weights, euler at 100 steps and dopri5 at rtol = atol =
   1e-5. The launch counts are set to 0 just before each run and read just
   after: 5 attention-block and 46 GroupNorm launches per model evaluation.
7. Profiles one recipe-width model evaluation (batch 512, bf16) with
   ``torch.profiler``, tracing the device only, and prints the device time
   by kernel and the share of that window's wall time the device was busy.
8. The CIFAR-10 training path: ``Trainer`` on ``cifar10_otcfm`` at the full
   recipe (bf16, batch 128, synthetic data), a few warm-up steps, then
   ``fit`` for 30 more with every launch count set to 0 just before and read
   just after: 1 auction, 5 + 5 attention-block and 46 + 46 GroupNorm
   launches per step. Prints ms per step, images per second, the first and
   last loss (finite) and the peak device memory.
9. Profiles three train steps as in 7 and prints, per step, the device
   time grouped as there and the device-busy share of that window's wall
   time; then three more with host tracing on, and the host operators
   that took the most CPU time.
10. The class-conditional MNIST path: ``Trainer`` on ``mnist_otcfm_cond``
    (bf16, batch 128, synthetic MNIST) as in 8: 1 auction, 27 + 27
    GroupNorm and no attention-block launches per step; profiled as in 9;
    then ``Trainer.generate`` of 80 images, 8 per class, with euler at 100
    steps: 27 GroupNorm launches per evaluation.
11. ImageNet-64 generation: guided-diffusion's ImageNet 64x64 UNet (192
    channels, mult (1, 2, 3, 4), 3 res blocks, attention at 32, 16 and 8
    with 64 head channels, scale-shift norm, ResBlock up/down sampling,
    1000 classes; 295,899,267 parameters) in bf16 with random seeded
    weights, 64 images of 64 labels drawn from the seed, euler at 100
    steps: 7 multi-head attention (#3), 8 attention-block and 87 GroupNorm
    launches per evaluation. Prints images per second, ms per evaluation
    and the peak memory; then profiles one evaluation as in 7.
12. ImageNet-64 training: ``make_train_step`` with exact OT-CFM and the
    labels, bf16, batch 32, dropout 0.1, Adam 1e-4 with the warmup
    schedule, clip 1.0, EMA 0.9999, on random uint8 images and labels put
    on the card once; 3 warm-up steps, then 20 with 1 auction, 7 + 7
    multi-head attention, 8 + 8 attention-block and 87 + 87 GroupNorm
    launches a step; then three steps profiled as in 9.
13. The 2-D tutorial: ``Trainer`` on ``2d_otcfm`` as the preset gives it
    (MLP width 64, batch 256, 5000 steps, W1 and W2 on 2048 points every
    1000 steps): 5000 dense (#5) and 10 tiled (#6) auction launches. Prints
    ms per step and each evaluation's W1, W2, NFE and seconds; the final W2
    must be under 1.1. Then three steps profiled as in 9, with the
    host-to-device copies and stream synchronisations counted per step, and
    #5's device ms a step beside the device-busy share.
14. ``cli.main(["train", ...])`` for 300 steps of ``2d_icfm``, ``2d_fm``,
    ``2d_sbcfm``, ``2d_vpcfm`` and ``2d_sf2m``, each ending with its final
    evaluation.
15. No host synchronisation in a step: after warm-up, one ``2d_otcfm`` step
    and one ``2d_sf2m`` step on the flash route (``matcher.ot_method=sinkhorn
    data.batch_size=2048``), each with its data draw, under
    ``torch.cuda.set_sync_debug_mode("error")``, calling the step function
    directly (``Trainer.fit``'s logging read is by design).
16. The entropic path, [SF]2M: ``Trainer`` on ``2d_sf2m`` with
    ``matcher.ot_method=sinkhorn data.batch_size=2048``: the untrained flow
    evaluated, 3 warm-up steps, then 1000 steps with one evaluation at their
    end, every launch count set to 0 just before: one flash Sinkhorn (#7) a
    step and two tiled auctions (#6) for the evaluation. Prints ms per step,
    the losses, the degenerate-coupling flags (all 0) and the iterations per
    solve; the final W2 must beat the untrained flow's. Then three steps
    profiled as in 13, with #7's device ms a step.
17. ``wasserstein(x0, x1, method="sinkhorn", power=2)`` of 2048 8-Gaussian
    points against 2048 moons points at reg 2: one #7 launch on the card,
    within 1e-4 relative of the same call on the CPU (the dense Sinkhorn).

The last three lines are the kernels' JSON record (``launches`` summed over
the paths of phases 6, 8, 10 to 14, 16 and 17), the card's name and power
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
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate without the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate
GEN_BATCH = 512            # generation batch: the shape the main path gives the kernel
RECIPE = dict(dim=(32, 32, 3), num_channels=128, channel_mult=(1, 2, 2, 2), num_res_blocks=2,
              num_heads=4, num_head_channels=64, attention_resolutions="16")
SMALL = dict(dim=(16, 16, 3), num_channels=64, channel_mult=(1, 2, 2), num_res_blocks=1,
             num_heads=4, num_head_channels=64, attention_resolutions="8")
# guided-diffusion's ImageNet 64x64 flags (openai/guided-diffusion README), with
# no learn_sigma: a velocity field has 3 output channels.
IMAGENET64 = dict(dim=(64, 64, 3), num_channels=192, num_res_blocks=3, channel_mult=(1, 2, 3, 4),
                  num_head_channels=64, attention_resolutions="32,16,8",
                  use_scale_shift_norm=True, resblock_updown=True, class_cond=True,
                  num_classes=1000)
# A small model that routes like IMAGENET64: #3 at 16x16, #1 at 8x8, the plain
# composition at 4x4, in f32 and bf16.
IMAGENET_SMALL = dict(dim=(16, 16, 3), num_channels=64, channel_mult=(1, 2, 3), num_res_blocks=1,
                      num_head_channels=64, attention_resolutions="16,8,4",
                      use_scale_shift_norm=True, resblock_updown=True, class_cond=True,
                      num_classes=10)
IMAGENET_GEN, IMAGENET_BATCH, IMAGENET_STEPS = 64, 32, 20
# Launches per ImageNet-64 evaluation: the 16x16 blocks take #3, the 8x8 blocks
# #1, the 32x32 blocks the plain composition.
IMAGENET_PER_EVAL = dict(attention_fwd=7, attn_block_fwd=8, gn_silu_fwd=87)
# (N, H, S, D) of the multi-head attention checks: the ImageNet-64 training and
# generation shapes, the gate's smallest S, a long S, head dim 128, and the
# gate's edges at D = 64 and 128, which take the two-pass routes.
ATTN_SHAPES = ((IMAGENET_BATCH, 9, 256, 64), (IMAGENET_GEN, 9, 256, 64), (4, 1, 128, 64),
               (2, 2, 512, 64), (4, 2, 256, 128), (2, 2, 896, 64), (1, 1, 768, 128))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # abs and rel, kernel vs plain version
# The backward's weight gradients, relative to each one's max-abs. In bf16 the
# kernel reads up to 5.8e-4 there and rounding do and ds to bf16 (what feeding
# them to bf16 tensor cores would do) reads 1.4e-3 or more; check_attn_block_bwd
# shows on every run that the limit sits between the two.
WGRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 128, 3, 30
# (N, S, C, H) of the attention-block checks beside the CIFAR-10 shapes: the
# gate's smallest S, a ragged key tile (S = 72, 136 at D = 64, 72 at D = 128,
# 328 on the streamed route), head dim 192 (the FMA attention kernel in
# bf16), and ImageNet-64's 8x8 blocks.
BLOCK_SHAPES = ((64, 64, 256, 4), (8, 72, 128, 2), (8, 64, 256, 2), (4, 136, 384, 2),
                (IMAGENET_BATCH, 64, 768, 12), (2, 136, 256, 4), (2, 72, 256, 2),
                (2, 328, 256, 4))
GRADS = ("dx", "dgscale", "dgbias", "dwq", "dbq", "dwo", "dbo")
GN_PER_EVAL = {"cifar10": 46, "mnist": 27, "imagenet64": 87}  # GroupNorm32 calls per evaluation
MNIST_GEN = 80                              # 8 samples of each of the 10 classes
# f32 operations per element (non-tensor-core rate): the forward's two
# statistics passes and its affine + SiLU; the backward's SiLU derivative,
# two column sums and dx, each recomputing norm.
GN_FWD_OPS, GN_BWD_OPS = 12, 30
# The entropic path: 2d_sf2m with the flash coupling at batch 2048.
SF2M = ["matcher.ot_method=sinkhorn", "data.batch_size=2048", "trainer.ckpt_interval=0"]
SF2M_WARMUP, SF2M_STEPS, SF2M_REG = 3, 1000, 2.0
# (n, m, d, reg, non-uniform loga, what) of the flash Sinkhorn checks.
FLASH_CASES = ((2048, 2048, 2, SF2M_REG, False, "the 2d_sf2m path"),
               (1000, 1536, 2, 0.5, False, "n != m, tails"),
               (2048, 2048, 32, 4.0, False, "d = 32"),
               (2048, 2048, 2, SF2M_REG, True, "non-uniform loga"),
               (512, 512, 2, 0.05, False, "small reg"),
               (4096, 4096, 2, SF2M_REG, False, "d = 2 beyond shared memory: tiled"),
               (128, 128, 3072, 4.0, False, "CIFAR-10's batch and width, scaled: "
                                             "coordinates in global memory"))
FLASH_TOL, FLASH_CAP = 1e-6, 3000
# torch.profiler sessions: how many to try before a window counts as not
# measured, and the idle host time that pads each side of a session.
PROFILE_TRIES, PROFILE_PAD_S = 4, 0.05
FLASH_BARRIERS = 2  # grid barriers an iteration of #7 (csrc/flash_sinkhorn.cu)


def flash_ops(d):
    """Operations per cost entry and pass of #7: d multiply-adds (2d) for
    the dot product, the norms' add, the -2 x.y term, the subtraction from
    the potential, the scale by 1/reg, the subtraction of the running max,
    the exp (counted as one operation) and the add to the running sum."""
    return 2 * d + 7


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
    """Phase 3: kernel vs plain version at the training and generation
    shapes and BLOCK_SHAPES (ragged S on both bf16 attention routes, head
    dims 128 and 192), each run twice: the rerun must give the same bits.
    Returns the largest bf16 error at the training and generation shapes."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.ops import attn_block as ab

    worst = 0.0
    for N, S, C, H in ((TRAIN_BATCH, 256, 256, 4), (GEN_BATCH, 256, 256, 4)) + BLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = block_inputs(N, S, C, dtype)
            args = list(t.values()) + [H, G]
            with torch.no_grad(), strict_f32():
                y = ab.fused_attention_block(*args)
                again = ab.fused_attention_block(*args)
                ref = ab.attention_block_reference(*args)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs()
            tol = TOL[str(dtype).split(".")[1]]
            bad = (err > tol + tol * ref.float().abs()).sum().item()
            log(f"attn_block_fwd N={N} S={S} C={C} H={H} {dtype}: max abs err "
                f"{err.max().item():.3e}, {bad} of {err.numel()} outside {tol} abs+rel; "
                f"the rerun gives the same bits")
            if bad or not torch.isfinite(y).all():
                raise AssertionError(f"attn_block_fwd disagrees with its plain version at "
                                     f"N={N} S={S} C={C} H={H} {dtype}")
            if not torch.equal(y, again):
                raise AssertionError(f"attn_block_fwd's rerun differs at N={N} S={S} C={C} "
                                     f"H={H} {dtype}")
            if dtype == torch.bfloat16 and N in (TRAIN_BATCH, GEN_BATCH):
                worst = max(worst, err.max().item())
    return worst


def time_attn_block(N, S=256, C=256, H=4, G=32):
    """Phase 4: #1 at batch N and S, C, H, bf16, by device time in turns with
    the library composition (``F.group_norm``, ``F.linear``, SDPA,
    ``F.linear``; kernel, library, library, kernel), as ``time_attention``
    times #3; with its device operations per call, its kernels' device
    times, and by CUDA events around 20 eager calls; beside the plain
    version and the f32 kernel."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import attn_block as ab

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

    kernel = lambda: ab.fused_attention_block(*args)
    with torch.no_grad():
        turns = {"kernel": [], "library": []}
        ops = []
        for who in ("kernel", "library", "library", "kernel"):
            fn = kernel if who == "kernel" else library
            ms, n_ops = device_ms_and_launches(fn)
            turns[who].append((ms, cuda_ms(fn)))
            if who == "kernel":
                ops.append(n_ops)
        _, events = traced(lambda: (kernel(), torch.cuda.synchronize()), "one #1 call")
        plain_ms = cuda_ms(lambda: ab.attention_block_reference(*args), iters=5)
        t32 = block_inputs(N, S, C, torch.float32)
        ms_f32 = cuda_ms(lambda: ab.fused_attention_block(*t32.values(), H, G), iters=10)
    mean = {who: sum(a for a, _ in ts) / len(ts) for who, ts in turns.items()}
    ms, lib_ms = mean["kernel"], mean["library"]
    flops = N * (2 * S * C * 3 * C + 2 * 2 * H * S * S * D + 2 * S * C * C)
    nbytes = 2 * N * S * C * 2 + 4 * (C * 3 * C + 3 * C + C * C + 3 * C)  # x, y bf16; f32 weights
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    fmt = lambda ts, i: ", ".join(f"{v[i]:.4f}" for v in ts)
    name = lambda k: k.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    stages = "; ".join(f"{name(e.key)} {e.self_device_time_total / e.count / 1e3:.4f}"
                       for e in sorted(events, key=lambda e: -e.self_device_time_total))
    log(f"attn_block_fwd timing N={N} S={S} C={C} H={H} bf16, device time: kernel {ms:.4f} ms "
        f"({fmt(turns['kernel'], 0)}; {flops / ms / 1e9:.2f} TFLOP/s, "
        f"{100 * bound_ms / ms:.2f}% of the {bound_ms:.4f} ms bound by {bound_by}), library "
        f"{lib_ms:.4f} ms ({fmt(turns['library'], 0)}), kernel / library {ms / lib_ms:.3f}; "
        f"device operations a call {ops}; its kernels (ms): {stages}; eager, 20 calls between "
        f"CUDA events: kernel {fmt(turns['kernel'], 1)}, library {fmt(turns['library'], 1)} ms; "
        f"plain {plain_ms:.4f} ms; f32 kernel {ms_f32:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def grad_errors(out, ref):
    """Per gradient: dx's largest absolute error, and each weight gradient's
    largest error over its plain version's max-abs."""
    errs = {}
    for name, o, r in zip(GRADS, out, ref):
        scale = 1.0 if name == "dx" else r.float().abs().max().item()
        errs[name] = (o.float() - r.float()).abs().max().item() / scale
    return errs


def check_attn_block_bwd(G=32):
    """Phase 3: the backward kernel vs its plain version at the training
    shape and at phase 3's other shapes, f32 (TF32 off) and bf16. dx is held
    element-wise to TOL abs+rel; each f32 weight gradient to WGRAD_TOL of
    its own max-abs (they are sums over N*S rows, so their elements span a
    wide range). In bf16 the plain backward with do and ds rounded to bf16
    is read as well, and must fall outside WGRAD_TOL: the check would catch
    a kernel that rounded them; and a rerun must give the same bits (every
    sum over partials has a fixed order). Returns the largest bf16 dx error
    at the training shape."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.ops import attn_block as ab

    worst = 0.0
    for N, S, C, H in ((TRAIN_BATCH, 256, 256, 4),) + BLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = block_inputs(N, S, C, dtype)
            dy = block_inputs(N, S, C, dtype, seed=1)["x"]
            args = list(t.values()) + [dy, H, G]
            with strict_f32():
                out = ab.fused_attention_block_bwd(*args)
                again = ab.fused_attention_block_bwd(*args) if dtype == torch.bfloat16 else out
                ref = ab.attention_block_backward_reference(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(o, a) for o, a in zip(out, again)):
                raise AssertionError(f"attn_block_bwd's rerun differs at N={N} S={S} C={C} "
                                     f"H={H} {dtype}")
            key = str(dtype).split(".")[1]
            tol, wtol = TOL[key], WGRAD_TOL[key]
            bad_dx = ((out[0].float() - ref[0].float()).abs()
                      > tol + tol * ref[0].float().abs()).sum().item()
            errs = grad_errors(out, ref)
            bad = [n for n in GRADS[1:] if not errs[n] <= wtol] + (["dx"] if bad_dx else [])
            if bad or not all(torch.isfinite(o).all() for o in out):
                raise AssertionError(f"attn_block_bwd {bad} disagree with the plain version at "
                                     f"N={N} S={S} C={C} H={H} {dtype}: {errs}")
            line = ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            if dtype == torch.bfloat16:
                if N == TRAIN_BATCH:
                    worst = errs["dx"]
                with strict_f32():
                    rounded = grad_errors(ab.attention_block_backward_reference(
                        *args, round_do_ds=True), ref)
                caught = max(rounded[n] for n in GRADS[1:])
                if not caught > wtol:
                    raise AssertionError(f"rounding do and ds to bf16 moves the weight gradients "
                                         f"by {caught:.2e}, inside the {wtol} limit")
                line += "; do and ds rounded to bf16 would read " + ", ".join(
                    f"{n} {e:.2e}" for n, e in rounded.items())
            rerun = "; a rerun gives the same bits" if dtype == torch.bfloat16 else ""
            log(f"attn_block_bwd N={N} S={S} C={C} H={H} {dtype}: max error (dx abs, weights "
                f"relative to max-abs) {line}{rerun}")
    return worst


def attention_inputs(N, H, S, D, dtype, seed=0):
    """qkv_t (N, 3, H, S, D) and an output gradient (N, H, S, D) on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((N, 3, H, S, D), generator=g, device="cuda").to(dtype),
            torch.randn((N, H, S, D), generator=g, device="cuda").to(dtype))


def check_attention():
    """Phase 3: the multi-head attention forward (#3) and backward (#4, through
    the autograd Function) against their plain versions, element-wise within
    TOL abs + rel, at ATTN_SHAPES in float32 (TF32 off) and bfloat16; the
    bf16 backward called again on the same inputs must give the same bits.
    Returns the largest bf16 forward and backward errors at the ImageNet-64
    shapes."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.ops import attention as att

    worst = {"fwd": 0.0, "bwd": 0.0}
    for N, H, S, D in ATTN_SHAPES:
        scale = 1.0 / math.sqrt(D)
        for dtype in (torch.float32, torch.bfloat16):
            qkv, do = attention_inputs(N, H, S, D, dtype)
            leaf = qkv.clone().requires_grad_()
            launched = (att.attention_t.launches, att.attention_t_bwd.launches)
            with strict_f32():
                out = att.attention_t(leaf, scale)
                out.backward(do)
                with torch.no_grad():
                    ref = att.attn_reference_t(qkv, scale)
                    ref_bwd = att.attention_t_bwd_reference(qkv, do, scale)
            torch.cuda.synchronize()
            gated = att.gate(H, S, D, dtype)  # (2, 2, 896, 64) passes in bf16 only
            if (att.attention_t.launches - launched[0], att.attention_t_bwd.launches
                    - launched[1]) != (int(gated), int(gated)):
                raise AssertionError(f"attention at N={N} H={H} S={S} D={D} {dtype} launched "
                                     f"the kernels otherwise than the gate says ({gated})")
            key = str(dtype).split(".")[1]
            tol, errs = TOL[key], {}
            for name, a, r in (("fwd", out, ref), ("bwd", leaf.grad, ref_bwd)):
                e = (a.float() - r.float()).abs()
                errs[name] = e.max().item()
                if (e > tol + tol * r.float().abs()).any() or not torch.isfinite(a).all():
                    raise AssertionError(f"attention_{name} disagrees with its plain version at "
                                         f"N={N} H={H} S={S} D={D} {dtype}: max error "
                                         f"{errs[name]:.3e}")
                if dtype == torch.bfloat16 and (N, H, S, D) in ATTN_SHAPES[:2]:
                    worst[name] = max(worst[name], errs[name])
            rerun = ""
            if dtype == torch.bfloat16:
                again = att.attention_t_bwd(qkv, do.contiguous(), scale)
                torch.cuda.synchronize()
                if not torch.equal(again, leaf.grad):
                    raise AssertionError(f"attention_bwd at N={N} H={H} S={S} D={D} gave other "
                                         f"bits on a rerun")
                rerun = "; the backward's rerun gives the same bits"
            route = "" if gated else " (refused by the gate: the plain composition, as in JAX)"
            log(f"attention N={N} H={H} S={S} D={D} {dtype}{route}: max abs err forward "
                f"{errs['fwd']:.3e}, backward {errs['bwd']:.3e} (within {tol} abs+rel){rerun}")
    return worst


def attention_bound(N, H, S, D, backward):
    """(bound ms, bound_by) of #3 or #4 in bf16 at (N, H, S, D). Bytes: qkv and
    the output (and do, dqkv) once. Operations: 2 Z S^2 D per product over
    Z = N H pairs, at the bf16 tensor-core rate: the forward's two products;
    the backward's logits recompute, dp and dv, and dq and dk from the f32 ds
    counted as three bf16 products each, the least the card needs to compute
    them exactly (ds = hi + mid + lo in bf16, each product exact). Counting
    dq and dk at the non-tensor f32 rate instead would let a kernel that
    takes the split read above 100% of its bound."""
    prod = 2 * N * H * S * S * D
    elems = N * H * S * D
    if backward:
        nbytes, ops_s = 2 * (3 * elems + elems + 3 * elems), (3 + 2 * 3) * prod / PEAK_BF16_FLOPS
    else:
        nbytes, ops_s = 2 * (3 * elems + elems), 2 * prod / PEAK_BF16_FLOPS
    bytes_s = nbytes / PEAK_BYTES
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def traced(fn, what, host=False):
    """Runs ``fn``, which ends in a ``torch.cuda.synchronize()``, once under
    ``torch.profiler``, tracing the device (and the host operators if
    ``host``), and returns ``(prof, events)``: the profile
    and its device events with device time. On the card a session now and
    then records no device event at all (once, the first session of a run),
    so each session is padded with PROFILE_PAD_S of idle host time on both
    sides (kineto keeps a device event only inside the session's window),
    and a session that recorded none is logged and run again, up to
    PROFILE_TRIES sessions; ``events`` is empty when none recorded any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    for session in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            fn()
            time.sleep(PROFILE_PAD_S)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if events:
            return prof, events
        log(f"  the profiler recorded no device time over {what} (session {session} of "
            f"{PROFILE_TRIES}, {len(prof.events())} events in all)")
    return prof, []


def device_ms(fn, calls=20):
    """Device time per call of ``fn``: the self device time of every kernel
    the profiler records over ``calls`` calls (after three warm-up calls),
    divided by ``calls``. Unlike CUDA events around a run of eager calls, it
    does not count the device idling while the host prepares the next call."""
    return device_ms_and_launches(fn, calls)[0]


def device_ms_and_launches(fn, calls=20):
    """``device_ms`` and the device operations (kernels, copies, fills) the
    profiler records per call. Where no session records device time, the
    time is taken by CUDA events around the calls instead (``cuda_ms``, host
    time included) and the operations are None: not measured."""
    import torch

    for _ in range(3):
        fn()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    _, events = traced(run, f"{calls} calls")
    if not events:
        log("  not measured by the profiler: the time below is by CUDA events")
        return cuda_ms(fn, iters=calls), None
    us = sum(e.self_device_time_total for e in events)
    return us / calls / 1e3, sum(e.count for e in events) / calls


def time_attention():
    """Phase 4: #3 and #4 at the ImageNet-64 training shape (N=32, 9 heads,
    S=256, D=64), bf16, beside their plain versions and the library
    yardsticks: ``F.scaled_dot_product_attention`` on the same q, k, v for #3
    and the backward alone of autograd through it for #4. Kernel and library
    are timed in turns (kernel, library, library, kernel), by device time
    (``device_ms``: what the JSON record keeps) and by CUDA events around 20
    eager calls (host time included where the host is slower than the card).
    #4 takes dq and dk as three exact bf16 products; its f32 FMA variant is
    timed in the same turns, the A/B behind that choice."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import attention as att

    N, H, S, D = ATTN_SHAPES[0]
    scale = 1.0 / math.sqrt(D)
    qkv, do = attention_inputs(N, H, S, D, torch.bfloat16)
    q, k, v = (t.detach().requires_grad_() for t in qkv.unbind(1))
    y = F.scaled_dot_product_attention(q, k, v)
    fns = {"attention_fwd": (lambda: att.attention_t(qkv, scale),
                             lambda: F.scaled_dot_product_attention(q.detach(), k.detach(),
                                                                    v.detach())),
           "attention_bwd": (lambda: att.attention_t_bwd(qkv, do, scale),
                             lambda: torch.autograd.grad(y, (q, k, v), do, retain_graph=True))}
    fma = lambda: att._backward(qkv, do, scale, split=False)
    out = {}
    for name, (kernel, library) in fns.items():
        turns = {"kernel": [], "library": [], "fma": []}
        for who in ("kernel", "library", "library", "kernel"):
            fn = kernel if who == "kernel" else library
            turns[who].append((device_ms(fn), cuda_ms(fn)))
            if name == "attention_bwd" and who == "kernel":
                turns["fma"].append((device_ms(fma), cuda_ms(fma)))
        mean = {who: [sum(t[i] for t in ts) / len(ts) for i in (0, 1)]
                for who, ts in turns.items() if ts}
        with torch.no_grad():
            plain = (att.attn_reference_t if name == "attention_fwd"
                     else att.attention_t_bwd_reference)
            plain_ms = cuda_ms(lambda: plain(qkv, scale) if name == "attention_fwd"
                               else plain(qkv, do, scale), iters=5)
        bound_ms, bound_by = attention_bound(N, H, S, D, name == "attention_bwd")
        ms, lib_ms = mean["kernel"][0], mean["library"][0]
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        fmt = lambda ts: ", ".join(f"{a:.4f}" for a, _ in ts)
        eager = lambda ts: ", ".join(f"{b:.4f}" for _, b in ts)
        line = (f"{name} timing N={N} H={H} S={S} D={D} bf16, device time: kernel {ms:.4f} ms "
                f"({fmt(turns['kernel'])}; {100 * bound_ms / ms:.1f}% of the {bound_ms:.4f} ms "
                f"bound by {bound_by}), library {lib_ms:.4f} ms ({fmt(turns['library'])}), "
                f"kernel / library {ms / lib_ms:.3f}")
        if turns["fma"]:
            line += (f"; the FMA variant of dq and dk {mean['fma'][0]:.4f} ms "
                     f"({fmt(turns['fma'])}), split / FMA {ms / mean['fma'][0]:.3f}")
        line += (f"; eager, 20 calls between CUDA events: kernel {eager(turns['kernel'])}, "
                 f"library {eager(turns['library'])}")
        if turns["fma"]:
            line += f", FMA {eager(turns['fma'])}"
        log(line + f" ms; plain {plain_ms:.4f} ms")
    return out


def auction_cost(n, kind, seed):
    """An (n, n) cost on the card: squared distances of Gaussian clouds,
    small integers (heavy ties), duplicated rows and columns, or rank 1."""
    import torch
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost

    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "gauss":
        return sq_euclidean_cost(torch.randn(n, 16, generator=g, device="cuda"),
                                 torch.randn(n, 16, generator=g, device="cuda"))
    if kind == "ties":
        return torch.randint(0, 4, (n, n), generator=g, device="cuda").float()
    if kind == "dups":
        a = torch.randn(n, 8, generator=g, device="cuda")
        a[1::2] = a[::2][: n // 2]
        return sq_euclidean_cost(a, a.flip(0))
    return torch.arange(n, device="cuda").float()[None, :].expand(n, n).contiguous()


def check_auction():
    """Phase 3: the auction kernel's perm must be identical to its plain
    version's, round count included, on a rerun too, and its cost within
    1e-5 relative of scipy's optimum."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    fn = au.pallas_auction_assignment
    for n in (2, 64, 128, 200, 256, 512):
        line = []
        for kind in ("gauss", "ties", "dups", "rank1"):
            cost = auction_cost(n, kind, seed=n)
            perm = fn(cost)
            k_rounds = int(fn.last_rounds.item())
            again = fn(cost)
            k_again = int(fn.last_rounds.item())
            ref, rounds = au.auction_assignment_onehot(cost)
            torch.cuda.synchronize()
            if not torch.equal(perm, ref) or k_rounds != rounds:
                raise AssertionError(f"auction n={n} {kind}: the kernel's perm or round count "
                                     f"({k_rounds} vs {rounds}) differs from its plain version")
            if not torch.equal(again, perm) or k_again != k_rounds:
                raise AssertionError(f"auction n={n} {kind}: a rerun gives another perm or "
                                     f"round count ({k_again} vs {k_rounds})")
            c = cost.double().cpu().numpy()
            r, col = linear_sum_assignment(c)
            opt, got = c[r, col].sum(), c[r, perm.cpu().numpy()].sum()
            if abs(got - opt) > 1e-5 * max(abs(opt), 1e-30):
                raise AssertionError(f"auction n={n} {kind}: cost {got} vs scipy's {opt}")
            line.append(f"{kind} {rounds} rounds")
        log(f"auction n={n}: identical perms, on a rerun too; " + ", ".join(line)
            + "; costs at scipy's optimum")


def coupling_cost(seed=0):
    """The coupling's cost at the training shape: B=128 images vs N(0, I)."""
    import torch
    from cfm_tpu_torch.data.images import load_cifar10, normalize_images
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost

    data, _ = load_cifar10(synthetic=True)
    x1 = normalize_images(torch.from_numpy(data[:TRAIN_BATCH]).cuda())
    x0 = torch.randn(x1.shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    return sq_euclidean_cost(x0, x1)


def twod_cost():
    """2d_otcfm's coupling cost: a batch of 256 8-Gaussian points against
    256 moons points, drawn as the preset's ``Trainer`` draws a step's."""
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost
    from cfm_tpu_torch.trainer import Trainer

    trainer = Trainer(load_config("2d_otcfm", ["trainer.ckpt_interval=0"]))
    return sq_euclidean_cost(*trainer._vectors())


def time_auction():
    """Phase 4 at the main paths' two shapes: n = 128 (the image recipes'
    coupling, ``coupling_cost``) and n = 256 (2d_otcfm's, ``twod_cost``).
    For each: the wrapper's time by CUDA events, the kernel's device time by
    the profiler and the device operations a call makes (one: the launch),
    rounds, us a round, row scans, and the bound: the row scans this run's
    data needs times n element operations over the f32 rate, against the
    cost read once and the result written once over the HBM rate (loose: a
    solve is dependent rounds). No PyTorch call computes an assignment;
    scipy's solver is timed on the host instead. Returns n = 128's record."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    fn = au.pallas_auction_assignment
    out = {}
    for cost in (coupling_cost(), twod_cost()):
        n = cost.shape[0]
        ms = cuda_ms(lambda: fn(cost))
        dev_ms, ops = device_ms_and_launches(lambda: fn(cost))
        rounds, scans = int(fn.last_rounds.item()), int(fn.last_row_scans.item())
        plain_ms = cuda_ms(lambda: au.auction_assignment_onehot(cost), iters=2, warmup=1)
        c = cost.double().cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(20):
            linear_sum_assignment(c)
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        ops_s = scans * n / PEAK_F32_FLOPS
        bytes_s = (n * n * 4 + (n + 2) * 8) / PEAK_BYTES
        bound_ms = max(ops_s, bytes_s) * 1e3
        by = "operations" if ops_s >= bytes_s else "bytes"
        ops_txt = "not measured" if ops is None else f"{ops:g}"
        log(f"auction timing n={n}: wrapper {ms:.4f} ms, kernel {dev_ms:.4f} ms device time, "
            f"{ops_txt} device operation(s) a call; {rounds} rounds ({1e3 * dev_ms / rounds:.3f} us "
            f"per round), {scans} row scans; bound {bound_ms:.6f} ms by {by} (loose); plain "
            f"{plain_ms:.3f} ms; scipy on the host {host_ms:.4f} ms (host time)")
        if ops is not None and not 0.9 <= ops <= 1:  # it may drop one event of twenty, never add one
            raise AssertionError(f"auction n={n}: {ops} device operations a call, expected 1")
        out[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                      library_ms=None)
    return out[128]


def check_auction_tiled():
    """Phase 3: the tiled auction kernel (#6) must give its plain version's
    perm and round count on Gaussian, tied, duplicated and rank-1 costs at
    n = 256, 1024 and 2048 (the 2-D evaluation's size), and on the
    evaluation's W1 and W2 costs at 1024 and 2048. The plain version takes
    about 1 ms a round on the card (rank 1 at n = 2048, where every row bids
    in most rounds, some 60k rounds), so at n = 4096 (row tile 128, the
    benefit in HBM) the kernel's permutation is held to scipy's alone: every
    checked permutation must be valid and its cost within 1e-5 relative of
    scipy's optimum."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    fn = au.pallas_auction_assignment_tiled
    kinds = ("gauss", "ties", "dups", "rank1", "w1", "w2")
    cases = [(256, k) for k in kinds[:4]] + [(1024, k) for k in kinds]
    cases += [(2048, k) for k in kinds] + [(4096, "w1")]
    for n, kind in cases:
        cost = (eval_cost(n, seed=n, power=int(kind[1])) if kind in ("w1", "w2")
                else auction_cost(n, kind, seed=n))
        perm = fn(cost)
        torch.cuda.synchronize()
        k_rounds, scans = int(fn.last_rounds.item()), int(fn.last_row_scans.item())
        line = f"tiled auction n={n} {kind}: {k_rounds} rounds, {scans} row scans"
        if n < 4096:
            t0 = time.perf_counter()
            ref, rounds = au.auction_assignment_tiled_reference(cost)
            torch.cuda.synchronize()
            if not torch.equal(perm, ref) or k_rounds != rounds:
                raise AssertionError(f"{line}: the kernel's perm or round count ({k_rounds} vs "
                                     f"{rounds}) differs from its plain version")
            line += f"; identical to the plain version ({time.perf_counter() - t0:.1f} s)"
        if sorted(perm.tolist()) != list(range(n)):
            raise AssertionError(f"{line}: not a permutation")
        c = cost.double().cpu().numpy()
        r, col = linear_sum_assignment(c)
        opt, got = c[r, col].sum(), c[r, perm.cpu().numpy()].sum()
        if abs(got - opt) > 1e-5 * max(abs(opt), 1e-30):
            raise AssertionError(f"{line}: cost {got} vs scipy's {opt}")
        log(f"{line}; cost {got:.6f}, scipy's optimum {opt:.6f}")


def eval_cost(n, seed, power=1):
    """The 2-D evaluation's cost: n points of the moons target against n
    others (a trained model's samples lie on the moons), squared distances
    (power 2) or their square roots (power 1, the harder solve)."""
    import torch
    from cfm_tpu_torch.data.toy import sample_moons
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost

    g = torch.Generator(device="cuda").manual_seed(seed)
    c = sq_euclidean_cost(sample_moons(g, n), sample_moons(g, n))
    return torch.sqrt(c + 1e-30) if power == 1 else c


def time_auction_tiled():
    """Phase 4: #6 at n = 1024, 2048 (the 2-D evaluation's size) and 4096 on
    the W1 evaluation cost, beside its plain version, scipy's solver on the
    host and a bound. The kernel's time is the wrapper's. The bound counts
    the work this run's data needs: the row scans the kernel counted times n
    elements, as element operations over the f32 rate and as bytes (4 a
    value) over the HBM rate; it is loose, as dependent rounds set the time.
    No PyTorch call computes an assignment."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    fn = au.pallas_auction_assignment_tiled
    for n in (1024, 2048, 4096):
        cost = eval_cost(n, seed=n + 1)
        ms = cuda_ms(lambda: fn(cost), iters=3, warmup=1)
        rounds, scans = int(fn.last_rounds.item()), int(fn.last_row_scans.item())
        plain = "not timed at 4096 (70k+ rounds of about 1.5 ms)"
        if n < 4096:
            t0 = time.perf_counter()
            au.auction_assignment_tiled_reference(cost)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain = f"{plain_ms:.1f} ms"
        c = cost.double().cpu().numpy()
        t0 = time.perf_counter()
        linear_sum_assignment(c)
        host_ms = (time.perf_counter() - t0) * 1e3
        ops_s, bytes_s = scans * n / PEAK_F32_FLOPS, scans * n * 4 / PEAK_BYTES
        bound_ms = max(ops_s, bytes_s) * 1e3
        log(f"tiled auction timing n={n} (W1 evaluation cost): kernel {ms:.3f} ms for {rounds} "
            f"rounds ({1e3 * ms / rounds:.3f} us per round) and {scans} row scans "
            f"({scans / n:.1f} per row); bound {bound_ms:.4f} ms by "
            f"{'bytes' if bytes_s >= ops_s else 'operations'} (loose); plain {plain}; "
            f"scipy on the host {host_ms:.1f} ms (host time)")
        if n == 2048:
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by="bytes" if bytes_s >= ops_s else "operations", library_ms=None)
    return out


def bwd_flops(N, S, C, H):
    """FLOPs of the backward, recompute included, all at the bf16 tensor-core
    rate: qkv, logits, attn, dattn, dwo, dwq, dtokens take model-dtype
    operands; dp, dq, dk, dv take an f32 one (do or ds), which the card
    computes exactly as three bf16 products each (the f32 value split into
    bf16 hi + mid + lo), the least it needs, as ``attention_bound`` counts
    #4's dq and dk. Counting them at the non-tensor f32 rate instead would
    let a kernel that takes the split read above 100% of its bound."""
    D, M, Z = C // H, N * S, N * H
    att = 2 * Z * S * S * D
    lp = 2 * M * C * 3 * C + 2 * att + 2 * (2 * M * C * C) + 2 * (2 * M * C * 3 * C)
    return lp + 3 * 4 * att


def time_attn_block_bwd(N=TRAIN_BATCH, S=256, C=256, H=4, G=32):
    """Phase 4 at a training shape (by default CIFAR-10's, N=128, S=256,
    C=256), bf16, by device time in turns with the library composition (the
    backward alone of F.group_norm + F.linear + scaled_dot_product_attention
    + F.linear + residual in bf16; kernel, library, library, kernel), as
    ``time_attn_block`` times #1; with its device operations a call and its
    kernels' device times, and by CUDA events around 20 eager calls; beside
    the plain version."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import attn_block as ab

    D = C // H
    t = block_inputs(N, S, C, torch.bfloat16)
    dy = block_inputs(N, S, C, torch.bfloat16, seed=1)["x"]
    args = list(t.values()) + [dy, H, G]
    xl = t["x"].detach().requires_grad_()
    w = {k: v.detach().to(torch.bfloat16).requires_grad_() for k, v in t.items() if k != "x"}
    tok = F.group_norm(xl.transpose(1, 2), G, w["gscale"][0], w["gbias"][0]).transpose(1, 2)
    q, k, v = F.linear(tok, w["wq"].T, w["bq"][0]).view(N, S, 3, H, D).permute(2, 0, 3, 1, 4)
    ctx = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(N, S, C)
    y = xl + F.linear(ctx, w["wo"].T, w["bo"][0])
    inputs = [xl] + list(w.values())
    kernel = lambda: ab.fused_attention_block_bwd(*args)
    library = lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)
    turns = {"kernel": [], "library": []}
    ops = []
    for who in ("kernel", "library", "library", "kernel"):
        fn = kernel if who == "kernel" else library
        ms, n_ops = device_ms_and_launches(fn)
        turns[who].append((ms, cuda_ms(fn)))
        if who == "kernel":
            ops.append(n_ops)
    _, events = traced(lambda: (kernel(), torch.cuda.synchronize()), "one #2 call")
    plain_ms = cuda_ms(lambda: ab.attention_block_backward_reference(*args), iters=3)
    mean = {who: sum(a for a, _ in ts) / len(ts) for who, ts in turns.items()}
    ms, lib_ms = mean["kernel"], mean["library"]
    flops = bwd_flops(N, S, C, H)
    ops_s = flops / PEAK_BF16_FLOPS
    nbytes = 3 * N * S * C * 2 + 2 * 4 * (C * 3 * C + 3 * C + C * C + 3 * C)
    bytes_s = nbytes / PEAK_BYTES
    bound_ms = max(ops_s, bytes_s) * 1e3
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    fmt = lambda ts, i: ", ".join(f"{v[i]:.4f}" for v in ts)
    name = lambda k: k.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
    stages = "; ".join(f"{name(e.key)} x{e.count} {e.self_device_time_total / 1e3:.4f}"
                       for e in sorted(events, key=lambda e: -e.self_device_time_total))
    log(f"attn_block_bwd timing N={N} S={S} C={C} H={H} bf16, device time: kernel {ms:.4f} ms "
        f"({fmt(turns['kernel'], 0)}; {flops / ms / 1e9:.2f} TFLOP/s, {flops / 1e9:.2f} GFLOP "
        f"counting dp, dq, dk, dv as three bf16 products each; {100 * bound_ms / ms:.2f}% of the "
        f"{bound_ms:.4f} ms bound by {bound_by}), library backward {lib_ms:.4f} ms "
        f"({fmt(turns['library'], 0)}), kernel / library {ms / lib_ms:.3f}; device operations a "
        f"call {ops}; its kernels (launches, ms in one call): {stages}; eager, 20 calls between "
        f"CUDA events: kernel {fmt(turns['kernel'], 1)}, library {fmt(turns['library'], 1)} ms; "
        f"plain {plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def mnist_model(device="cuda"):
    """The ``mnist_otcfm_cond`` preset's UNet (bf16, 10 classes), flax's
    initialisation from seed 0, as its ``Trainer`` builds it."""
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.trainer import build_model

    return build_model(load_config("mnist_otcfm_cond"), device)


def record_gn_shapes(imagenet):
    """Phase 3: the (N, H, W, C, groups, dtype, SiLU) tuples, with their counts,
    that ``GroupNorm32`` gives the GroupNorm wrapper in one model evaluation of
    each path at its batch: CIFAR-10 generation (512) and training (128, in
    train mode), MNIST training (128) and generation (80, 8 per class), and
    the ImageNet-64 model ``imagenet`` in generation (64) and training (32, in
    train mode)."""
    import torch
    from cfm_tpu_torch.models import unet

    wrapped, seen = unet.fused_group_norm_silu, []

    def recording(x, scale, bias, num_groups=32, eps=1e-5, apply_silu=True):
        seen.append(tuple(x.shape) + (num_groups, str(x.dtype).split(".")[1], apply_silu))
        return wrapped(x, scale, bias, num_groups, eps, apply_silu)

    paths = {}
    unet.fused_group_norm_silu = recording
    try:
        recipe, mnist = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0), mnist_model()
        train = dict(train=True, generator=torch.Generator(device="cuda"))
        with torch.no_grad():
            for name, model, n, dim, kw in (
                    ("cifar10 generation", recipe, GEN_BATCH, RECIPE["dim"], {}),
                    ("cifar10 training", recipe, TRAIN_BATCH, RECIPE["dim"], train),
                    ("mnist training", mnist, TRAIN_BATCH, (28, 28, 1), {}),
                    ("mnist generation", mnist, MNIST_GEN, (28, 28, 1), {}),
                    ("imagenet64 generation", imagenet, IMAGENET_GEN, IMAGENET64["dim"], {}),
                    ("imagenet64 training", imagenet, IMAGENET_BATCH, IMAGENET64["dim"], train)):
                seen.clear()
                y = (torch.arange(n, device="cuda") % 10,) if model is not recipe else ()
                model(torch.rand(n, device="cuda"), torch.randn((n,) + dim, device="cuda"), *y, **kw)
                paths[name] = {k: seen.count(k) for k in dict.fromkeys(seen)}
                if len(seen) != GN_PER_EVAL[name.split()[0]]:
                    raise AssertionError(f"{name}: {len(seen)} GroupNorm calls per evaluation")
    finally:
        unet.fused_group_norm_silu = wrapped
    for name, shapes in paths.items():
        log(f"GroupNorm shapes, {name}: " + ", ".join(
            f"{n}x{h}x{w}x{c}/{g} {dt}{' silu' if silu else ''} x{k}"
            for (n, h, w, c, g, dt, silu), k in shapes.items()))
    return paths


def gn_inputs(N, H, W, C, dtype, seed=0, mean=0.5, std=2.0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    return ((mean + std * r(N, H, W, C)).to(dtype), 1 + 0.1 * r(C), 0.1 * r(C),
            r(N, H, W, C).to(dtype))


def check_gn_case(x, scale, bias, dy, G, silu, what):
    """#8 and #9 against the plain versions on the same card tensors: out and
    dx element-wise within TOL abs + rel; mean within 1e-5 of |mean| + std and
    inv within 1e-5 relative; dscale and dbias within WGRAD_TOL of their
    max-abs. Returns the largest absolute out and dx errors."""
    import torch
    from cfm_tpu_torch.ops import groupnorm as gn

    key = str(x.dtype).split(".")[1]
    tol, wtol = TOL[key], WGRAD_TOL[key]
    out, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
    dx, dscale, dbias = gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy, G, silu)
    r_out, r_mean, r_inv = gn.gn_silu_fwd_reference(x, scale, bias, G, 1e-5, silu)
    r_dx, r_ds, r_db = gn.gn_silu_bwd_reference(x, scale, bias, r_mean, r_inv, dy, G, silu)
    torch.cuda.synchronize()
    errs, bad = {}, []
    for name, a, r in (("out", out, r_out), ("dx", dx, r_dx)):
        e = (a.float() - r.float()).abs()
        errs[name] = e.max().item()
        if (e > tol + tol * r.float().abs()).any() or not torch.isfinite(a).all():
            bad.append(name)
    errs["mean"] = ((mean - r_mean).abs() / (r_mean.abs() + 1 / r_inv)).max().item()
    errs["inv"] = ((inv - r_inv).abs() / r_inv).max().item()
    bad += [k for k in ("mean", "inv") if not errs[k] <= 1e-5]
    for name, a, r in (("dscale", dscale, r_ds), ("dbias", dbias, r_db)):
        errs[name] = (a - r).abs().max().item() / r.abs().max().item()
        if not errs[name] <= wtol:
            bad.append(name)
    if bad:
        raise AssertionError(f"GroupNorm kernels: {bad} disagree with the plain versions at "
                             f"{what}: {errs}")
    return errs


def check_gn(paths):
    """Phase 3: every recorded shape, then the recentred-variance case: f32
    at mean 100, std 1 (the inputs of tests/test_torch_groupnorm.py's
    recentred case, made the same way), where a one-pass E[x^2] - E[x]^2
    variance in f32, computed here too, misses the float64 result by more
    than 10 times TOL (the card's tree sums read 3.6e-3; the CPU's 9.0e-3).
    Returns the largest out and dx errors over the shapes."""
    import numpy as np
    import torch

    from cfm_tpu_torch.ops import groupnorm as gn

    worst = {"out": 0.0, "dx": 0.0}
    shapes = dict.fromkeys(k for p in paths.values() for k in p)
    for i, (N, H, W, C, G, dt, silu) in enumerate(shapes):
        x, scale, bias, dy = gn_inputs(N, H, W, C, getattr(torch, dt), seed=i)
        errs = check_gn_case(x, scale, bias, dy, G, silu, f"{N}x{H}x{W}x{C} {dt} silu={silu}")
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        first = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
        again = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"gn_silu_fwd's rerun differs at {N}x{H}x{W}x{C} {dt}")
        plan = gn.strip_plan(N, H * W, C, G, x.element_size())
        log(f"gn_silu N={N} {H}x{W}x{C}/{G} {dt} silu={silu}: " +
            ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
            f"; the forward's rerun gives the same bits; plan width {plan.width}, cluster "
            f"{plan.cluster}, items {plan.items}")
    rng = np.random.default_rng(21)
    x = (100.0 + rng.standard_normal((2, 7, 7, 96))).astype(np.float32)
    rng.standard_normal(96), rng.standard_normal(96)  # the test's scale and bias draws
    g = rng.standard_normal(x.shape).astype(np.float32)
    xt, gt = torch.from_numpy(x).cuda(), torch.from_numpy(g).cuda()
    ones, zeros = torch.ones(96, device="cuda"), torch.zeros(96, device="cuda")
    errs = check_gn_case(xt, ones, zeros, gt, 32, False, "the recentred case")
    xd = torch.from_numpy(x).double().reshape(2, 49, 32, 3)
    md = xd.mean(dim=(1, 3), keepdim=True)
    exact = (xd - md) / torch.sqrt(((xd - md) ** 2).mean(dim=(1, 3), keepdim=True) + 1e-5)
    xg = xt.reshape(2, 49, 32, 3)
    m = xg.mean(dim=(1, 3), keepdim=True)
    one_pass = (xg - m) * torch.rsqrt((xg * xg).mean(dim=(1, 3), keepdim=True) - m * m + 1e-5)
    miss = (one_pass.double().cpu() - exact).abs().max().item()
    if not miss > 10 * TOL["float32"]:
        raise AssertionError(f"the recentred case does not tell the variances apart ({miss})")
    log(f"gn_silu recentred case (mean 100, std 1, f32): out {errs['out']:.2e}, dx "
        f"{errs['dx']:.2e}; a one-pass variance would miss by {miss:.2e}")
    return worst


def gn_bound(N, HW, C, itemsize, backward):
    """(bound ms, bound_by): bytes of x (and g, dx) in the model dtype plus
    the f32 vectors and statistics, against the f32 operations."""
    elems = N * HW * C
    if backward:
        nbytes, ops = 3 * elems * itemsize + 2 * N * C * 4 + 4 * C * 4, GN_BWD_OPS * elems
    else:
        nbytes, ops = 2 * elems * itemsize + 2 * N * C * 4 + 2 * C * 4, GN_FWD_OPS * elems
    bytes_s, ops_s = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def graph_ms(fn, reps=10):
    """Device time per call of ``fn``: ``reps`` calls captured in a CUDA
    graph (after one warm-up call outside it) and replayed three times
    between CUDA events, so no host time sits between the calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def time_gn(paths):
    """Phase 4: #8 and #9 at every recorded shape of every path (``paths``,
    from ``record_gn_shapes``), by device time (``graph_ms``), beside their
    bounds and the yardstick ``F.group_norm`` on the NCHW view then
    ``F.silu`` (the forward; bf16 affine parameters, as the library takes
    them); then each path's sums over one evaluation's calls (a training
    step's for the backward). The JSON record keeps CIFAR-10 training's
    largest shape (N = 128, 32x32x128, bf16, SiLU) by the profiler's device
    time (``device_ms``), with the plain versions and the backward's
    yardstick, autograd of the same composition."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import groupnorm as gn

    def library(x, scale, bias, G, silu):
        y = F.group_norm(x.permute(0, 3, 1, 2), G, scale.to(x.dtype), bias.to(x.dtype))
        return F.silu(y) if silu else y

    timed = {}
    for shape in dict.fromkeys(k for p in paths.values() for k in p):
        N, H, W, C, G, dt, silu = shape
        x, scale, bias, dy = gn_inputs(N, H, W, C, getattr(torch, dt))
        with torch.no_grad():
            _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)
            timed[shape] = dict(
                fwd=graph_ms(lambda: gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, silu)),
                bwd=graph_ms(lambda: gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy,
                                                                  G, silu)),
                lib=graph_ms(lambda: library(x, scale, bias, G, silu)),
                bound_fwd=gn_bound(N, H * W, C, x.element_size(), False)[0],
                bound_bwd=gn_bound(N, H * W, C, x.element_size(), True)[0])
        t = timed[shape]
        log(f"gn_silu timing N={N} {H}x{W}x{C}/{G} {dt} silu={silu}, device time: forward "
            f"{t['fwd']:.4f} ms ({100 * t['bound_fwd'] / t['fwd']:.1f}% of its {t['bound_fwd']:.4f} "
            f"ms bound), library {t['lib']:.4f} ms; backward {t['bwd']:.4f} ms "
            f"({100 * t['bound_bwd'] / t['bwd']:.1f}% of {t['bound_bwd']:.4f})")
    for name, shapes in paths.items():
        tot = {k: sum(n * timed[s][k] for s, n in shapes.items())
               for k in ("fwd", "bwd", "lib", "bound_fwd", "bound_bwd")}
        line = (f"GroupNorm over one {name} evaluation's {sum(shapes.values())} calls, device "
                f"time: forward kernels {tot['fwd']:.4f} ms (bound {tot['bound_fwd']:.4f}, "
                f"{tot['fwd'] / tot['bound_fwd']:.2f}x it), library {tot['lib']:.4f} ms")
        if "training" in name:
            line += f"; backward kernels {tot['bwd']:.4f} ms (bound {tot['bound_bwd']:.4f})"
        log(line)

    N, H, C, G = TRAIN_BATCH, 32, 128, 32
    x, scale, bias, dy = gn_inputs(N, H, H, C, torch.bfloat16)
    with torch.no_grad():
        fwd = dict(ms=device_ms(lambda: gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True)),
                   library_ms=device_ms(lambda: library(x, scale, bias, G, True)),
                   plain_ms=cuda_ms(lambda: gn.gn_silu_fwd_reference(x, scale, bias, G, 1e-5, True),
                                    iters=5))
        _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True)
        bwd_ms = device_ms(lambda: gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy, G, True))
    xl, wl, bl = (t.detach().requires_grad_() for t in (x, scale.to(x.dtype), bias.to(x.dtype)))
    y = F.silu(F.group_norm(xl.permute(0, 3, 1, 2), G, wl, bl))
    dyl = dy.permute(0, 3, 1, 2)
    bwd = dict(ms=bwd_ms,
               plain_ms=cuda_ms(lambda: gn.gn_silu_bwd_reference(x, scale, bias, mean, inv, dy, G, True),
                                iters=5),
               library_ms=device_ms(lambda: torch.autograd.grad(y, (xl, wl, bl), dyl,
                                                                retain_graph=True)))
    out = {}
    for name, t, backward in (("gn_silu_fwd", fwd, False), ("gn_silu_bwd", bwd, True)):
        bound_ms, bound_by = gn_bound(N, H * H, C, 2, backward)
        out[name] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name} timing N={N} {H}x{H}x{C} bf16 silu, device time from the profiler (as "
            f"for #1, #3 and #4; the per-shape times above replay CUDA graphs): kernel {t['ms']:.4f} ms "
            f"({100 * bound_ms / t['ms']:.2f}% of the {bound_ms:.4f} ms bound by {bound_by}), "
            f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms")
    return out


def randomize_zero_layers(model, seed):
    """Gives the zero-initialised layers (the ResBlock and output zero convs,
    the attention out-projections, a zero-initialised head) small seeded
    values, so the function is non-trivial and smooth."""
    import torch
    from cfm_tpu_torch.models.unet import AttentionBlock, Conv, Dense

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            zero = [m.weight] if isinstance(m, (Conv, Dense)) and m.zero_init else []
            zero += [m.proj_weight] if isinstance(m, AttentionBlock) else []
            for p in zero:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3 / math.sqrt(p[0].numel()))
    return model


def seeded_model(cfg, dtype, device, seed, dropout=0.0):
    """A UNet with random seeded weights (:func:`randomize_zero_layers`)."""
    from cfm_tpu_torch.models.unet import UNetModelWrapper

    model = UNetModelWrapper(**cfg, dtype=dtype, seed=seed, dropout=dropout, device="cpu")
    return randomize_zero_layers(model, seed + 1).to(device)


def check_small_generation(cfg):
    """Phase 5: the same weights, noise (and labels) on the card and on the CPU."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.generate import generate

    x0 = torch.randn((4,) + cfg["dim"], generator=torch.Generator().manual_seed(3))
    y = torch.arange(4) % 10 if cfg.get("class_cond") else None
    with strict_f32():
        for method in ("euler", "dopri5"):
            out = {}
            for dev in ("cpu", "cuda"):
                model = seeded_model(cfg, torch.float32, dev, seed=2)
                out[dev] = generate(model, 4, x_shape=cfg["dim"], method=method, n_steps=4,
                                    x0=x0, y=y, device=dev)
            diff = (out["cuda"].images.cpu().int() - out["cpu"].images.int()).abs().max().item()
            log(f"small generation {method} ({'ImageNet-64 routing' if y is not None else 'CIFAR'}"
                f"): nfe cuda {out['cuda'].nfe} cpu {out['cpu'].nfe}, max uint8 difference {diff}")
            if diff > 1 or out["cuda"].nfe != out["cpu"].nfe:
                raise AssertionError(f"small {method} generation: card and CPU disagree")


def check_new_models():
    """Phase 5: one forward of ``AttentionPool2d``, ``SuperResModel`` (an odd
    5x5 low-resolution input) and ``EncoderUNetModel`` (every pool) in f32
    (TF32 off), the same weights and inputs on the card and on the CPU,
    within 1e-4 of the output's max-abs. Their UNets route like
    IMAGENET_SMALL: #3 at 16x16, #1 at 8x8, the plain composition at 4x4."""
    import copy

    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.models.unet import (AttentionPool2d, EncoderUNetModel, SuperResModel,
                                           UNetModel)

    g = torch.Generator().manual_seed(5)
    x, t = torch.randn((2, 16, 16, 3), generator=g), torch.tensor([0.3, 0.7])
    trunk = dict(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2, 4),
                 channel_mult=(1, 2, 3), num_head_channels=64, use_scale_shift_norm=True,
                 resblock_updown=True)
    cases = [("AttentionPool2d", lambda: AttentionPool2d(64, 192, 3, 10),
              (torch.randn((2, 8, 8, 192), generator=g),)),
             ("SuperResModel", lambda: SuperResModel(UNetModel(6, out_channels=3, **trunk)),
              (t, x, torch.randn((2, 5, 5, 3), generator=g)))]
    cases += [(f"EncoderUNetModel {pool}", lambda pool=pool: EncoderUNetModel(
        3, out_channels=10, pool=pool, image_size=16, **trunk), (t, x))
        for pool in ("adaptive", "attention", "spatial", "spatial_v2")]
    with strict_f32():
        for name, build, args in cases:
            cpu = randomize_zero_layers(build(), seed=6)
            card = copy.deepcopy(cpu).cuda()
            with torch.no_grad():
                ref, out = cpu(*args), card(*(a.cuda() for a in args))
            torch.cuda.synchronize()
            if not ref.abs().max().item() > 0:
                raise AssertionError(f"{name}: the output is 0, so the check would see nothing")
            err = (out.cpu() - ref).abs().max().item() / ref.abs().max().item()
            log(f"{name} forward f32: card vs CPU {err:.2e} of the output's max-abs, shape "
                f"{tuple(out.shape)}")
            if not err <= 1e-4 or out.shape != ref.shape:
                raise AssertionError(f"{name}: card and CPU disagree ({err})")


def kernel_fns():
    """The launch-counting wrapper of every kernel, by its name in the JSON record."""
    from cfm_tpu_torch.ops import attention as att
    from cfm_tpu_torch.ops import attn_block as ab
    from cfm_tpu_torch.ops import auction as au
    from cfm_tpu_torch.ops import flash_sinkhorn as fs
    from cfm_tpu_torch.ops import groupnorm as gn

    return {"attn_block_fwd": ab.fused_attention_block,
            "attn_block_bwd": ab.fused_attention_block_bwd,
            "attention_fwd": att.attention_t, "attention_bwd": att.attention_t_bwd,
            "auction": au.pallas_auction_assignment,
            "auction_tiled": au.pallas_auction_assignment_tiled,
            "gn_silu_fwd": gn.fused_group_norm_silu, "gn_silu_bwd": gn.fused_group_norm_silu_bwd,
            "flash_sinkhorn": fs.flash_sinkhorn}


def zero_counts():
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def check_small_train_step(cfg):
    """Phase 5: one train step of a small model in f32 (TF32 off) with the
    same draws and the same dropout masks (rate 0.1, drawn from a CPU
    generator on both sides) on the card and on the CPU; a class-conditional
    ``cfg`` has a 10-class embedding and the step carries labels through the
    coupling. Both sides ask for the "pallas" solver, so the card runs the
    auction, both attention-block kernels (and for IMAGENET_SMALL both
    multi-head attention kernels) and both GroupNorm kernels and the CPU
    their plain versions.
    Loss and grad norm agree to 1e-5 relative; each gradient to 1e-4 of its
    tensor's max-abs (or of 1e-3 of the largest gradient, for the tensors
    whose true gradient is 0 and whose values are f32 noise); the updated
    parameters and EMA to 1e-6 absolute (the step moves them by about
    lr = 2e-4). Adam's first step moves an element by lr * g / (|g| + 1e-8),
    about lr whatever g's size, so an element whose gradient is under 1e-3
    of its tensor's max-abs, where a 1e-6 gradient error is a large relative
    one, is held only to that bound."""
    import numpy as np
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
    from cfm_tpu_torch.train import StepDraws, init_train_state, make_optimizer, make_train_step

    B, lr = 8, 2e-4
    rng = np.random.default_rng(4)
    x0, x1, eps = (torch.from_numpy(rng.standard_normal((B,) + cfg["dim"]).astype(np.float32))
                   for _ in range(3))
    t, u = (torch.from_numpy(rng.uniform(size=B).astype(np.float32)) for _ in range(2))
    y0, y1 = (torch.from_numpy(rng.integers(0, 10, B)) for _ in range(2))
    class_cond = cfg.get("class_cond", False)
    runs = {}
    with strict_f32():
        for dev in ("cpu", "cuda"):
            model = seeded_model(cfg, torch.float32, dev, seed=2, dropout=0.1)
            old = [p.detach().cpu().clone() for p in model.parameters()]
            opt = make_optimizer(lr=lr, warmup_steps=1)
            state = init_train_state(model, opt)
            step = make_train_step(ExactOptimalTransportConditionalFlowMatcher(solver="pallas"),
                                   model, opt, train_mode=True, class_conditional=class_cond)
            before = read_counts()
            draws = StepDraws(t.to(dev), eps.to(dev), u.to(dev), torch.Generator().manual_seed(9))
            labels = (y0.to(dev), y1.to(dev)) if class_cond else ()
            metrics = step(state, x0.to(dev), x1.to(dev), *labels, draws=draws)
            torch.cuda.synchronize()
            runs[dev] = dict(metrics={k: float(v) for k, v in metrics.items()}, old=old,
                             params=[p.detach().cpu() for p in state.params],
                             ema=[e.cpu() for e in state.ema_params],
                             grads=[p.grad.cpu() for p in state.params],
                             launched={k: v - before[k] for k, v in read_counts().items()})
    cpu, card = runs["cpu"], runs["cuda"]
    got = card["launched"]
    if any(cpu["launched"].values()) or got["auction"] != 1 or got["attn_block_fwd"] == 0 \
            or got["attn_block_fwd"] != got["attn_block_bwd"] or got["gn_silu_fwd"] == 0 \
            or got["gn_silu_fwd"] != got["gn_silu_bwd"] \
            or got["attention_fwd"] != got["attention_bwd"] \
            or (cfg is IMAGENET_SMALL and got["attention_fwd"] == 0):
        raise AssertionError(f"small train step launches: cpu {cpu['launched']}, card {got}")
    for k in ("loss", "grad_norm"):
        a, b = card["metrics"][k], cpu["metrics"][k]
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"small train step {k}: card {a} vs CPU {b}")
    gmax = max(g.abs().max().item() for g in cpu["grads"])
    worst, worst_g, n_noise = 0.0, 0.0, 0
    for a, b, ea, eb, gg, g, old in zip(card["params"], cpu["params"], card["ema"], cpu["ema"],
                                        card["grads"], cpu["grads"], cpu["old"]):
        worst_g = max(worst_g, (gg - g).abs().max().item()
                      / max(g.abs().max().item(), 1e-3 * gmax))
        noise = g.abs() < 1e-3 * g.abs().max()
        n_noise += int(noise.sum())
        if ((a - old).abs()[noise] > lr * (1 + 1e-5)).any():
            raise AssertionError("small train step: a parameter moved by more than lr")
        if (~noise).any():
            worst = max(worst, (a - b).abs()[~noise].max().item(),
                        (ea - eb).abs()[~noise].max().item())
    if worst_g > 1e-4 or worst > 1e-6:
        raise AssertionError(f"small train step: gradients differ by {worst_g} of their "
                             f"scale, parameters or EMA by {worst}")
    what = ("ImageNet-64-routed class-conditional " if cfg is IMAGENET_SMALL
            else "class-conditional " if class_cond else "")
    log(f"small {what}train step f32, dropout 0.1: loss "
        f"card {card['metrics']['loss']:.7f} cpu {cpu['metrics']['loss']:.7f}, grad norm card "
        f"{card['metrics']['grad_norm']:.6f} cpu {cpu['metrics']['grad_norm']:.6f}, max "
        f"gradient difference {worst_g:.2e} of scale, max parameter/EMA difference "
        f"{worst:.2e} ({n_noise} noise-level elements held to the lr bound), card launches "
        f"{got}")


def check_2d_step_and_w2():
    """Phase 5: one 2-D OT-CFM step in f32 (TF32 off) of the preset's MLP at
    batch 256, the same weights, batch and draws on the card and on the
    CPU: the card's coupling is the dense auction kernel (#5), the CPU's
    scipy's solver (the same optimum on these tie-free clouds). Loss and grad norm within 1e-5 relative, parameters and
    EMA within 1e-6. Then W1 and W2 of two 2048-point clouds: the card
    through #6, the CPU through scipy, within 1e-5 relative."""
    import numpy as np
    import torch
    from cfm_tpu_torch.coupling import wasserstein
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.models.mlp import MLP
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
    from cfm_tpu_torch.train import StepDraws, init_train_state, make_optimizer, make_train_step

    B = 256
    rng = np.random.default_rng(13)
    x0, x1, eps = (torch.from_numpy(rng.standard_normal((B, 2)).astype(np.float32) * s)
                   for s in (3.0, 1.5, 1.0))
    t, u = (torch.from_numpy(rng.uniform(size=B).astype(np.float32)) for _ in range(2))
    runs = {}
    with strict_f32():
        for dev in ("cpu", "cuda"):
            model = MLP(2, seed=3, device=dev)
            opt = make_optimizer(lr=2e-3, warmup_steps=0)
            state = init_train_state(model, opt)
            step = make_train_step(ExactOptimalTransportConditionalFlowMatcher(sigma=0.1), model,
                                   opt, ema_decay=0.99)
            before = read_counts()
            m = step(state, x0.to(dev), x1.to(dev), draws=StepDraws(t.to(dev), eps.to(dev),
                                                                    u.to(dev)))
            torch.cuda.synchronize()
            runs[dev] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             params=[p.detach().cpu() for p in state.params],
                             ema=[e.cpu() for e in state.ema_params],
                             launched={k: v - before[k] for k, v in read_counts().items()})
    cpu, card = runs["cpu"], runs["cuda"]
    worst = max((a - b).abs().max().item() for k in ("params", "ema")
                for a, b in zip(card[k], cpu[k]))
    log(f"2-D OT-CFM step f32, batch {B}: loss card {card['loss']:.7f} cpu {cpu['loss']:.7f}, "
        f"grad norm card {card['grad_norm']:.6f} cpu {cpu['grad_norm']:.6f}, max parameter/EMA "
        f"difference {worst:.2e}, card launches {card['launched']}")
    if any(cpu["launched"].values()) or card["launched"]["auction"] != 1:
        raise AssertionError(f"2-D step launches: cpu {cpu['launched']}, card {card['launched']}")
    for k in ("loss", "grad_norm"):
        if not abs(card[k] - cpu[k]) <= 1e-5 * abs(cpu[k]):
            raise AssertionError(f"2-D step {k}: card {card[k]} vs CPU {cpu[k]}")
    if not worst <= 1e-6:
        raise AssertionError(f"2-D step: parameters or EMA differ by {worst}")
    a, b = (torch.from_numpy(rng.standard_normal((2048, 2)).astype(np.float32) + s)
            for s in (0.0, 0.5))
    for power in (1, 2):
        with strict_f32():
            before = read_counts()["auction_tiled"]
            w_card = float(wasserstein(a.cuda(), b.cuda(), power=power))
            launched = read_counts()["auction_tiled"] - before
            w_cpu = float(wasserstein(a, b, power=power))
        log(f"W{power} of two 2048-point clouds: card {w_card:.7f} ({launched} tiled auction "
            f"launch), CPU (scipy) {w_cpu:.7f}")
        if launched != 1 or not abs(w_card - w_cpu) <= 1e-5 * w_cpu:
            raise AssertionError(f"W{power}: card {w_card} ({launched} launches) vs CPU {w_cpu}")


def twod_training():
    """Phase 13: ``Trainer`` on ``2d_otcfm`` as the preset gives it (MLP
    width 64, batch 256, Adam 2e-3, EMA 0.99, 5000 steps, W1/W2 on 2048
    points every 1000 steps) with ``trainer.ckpt_interval=0`` (and the loss
    logged every 1000 steps instead of 100). The launch
    counts are set to 0 just before ``fit`` and read just after: one dense
    auction (#5) a step, two tiled auctions (#6) an evaluation. Prints ms per
    step (evaluations excluded) and each evaluation; the final W2 must be
    under 1.1 (the JAX package's 800-step gate), printed beside the 2-moons
    band's OT-CFM threshold. Then three more steps profiled as in phase 9.
    Returns the counts of the 5000 steps."""
    import torch
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.trainer import Trainer

    cfg = load_config("2d_otcfm", ["trainer.ckpt_interval=0", "trainer.log_interval=1000"])
    trainer = Trainer(cfg)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    steps, evals = cfg.trainer.total_steps, trainer.eval_log
    eval_sec = sum(e["seconds"] for e in evals)
    log(f"training 2d_otcfm: {steps} steps and {len(evals)} evaluations in {sec:.3f} s; "
        f"{1e3 * (sec - eval_sec) / steps:.3f} ms per step without the evaluations; "
        f"launches {launches}")
    for e in evals:
        log(f"  evaluation at step {e['step']}: W1 {e['w1']:.6f} W2 {e['w2']:.6f} NFE "
            f"{e['nfe']:.0f}, {e['seconds']:.3f} s")
    band = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "moons_w2_band.json")
    with open(band) as fh:
        ot = json.load(fh)["otcfm"]
    threshold = ot["mean"] + 2 * ot["std"] + 0.05
    w2 = evals[-1]["w2"] if evals else float("nan")
    log(f"2d_otcfm final W2 {w2:.6f} (gate 1.1; the 2-moons band's OT-CFM threshold "
        f"{threshold:.3f} is for 20k steps at lr 1e-3 and 1024 points)")
    want = dict.fromkeys(launches, 0)
    want.update(auction=steps, auction_tiled=2 * len(evals))
    if launches != want or len(evals) != steps // cfg.trainer.eval_interval:
        raise AssertionError(f"2d_otcfm launches {launches}, expected {want}")
    if not w2 < 1.1 or any(e["nfe"] != 100 for e in evals):
        raise AssertionError(f"2d_otcfm: final W2 {w2}, evaluations {evals}")
    au = kernel_fns()["auction"]
    log(f"  the last step's dense auction (n = 256): {int(au.last_rounds.item())} rounds")
    profile_train_step(trainer, 1e3 * (sec - eval_sec) / steps)
    log_kernel_share("#5", "auction kernels (#5, #6)")
    return launches


def twod_cli_runs(steps=300):
    """Phase 14: ``cli.main(["train", ...])`` for ``steps`` steps of each
    other 2-D preset, ending with the final evaluation (two #6 launches);
    SB-CFM's exact coupling (``2d_sbcfm``, and ``2d_sf2m`` as the preset
    gives it) launches #5 once a step."""
    from cfm_tpu_torch import cli

    out = {}
    for kind in ("icfm", "fm", "sbcfm", "vpcfm", "sf2m"):
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train", f"2d_{kind}", f"trainer.total_steps={steps}",
                       "trainer.ckpt_interval=0", "trainer.eval_interval=0",
                       f"trainer.log_interval={steps}"])
        sec = time.perf_counter() - t0
        launched = read_counts()
        log(f"cli train 2d_{kind}: {steps} steps and the final evaluation in {sec:.2f} s, "
            f"launches {launched}")
        want = dict.fromkeys(launched, 0)
        want.update(auction=steps if kind in ("sbcfm", "sf2m") else 0, auction_tiled=2)
        if rc != 0 or launched != want:
            raise AssertionError(f"cli 2d_{kind}: rc {rc}, launches {launched}, expected {want}")
        out[f"cli 2d_{kind}"] = launched
    return out


def main_path():
    """Phase 6: generation at the recipe width; returns the launch counts of
    both runs together."""
    import torch
    from cfm_tpu_torch.generate import generate

    model = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0)
    log(f"recipe UNet: {sum(p.numel() for p in model.parameters())} parameters, bf16")
    runs = (("euler", dict(method="euler", n_steps=100)),
            ("dopri5", dict(method="dopri5", rtol=1e-5, atol=1e-5, max_steps=200)))
    total = dict.fromkeys(kernel_fns(), 0)
    for name, kw in runs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = generate(model, GEN_BATCH, generator=gen, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = read_counts()
        img = out.images
        log(f"generation {name}: {GEN_BATCH} images in {sec:.3f} s = {GEN_BATCH / sec:.2f} imgs/s, "
            f"NFE {out.nfe}, launches {launched}, uint8 mean "
            f"{img.float().mean().item():.2f} std {img.float().std().item():.2f}")
        if img.dtype != torch.uint8 or tuple(img.shape) != (GEN_BATCH, 32, 32, 3):
            raise AssertionError(f"{name}: images of {img.dtype} {tuple(img.shape)}")
        if img.float().std().item() < 1.0:
            raise AssertionError(f"{name}: images are constant")
        want = dict.fromkeys(total, 0)
        want.update(attn_block_fwd=5 * out.nfe, gn_silu_fwd=GN_PER_EVAL["cifar10"] * out.nfe)
        if launched != want or out.nfe == 0:
            raise AssertionError(f"{name}: launches {launched} for NFE {out.nfe}, expected {want}")
        total = {k: v + launched[k] for k, v in total.items()}
    return total


def profile_evaluation():
    """Phase 7: device time by kernel over one recipe-width evaluation."""
    import torch

    model = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0)
    x = torch.randn((GEN_BATCH, 32, 32, 3), device="cuda")
    t = torch.full((GEN_BATCH,), 0.5, device="cuda")
    with torch.inference_mode():
        for _ in range(2):
            model(t, x)
        device_profile(lambda: model(t, x), "one evaluation (batch 512, bf16)")


# Kernel names by group, matched in this order: #1's stages before #3's, as
# #1 runs #3's kernels on its own layout (BlockLayout), and #8's strip kernel
# with its SiLU epilogue (SiluOut) apart from #1's GroupNorm stage (TokensOut).
KERNEL_GROUPS = (
    ("GroupNorm kernels (#8 forward, #9 backward)",
     ("SiluOut", "gn_silu_bwd_kernel", "gn_silu_wgrad_kernel")),
    ("auction kernels (#5, #6)", ("auction_kernel", "auction_tiled_kernel")),
    ("flash Sinkhorn (#7)", ("flash_sinkhorn_kernel",)),
    ("attention-block kernels (#1, #2; their stages share code)",
     ("TokensOut", "round_weights_kernel", "BlockLayout", "mma_gemm_kernel", "gn_stats_kernel",
      "round_transpose_kernel", "attention_kernel", "gemm_kernel", "bmma_kernel", "fgemm_kernel",
      "softmax_rows_kernel", "softmax_bwd_rows_kernel", "colsum_partial_kernel",
      "sum_parts_kernel", "gn_bwd_kernel")),
    ("multi-head attention kernels (#3, #4)",
     ("attention_resident", "attention_streamed", "attention_bwd_rows", "attention_bwd_cols")),
)


def kernel_group(key):
    for group, names in KERNEL_GROUPS:
        if any(k in key for k in names):
            return group
    if "at::native" in key:
        return "plain torch elementwise and reductions"
    if any(k in key.lower() for k in ("fprop", "dgrad", "wgrad", "conv")):
        return "cuDNN convolutions"
    return "other (cuBLAS matmuls, ...)"


def device_profile(fn, what, top=14, per=1):
    """Runs ``fn`` under ``torch.profiler`` tracing the device only (no host
    operators, so the tracer adds little host time) and prints, per ``per``
    repetitions in ``fn``, the device time by kernel group, the largest
    kernels, and the busy time over the wall time of that same window.
    Returns the window's wall time per repetition in ms. Where no session
    records device time (``traced``), it says so, and ``device_profile.last``
    is None."""
    import torch

    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    _, events = traced(timed, what)
    wall_us = wall[-1] * 1e6 / per
    device_profile.last = None
    if not events:
        log(f"profile of {what}: wall {wall_us / 1e3:.3f} ms; device time not measured")
        return wall_us / 1e3
    rows = [(e.self_device_time_total / per, e.count // per, e.key) for e in events]
    busy_us = sum(r[0] for r in rows)
    log(f"profile of {what}, device tracing only: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% of the same window), "
        f"{len(rows)} kernel names")
    groups = {}
    for us, _, key in rows:
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + us
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}%  {group}")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f}% x{count:<4d} {key[:100]}")
    device_profile.last = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
                               groups={k: us / 1e3 for k, us in groups.items()})
    return wall_us / 1e3


def log_kernel_share(name, group):
    """A kernel group's device ms a step in the last ``device_profile``,
    beside the device-busy time and share of that window."""
    last = device_profile.last
    if last is None:
        log(f"  {name}: device time not measured")
        return
    ms = last["groups"].get(group, 0.0)
    log(f"  {name}: {ms:.3f} ms of device time a step, {100 * ms / last['busy_ms']:.1f}% of the "
        f"device's busy {last['busy_ms']:.3f} ms; the device busy "
        f"{100 * last['busy_ms'] / last['wall_ms']:.1f}% of the traced step")


def training_path(preset, data_dir, per_step):
    """Phases 8 and 10: ``Trainer`` on ``preset`` (bf16, batch 128, the
    synthetic set), a few warm-up steps, then ``fit`` with every launch
    count set to 0 just before and read just after, which must equal
    ``per_step`` times the steps. Returns the counts, the trainer and the ms
    per step."""
    import torch
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.trainer import Trainer

    cfg = load_config(preset, ["trainer.log_interval=1000", "data.synthetic_fallback=True",
                               f"data.data_dir={data_dir}"])
    trainer = Trainer(cfg)
    if trainer.model.dtype != torch.bfloat16 or cfg.data.batch_size != TRAIN_BATCH:
        raise AssertionError(f"the training path must run {preset} in bf16 at batch 128")
    trainer.fit(TRAIN_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # Keep each step's loss (a 0-d device tensor) and read them after the run.
    step_fn, recorded = trainer.step_fn, []

    def recording_step(*args, **kwargs):
        metrics = step_fn(*args, **kwargs)
        recorded.append(metrics["loss"])
        return metrics

    trainer.step_fn = recording_step
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(TRAIN_WARMUP + TRAIN_STEPS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    trainer.step_fn = step_fn
    losses = [float(v) for v in recorded]
    log(f"training {preset} bf16 batch {TRAIN_BATCH}: {TRAIN_STEPS} steps in {sec:.3f} s = "
        f"{1e3 * sec / TRAIN_STEPS:.2f} ms per step, {TRAIN_STEPS * TRAIN_BATCH / sec:.1f} imgs/s; "
        f"loss first {losses[0]:.5f} last {losses[-1]:.5f}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    return launches, trainer, 1e3 * sec / TRAIN_STEPS


def mnist_generation(trainer):
    """Phase 10: ``Trainer.generate`` from the EMA parameters, 8 images of
    each class with euler at 100 steps; the GroupNorm kernels must run 27
    times per evaluation, and nothing else."""
    import torch

    y = torch.arange(10, device="cuda").repeat_interleave(MNIST_GEN // 10)
    gen = torch.Generator(device="cuda").manual_seed(1)
    trainer.generate(MNIST_GEN, method="euler", n_steps=100, y=y, generator=gen)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = trainer.generate(MNIST_GEN, method="euler", n_steps=100, y=y, generator=gen)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched, img = read_counts(), out.images
    log(f"generation mnist_otcfm_cond euler-100: {MNIST_GEN} images (8 per class) in {sec:.3f} s "
        f"= {MNIST_GEN / sec:.2f} imgs/s, NFE {out.nfe}, launches {launched}, uint8 mean "
        f"{img.float().mean().item():.2f} std {img.float().std().item():.2f}")
    if img.dtype != torch.uint8 or tuple(img.shape) != (MNIST_GEN, 28, 28, 1):
        raise AssertionError(f"mnist generation: images of {img.dtype} {tuple(img.shape)}")
    if img.float().std().item() < 1.0:
        raise AssertionError("mnist generation: images are constant")
    want = dict.fromkeys(launched, 0)
    want["gn_silu_fwd"] = GN_PER_EVAL["mnist"] * out.nfe
    if launched != want or out.nfe != 100:
        raise AssertionError(f"mnist generation: launches {launched} for NFE {out.nfe}, "
                             f"expected {want}")
    return launched


def profile_train_step(trainer, ms_per_step, steps=3):
    """Phases 9 and 10: device time by kernel per train step and the device's
    busy share, over a few steps traced on the device only; then, in a second
    window that also traces the host, the host operators that took the most
    CPU time per step."""
    import torch

    wall_ms = device_profile(lambda: trainer.fit(trainer.state.step + steps),
                             f"a {trainer.cfg.name} train step (batch "
                             f"{trainer.cfg.data.batch_size}; mean of {steps})", per=steps)
    log(f"  the same steps took {ms_per_step:.2f} ms each untraced, "
        f"{wall_ms:.2f} ms under device tracing")
    wall = []

    def timed():
        t0 = time.perf_counter()
        trainer.fit(trainer.state.step + steps)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    prof, _ = traced(timed, f"a {trainer.cfg.name} train step, host and device", host=True)
    wall_ms = wall[-1] * 1e3 / steps
    ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)
    host_us = sum(e.self_cpu_time_total for e in ops) / steps
    log(f"  host per step, tracing host and device (wall {wall_ms:.3f} ms a step): "
        f"{host_us / 1e3:.3f} ms of self CPU time in {sum(e.count for e in ops) // steps} "
        f"recorded calls; the largest:")
    for e in ops[:10]:
        log(f"  {e.self_cpu_time_total / steps / 1e3:9.3f} ms x{e.count // steps:<5d} {e.key[:80]}")
    waits = {k: sum(e.count for e in ops if e.key == k) / steps
             for k in ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize")}
    log(f"  per step (the window's closing synchronize included): {waits}")


def imagenet_generation(model):
    """Phase 11: IMAGENET_GEN images of the ImageNet-64 model (bf16) for
    labels drawn from the seed, euler at 100 steps. The launch counts,
    set to 0 just before, must be IMAGENET_PER_EVAL per evaluation and
    nothing else. Returns them."""
    import torch
    from cfm_tpu_torch.generate import generate

    y = torch.randint(0, IMAGENET64["num_classes"], (IMAGENET_GEN,),
                      generator=torch.Generator().manual_seed(11)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = generate(model, IMAGENET_GEN, x_shape=IMAGENET64["dim"], method="euler", n_steps=100,
                   generator=gen, y=y)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched, img = read_counts(), out.images
    log(f"generation imagenet64 euler-100 bf16: {IMAGENET_GEN} images in {sec:.3f} s = "
        f"{IMAGENET_GEN / sec:.2f} imgs/s, {1e3 * sec / max(out.nfe, 1):.2f} ms per evaluation, "
        f"NFE {out.nfe}, max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"launches {launched}, uint8 mean {img.float().mean().item():.2f} std "
        f"{img.float().std().item():.2f}")
    if img.dtype != torch.uint8 or tuple(img.shape) != (IMAGENET_GEN,) + IMAGENET64["dim"]:
        raise AssertionError(f"imagenet64 generation: images of {img.dtype} {tuple(img.shape)}")
    if img.float().std().item() < 1.0:
        raise AssertionError("imagenet64 generation: images are constant")
    want = dict.fromkeys(launched, 0)
    want.update({k: v * out.nfe for k, v in IMAGENET_PER_EVAL.items()})
    if launched != want or out.nfe != 100:
        raise AssertionError(f"imagenet64 generation: launches {launched} for NFE {out.nfe}, "
                             f"expected {want}")
    x = torch.randn((IMAGENET_GEN,) + IMAGENET64["dim"], generator=gen, device="cuda")
    t = torch.full((IMAGENET_GEN,), 0.5, device="cuda")
    with torch.inference_mode():
        model(t, x, y)
        device_profile(lambda: model(t, x, y),
                       f"one imagenet64 evaluation (batch {IMAGENET_GEN}, bf16)")
    return launched


def imagenet_training(model, warmup=3, profiled=3):
    """Phase 12: the class-conditional OT-CFM step of the ImageNet-64 model
    (bf16, batch IMAGENET_BATCH, dropout 0.1, Adam 1e-4 with the 5k-step
    warmup, clip 1.0, EMA 0.9999) on random uint8 images and labels made
    from the seed and put on the card once; y0 = y1, as the Trainer pairs
    them. ``warmup`` steps, then IMAGENET_STEPS with every launch count set
    to 0 just before and checked just after, then ``profiled`` steps under
    the device profiler. Returns the counts of the timed steps."""
    import numpy as np
    import torch
    from cfm_tpu_torch.data.images import normalize_images
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
    from cfm_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    B = IMAGENET_BATCH
    n_batches = warmup + IMAGENET_STEPS + profiled
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.integers(0, 256, (n_batches * B,) + IMAGENET64["dim"],
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, IMAGENET64["num_classes"], n_batches * B)).cuda()
    opt = make_optimizer(lr=1e-4, grad_clip=1.0)
    state = init_train_state(model, opt)
    step = make_train_step(ExactOptimalTransportConditionalFlowMatcher(), model, opt,
                           ema_decay=0.9999, train_mode=True, class_conditional=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    losses = []

    def run(n):
        for _ in range(n):
            i = state.step % n_batches * B  # a profiler session run again reuses batches
            x1, y = normalize_images(images[i:i + B]), labels[i:i + B]
            x0 = torch.randn(x1.shape, generator=g, device="cuda")
            losses.append(step(state, x0, x1, y, y, generator=g)["loss"])

    run(warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses.clear()
    zero_counts()
    t0 = time.perf_counter()
    run(IMAGENET_STEPS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    values = [float(v) for v in losses]
    log(f"training imagenet64 bf16 batch {B}: {IMAGENET_STEPS} steps in {sec:.3f} s = "
        f"{1e3 * sec / IMAGENET_STEPS:.2f} ms per step, {IMAGENET_STEPS * B / sec:.1f} imgs/s; "
        f"loss first {values[0]:.5f} last {values[-1]:.5f}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}")
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite imagenet64 training loss: {values}")
    per_step = dict(auction=1, attention_fwd=7, attention_bwd=7, attn_block_fwd=8,
                    attn_block_bwd=8, gn_silu_fwd=GN_PER_EVAL["imagenet64"],
                    gn_silu_bwd=GN_PER_EVAL["imagenet64"])
    want = {k: per_step.get(k, 0) * IMAGENET_STEPS for k in launches}
    if launches != want:
        raise AssertionError(f"imagenet64 training launches {launches}, expected {want}")
    wall_ms = device_profile(lambda: run(profiled),
                             f"an imagenet64 train step (batch {B}, bf16; mean of {profiled})",
                             per=profiled)
    log(f"  the same steps took {1e3 * sec / IMAGENET_STEPS:.2f} ms each untraced, "
        f"{wall_ms:.2f} ms under device tracing")
    return launches


def sinkhorn_clouds(n, m, d, seed, scale=None):
    """Centred f32 clouds: at d = 2 the 2d_sf2m path's, n points of 8
    Gaussians against m of moons; otherwise two Gaussian clouds, by default
    scaled by sqrt(32 / d) beyond d = 32 so that their costs keep the
    d = 32 clouds' range, where f32 resolves the gates' absolute 1e-5 reg."""
    import torch
    from cfm_tpu_torch.data.toy import eight_gaussians, sample_moons
    from cfm_tpu_torch.ops import flash_sinkhorn as fs

    g = torch.Generator(device="cuda").manual_seed(seed)
    if d == 2:
        x, y = eight_gaussians(g, n), sample_moons(g, m)
    else:
        s = min(1.0, (32 / d) ** 0.5) if scale is None else scale
        x = torch.randn(n, d, generator=g, device="cuda") * s
        y = (torch.randn(m, d, generator=g, device="cuda") * 1.3 + 0.5) * s
    return fs._center(x, y)


def implied_row_error_f64(x, y, f, g, loga, reg):
    """sum_i |sum_j pi_ij - a_i| of the plan pi_ij = exp((f_i + g_j - c_ij) /
    reg), from the f32 potentials in f64 (for the log: the loop's f32
    statistic is about 1e-7 away at n = 1000-2048)."""
    import torch

    x, y, f, g, loga = (v.double() for v in (x, y, f, g, loga))
    c = x.square().sum(1)[:, None] + y.square().sum(1)[None, :] - 2.0 * x @ y.T
    lse = torch.logsumexp((g[None, :] - c) / reg, dim=1) + f / reg
    return float((lse.exp() - loga.exp()).abs().sum())


def check_flash_sinkhorn():
    """Phase 3: flash Sinkhorn (#7) against its plain version on the card at
    FLASH_CASES. After a fixed 50 iterations (tol 0) f and g agree within
    1e-4 |ref| + 1e-5 reg element-wise. At tol 1e-6 (cap FLASH_CAP) the two
    stop within one iteration of each other (the kernel checks every
    iteration, as the plain version does) and, when they stop before the
    cap, each implied plan meets the tolerance by the plain version's f32
    stopping statistic (``flash_row_error``; its f64 value is logged). A
    rerun gives the same bits and iteration count (the kernel sums the
    error in a fixed order).
    Returns the largest |f - f_ref|, |g - g_ref| after 50 iterations."""
    import numpy as np
    import torch
    from cfm_tpu_torch.ops import flash_sinkhorn as fs

    fn, worst = fs.flash_sinkhorn, 0.0
    for n, m, d, reg, weighted, what in FLASH_CASES:
        x, y = sinkhorn_clouds(n, m, d, seed=n + d)
        w = torch.from_numpy(np.random.default_rng(n).uniform(0.5, 1.5, n).astype(np.float32))
        la = torch.log((w / w.sum()) if weighted else torch.full((n,), 1.0 / n)).cuda()
        lb = torch.full((m,), 1.0 / m, device="cuda").log()
        f, g = fn(x, y, la, lb, reg, 50, 0.0)
        torch.cuda.synchronize()
        k_it = int(fn.last_iters.item())
        fr, gr, p_it = fs.flash_sinkhorn_reference(x, y, la, lb, reg, 50, 0.0)
        ratio = max(((f - fr).abs() / (1e-4 * fr.abs() + 1e-5 * reg)).max().item(),
                    ((g - gr).abs() / (1e-4 * gr.abs() + 1e-5 * reg)).max().item())
        err = max((f - fr).abs().max().item(), (g - gr).abs().max().item())
        worst = max(worst, err)
        line = (f"flash sinkhorn ({n}, {m}, d={d}) reg {reg}, {what}: 50 iterations "
                f"({k_it} and {p_it}): max |df|, |dg| {err:.3e}, {ratio:.3f} of the tolerance")
        if k_it != 50 or p_it != 50 or not ratio <= 1.0:
            raise AssertionError(line)
        f, g = fn(x, y, la, lb, reg, FLASH_CAP, FLASH_TOL)
        k_it = int(fn.last_iters.item())
        f2, g2 = fn(x, y, la, lb, reg, FLASH_CAP, FLASH_TOL)
        k_it2 = int(fn.last_iters.item())
        fr, gr, p_it = fs.flash_sinkhorn_reference(x, y, la, lb, reg, FLASH_CAP, FLASH_TOL)
        same = torch.equal(f, f2) and torch.equal(g, g2) and k_it == k_it2
        ek, ep = (float(fs.flash_row_error(x, y, a, b, la, reg)) for a, b in ((f, g), (fr, gr)))
        ek64, ep64 = (implied_row_error_f64(x, y, a, b, la, reg) for a, b in ((f, g), (fr, gr)))
        line += (f"; tol {FLASH_TOL}: stops at {k_it} (kernel) and {p_it} (plain), implied row "
                 f"errors {ek:.3e} and {ep:.3e} (f64: {ek64:.3e} and {ep64:.3e}), rerun "
                 f"identical {same}")
        if abs(k_it - p_it) > 1 or not same:
            raise AssertionError(line)
        if max(k_it, p_it) < FLASH_CAP and not max(ek, ep) <= FLASH_TOL:
            raise AssertionError(line)
        log(line)
    flash_raw_scale()
    return worst


def flash_raw_scale():
    """Phase 3, measured, not gated: #7 and its plain version at CIFAR-10's
    batch and width unscaled (128 points, d = 3072, costs near 9,000, reg
    100), 50 iterations, each against the same iteration in float64 on the
    dense cost. The potentials are fixed only up to (f + k, g - k), and an
    f32 solve drifts along that shift as it rounds g (|g| near 9,000, an ulp
    of 1e-3); the line gives each solve's mean shift of f from the f64 one
    and the kernel's difference from the plain version with the shift
    removed."""
    import torch
    from cfm_tpu_torch.ops import flash_sinkhorn as fs

    n, d, reg, iters = 128, 3072, 100.0, 50
    x, y = sinkhorn_clouds(n, n, d, seed=n + d, scale=1.0)
    la = torch.full((n,), 1.0 / n, device="cuda").log()
    f, g = fs.flash_sinkhorn(x, y, la, la, reg, iters, 0.0)
    fr, gr, _ = fs.flash_sinkhorn_reference(x, y, la, la, reg, iters, 0.0)
    c = torch.cdist(x.double(), y.double()).square()
    la64 = la.double()
    f64, g64 = torch.zeros_like(la64), torch.zeros_like(la64)
    for _ in range(iters):
        f64 = reg * (la64 - torch.logsumexp((g64[None, :] - c) / reg, dim=1))
        g64 = reg * (la64 - torch.logsumexp((f64[:, None] - c) / reg, dim=0))
    k = (f - fr).mean().item()
    free = max((f - fr - k).abs().max().item(), (g - gr + k).abs().max().item())
    log(f"flash sinkhorn raw scale ({n}, {n}, d={d}) reg {reg}, {iters} iterations (measured, "
        f"not gated): max |df| kernel vs plain {(f - fr).abs().max().item():.3e}, of which a "
        f"shift k = {k:.3e} (f + k, g - k), the rest {free:.3e}; mean f - f64: kernel "
        f"{(f.double() - f64).mean().item():.3e}, plain {(fr.double() - f64).mean().item():.3e}")


def time_flash_sinkhorn():
    """Phase 4: #7 at the 2d_sf2m path's shape and reg (2048 8-Gaussian
    points against 2048 moons points, tol 1e-6), the wrapper's time by CUDA
    events and the kernel's device time by the profiler, beside one run of
    the plain version (host clock) and the bound: the passes this run's
    iterations need (an f pass, then a g pass and a fused error and f pass
    an iteration, the last fused pass left out at the cap) x n m entries x
    flash_ops(d) over the f32 rate, against the clouds, marginals and
    potentials (bytes) over the HBM rate. No single PyTorch call computes
    these potentials."""
    import torch
    from cfm_tpu_torch.ops import flash_sinkhorn as fs

    n = m = 2048
    d, fn = 2, fs.flash_sinkhorn
    x, y = sinkhorn_clouds(n, m, d, seed=41)
    la = torch.full((n,), 1.0 / n, device="cuda").log()
    lb = torch.full((m,), 1.0 / m, device="cuda").log()
    ms = cuda_ms(lambda: fn(x, y, la, lb, SF2M_REG, FLASH_CAP, FLASH_TOL), iters=20, warmup=3)
    dev_ms, ops = device_ms_and_launches(lambda: fn(x, y, la, lb, SF2M_REG, FLASH_CAP,
                                                    FLASH_TOL))
    iters = int(fn.last_iters.item())
    t0 = time.perf_counter()
    _, _, p_it = fs.flash_sinkhorn_reference(x, y, la, lb, SF2M_REG, FLASH_CAP, FLASH_TOL)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    passes = 2 * iters + (1 if iters < FLASH_CAP else 0)
    ops_s = passes * n * m * flash_ops(d) / PEAK_F32_FLOPS
    bytes_s = 4 * ((n + m) * d + 2 * (n + m)) / PEAK_BYTES
    bound_ms = max(ops_s, bytes_s) * 1e3
    by = "operations" if ops_s >= bytes_s else "bytes"
    log(f"flash sinkhorn timing ({n}, {m}, d={d}) reg {SF2M_REG} tol {FLASH_TOL}: wrapper "
        f"{ms:.4f} ms for {iters} iterations ({1e3 * ms / iters:.2f} us each), kernel "
        f"{dev_ms:.4f} ms device time ({'not measured' if ops is None else f'{ops:g}'} device "
        f"operations a call); "
        f"{FLASH_BARRIERS} grid barriers an iteration; plain {plain_ms:.1f} ms ({p_it} "
        f"iterations; a host read each); bound {bound_ms:.4f} ms by {by} ({flash_ops(d)} "
        f"operations an entry, {passes} passes); library: none")
    # The same 100 iterations (tol 0) at 2048 and at 256 points: a 64th of the
    # entries at 256, so its time per iteration is the floor the two grid
    # barriers and the row merges set.
    for k in (2048, 256):
        xs, ys = sinkhorn_clouds(k, k, d, seed=42)
        lk = torch.full((k,), 1.0 / k, device="cuda").log()
        t = cuda_ms(lambda: fn(xs, ys, lk, lk, SF2M_REG, 100, 0.0), iters=10, warmup=2)
        dev_t = device_ms(lambda: fn(xs, ys, lk, lk, SF2M_REG, 100, 0.0), calls=10)
        log(f"  100 iterations at n = m = {k}: {t:.4f} ms, {10 * t:.2f} us an iteration; "
            f"{dev_t:.4f} ms device time")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=None)


def sync_free_steps():
    """Phase 15: one 2d_otcfm step and one 2d_sf2m step on the flash route,
    data draw included, under set_sync_debug_mode("error"), after three
    warm-up steps: any host synchronisation raises and fails the run."""
    import torch
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.trainer import Trainer

    for preset, overrides in (("2d_otcfm", ["trainer.ckpt_interval=0"]), ("2d_sf2m", SF2M)):
        trainer = Trainer(load_config(preset, overrides))
        for _ in range(3):
            trainer.step_fn(trainer.state, *trainer._vectors(), generator=trainer.generator)
        torch.cuda.synchronize()
        before = read_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            x0, x1 = trainer._vectors()
            metrics = trainer.step_fn(trainer.state, x0, x1, generator=trainer.generator)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
        want = {"flash_sinkhorn": 1} if preset == "2d_sf2m" else {"auction": 1}
        log(f"{preset} step (batch {trainer.cfg.data.batch_size}) with its data draw under "
            f"set_sync_debug_mode('error'): no synchronisation; loss "
            f"{float(metrics['loss']):.5f}, launches {launched}")
        if launched != want:
            raise AssertionError(f"{preset} sync-free step launches {launched}, expected {want}")


def sf2m_training():
    """Phase 16: ``Trainer`` on ``2d_sf2m`` with the entropic coupling at
    batch 2048. Returns the launch counts of the SF2M_STEPS steps and their
    evaluation."""
    import numpy as np
    import torch
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.ops import flash_sinkhorn as fs
    from cfm_tpu_torch.trainer import Trainer

    cfg = load_config("2d_sf2m", SF2M + ["trainer.log_interval=100000", "trainer.eval_interval=0"])
    trainer = Trainer(cfg)
    untrained = trainer.evaluate()
    trainer.fit(SF2M_WARMUP)
    total = SF2M_WARMUP + SF2M_STEPS
    cfg.trainer.eval_interval = total  # one evaluation, at the end of the timed run
    step_fn, recorded = trainer.step_fn, []

    def recording_step(*args, **kwargs):
        metrics = step_fn(*args, **kwargs)
        recorded.append((metrics, fs.flash_sinkhorn.last_iters))
        return metrics

    trainer.step_fn = recording_step
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(total)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    trainer.step_fn = step_fn
    ev = trainer.eval_log[-1]
    ms = 1e3 * (sec - ev["seconds"]) / SF2M_STEPS
    keys = ("flow_loss", "score_loss", "coupling_degenerate")
    vals = {k: np.array([float(mt[k]) for mt, _ in recorded]) for k in keys}
    iters = np.array([int(it.item()) for _, it in recorded])
    log(f"training 2d_sf2m (entropic coupling, reg {SF2M_REG}, batch 2048): {SF2M_STEPS} steps and "
        f"one evaluation in {sec:.3f} s; {ms:.3f} ms per step without the evaluation; launches "
        f"{launches}; flash Sinkhorn iterations per solve mean {iters.mean():.1f} min "
        f"{iters.min()} max {iters.max()}")
    log(f"  flow_loss first {vals['flow_loss'][0]:.4f} last {vals['flow_loss'][-1]:.4f}; "
        f"score_loss first {vals['score_loss'][0]:.4f} last {vals['score_loss'][-1]:.4f}; "
        f"coupling_degenerate sum {vals['coupling_degenerate'].sum():.0f}")
    log(f"  evaluation at step {ev['step']}: W1 {ev['w1']:.6f} W2 {ev['w2']:.6f} NFE "
        f"{ev['nfe']:.0f}, {ev['seconds']:.3f} s; the untrained flow: W1 {untrained['w1']:.6f} "
        f"W2 {untrained['w2']:.6f}")
    want = dict.fromkeys(launches, 0)
    want.update(flash_sinkhorn=SF2M_STEPS, auction_tiled=2)
    if launches != want or len(recorded) != SF2M_STEPS:
        raise AssertionError(f"2d_sf2m launches {launches}, expected {want}")
    if vals["coupling_degenerate"].any() or not all(np.isfinite(v).all() for v in vals.values()):
        raise AssertionError(f"2d_sf2m: degenerate couplings or non-finite losses {vals}")
    if not ev["w2"] < untrained["w2"] or ev["nfe"] != 100:
        raise AssertionError(f"2d_sf2m: final W2 {ev['w2']} vs the untrained {untrained['w2']}")
    profile_train_step(trainer, ms)
    log_kernel_share("#7", "flash Sinkhorn (#7)")
    return launches


def wasserstein_sinkhorn():
    """Phase 17: the entropic W2 of 2048 8-Gaussian points against 2048 moons
    points at reg 2: on the card through #7 (one launch), on the CPU through
    the dense Sinkhorn, within 1e-4 relative."""
    import torch
    from cfm_tpu_torch.coupling import wasserstein
    from cfm_tpu_torch.data.toy import eight_gaussians, sample_moons

    g = torch.Generator(device="cuda").manual_seed(43)
    x0, x1 = eight_gaussians(g, 2048), sample_moons(g, 2048)
    zero_counts()
    w_card = float(wasserstein(x0, x1, method="sinkhorn", reg=SF2M_REG, power=2))
    launched = read_counts()
    t0 = time.perf_counter()
    w_cpu = float(wasserstein(x0.cpu(), x1.cpu(), method="sinkhorn", reg=SF2M_REG, power=2))
    log(f"wasserstein(method='sinkhorn', reg {SF2M_REG}, power 2) at 2048 points: card {w_card:.7f} "
        f"(launches {launched}), CPU {w_cpu:.7f} ({time.perf_counter() - t0:.1f} s)")
    want = dict.fromkeys(launched, 0)
    want["flash_sinkhorn"] = 1
    if launched != want or not abs(w_card - w_cpu) <= 1e-4 * w_cpu:
        raise AssertionError(f"sinkhorn W2: card {w_card} ({launched}) vs CPU {w_cpu}")
    return launched


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

    imagenet = seeded_model(IMAGENET64, torch.bfloat16, "cuda", seed=0, dropout=0.1)
    log(f"ImageNet-64 UNet: {sum(p.numel() for p in imagenet.parameters())} parameters, bf16")

    err = check_attn_block()
    err_bwd = check_attn_block_bwd()
    err_attn = check_attention()
    check_auction()
    check_auction_tiled()
    gn_paths = record_gn_shapes(imagenet)
    err_gn = check_gn(gn_paths)
    err_flash = check_flash_sinkhorn()
    time_attn_block(GEN_BATCH)
    time_attn_block(IMAGENET_BATCH, S=64, C=768, H=12)
    timing = time_attn_block(TRAIN_BATCH)
    timing_bwd = time_attn_block_bwd()
    time_attn_block_bwd(IMAGENET_BATCH, S=64, C=768, H=12)
    timing_attn = time_attention()
    timing_auction = time_auction()
    timing_tiled = time_auction_tiled()
    timing_gn = time_gn(gn_paths)
    timing_flash = time_flash_sinkhorn()
    check_small_generation(SMALL)
    check_small_generation(IMAGENET_SMALL)
    check_small_train_step(SMALL)
    check_small_train_step(dict(SMALL, class_cond=True, num_classes=10))
    check_small_train_step(IMAGENET_SMALL)
    check_new_models()
    check_2d_step_and_w2()
    launches = {"generation": main_path()}
    profile_evaluation()
    per_step = dict(auction=1, attn_block_fwd=5, attn_block_bwd=5,
                    gn_silu_fwd=GN_PER_EVAL["cifar10"], gn_silu_bwd=GN_PER_EVAL["cifar10"])
    launches["cifar10 training"], trainer, ms_per_step = training_path(
        "cifar10_otcfm", "build/no_cifar10", per_step)
    profile_train_step(trainer, ms_per_step)
    del trainer
    per_step = dict(auction=1, gn_silu_fwd=GN_PER_EVAL["mnist"], gn_silu_bwd=GN_PER_EVAL["mnist"])
    launches["mnist training"], trainer, ms_per_step = training_path(
        "mnist_otcfm_cond", "build/no_mnist", per_step)
    profile_train_step(trainer, ms_per_step)
    launches["mnist generation"] = mnist_generation(trainer)
    del trainer
    launches["imagenet64 generation"] = imagenet_generation(imagenet)
    launches["imagenet64 training"] = imagenet_training(imagenet)
    launches["2d_otcfm training"] = twod_training()
    launches.update(twod_cli_runs())
    sync_free_steps()
    launches["2d_sf2m training"] = sf2m_training()
    launches["sinkhorn wasserstein"] = wasserstein_sinkhorn()
    total = {k: sum(run[k] for run in launches.values()) for k in kernel_fns()}
    log(f"launches by path {launches}; summed {total}")

    src = "cfm_tpu_torch/csrc/"
    kernels = [
        dict(name="attn_block_fwd", route="cuda", source=src + "attn_block_fwd.cu",
             replaces="cfm_tpu/ops/pallas_attn_block.py:97", max_abs_err=err, **timing),
        dict(name="attn_block_bwd", route="cuda", source=src + "attn_block_bwd.cu",
             replaces="cfm_tpu/ops/pallas_attn_block.py:111", max_abs_err=err_bwd, **timing_bwd),
        dict(name="attention_fwd", route="cuda", source=src + "attention_fwd.cu",
             replaces="cfm_tpu/ops/pallas_attention.py:69", max_abs_err=err_attn["fwd"],
             **timing_attn["attention_fwd"]),
        dict(name="attention_bwd", route="cuda", source=src + "attention_bwd.cu",
             replaces="cfm_tpu/ops/pallas_attention.py:90", max_abs_err=err_attn["bwd"],
             **timing_attn["attention_bwd"]),
        dict(name="auction", route="cuda", source=src + "auction.cu",
             replaces="cfm_tpu/ops/pallas_auction.py:67", max_abs_err=0.0,
             **timing_auction),
        dict(name="auction_tiled", route="cuda", source=src + "auction_tiled.cu",
             replaces="cfm_tpu/ops/pallas_auction.py:220", max_abs_err=0.0, **timing_tiled),
        dict(name="gn_silu_fwd", route="cuda", source=src + "groupnorm.cu",
             replaces="cfm_tpu/ops/pallas_groupnorm.py:60", max_abs_err=err_gn["out"],
             **timing_gn["gn_silu_fwd"]),
        dict(name="gn_silu_bwd", route="cuda", source=src + "groupnorm.cu",
             replaces="cfm_tpu/ops/pallas_groupnorm.py:88", max_abs_err=err_gn["dx"],
             **timing_gn["gn_silu_bwd"]),
        dict(name="flash_sinkhorn", route="cuda", source=src + "flash_sinkhorn.cu",
             replaces="cfm_tpu/ops/flash_sinkhorn.py:54", max_abs_err=err_flash, **timing_flash),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = total[k["name"]]
    kernels = [{key: k[key] for key in keys} for k in kernels]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
