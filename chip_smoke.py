#!/usr/bin/env python3
"""Drive the PyTorch port (``cfm_tpu_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases; any failure raises, and the script exits non-zero without printing
a result:

1. The card: ``nvidia-smi`` name and power limit, torch's device name and
   count. Refuses to run without CUDA.
2. Builds every kernel from ``cfm_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once: the attention-block forward and backward, the
   multi-head attention forward and backward, the auction and the GroupNorm
   forward and backward) and prints the build time and ``ptxas`` register
   and shared-memory lines.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and at others that take other branches:
   the attention-block forward and backward in float32 (TF32 off) and
   bfloat16 (the backward's bf16 limit shown to catch do and ds rounded to
   bf16), at the CIFAR-10 shapes and at the ImageNet-64 8x8 shape (C = 768,
   12 heads); the multi-head attention forward and backward (#3, #4) at the
   ImageNet-64 training and generation shapes and at others that take other
   branches; the auction's permutation, which must be identical, on
   Gaussian, tied, duplicated and rank-1 costs up to n = 512, with its
   assignment cost against scipy's; and the GroupNorm(+SiLU) forward and
   backward (#8, #9) at every (N, H, W, C, dtype, SiLU) that one model
   evaluation of each path gives ``GroupNorm32`` (recorded by wrapping the
   wrapper for that pass; the ImageNet-64 paths included), plus a
   recentred-variance case in float32.
4. Times each kernel with CUDA events (the attention-block forward at the
   training and the generation batch; the multi-head attention forward and
   backward at the ImageNet-64 training shape; the GroupNorm kernels at the
   largest training shape and summed over one training step's 46 calls)
   beside its plain
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
   ``EncoderUNetModel`` (every pool) on the card against the CPU.
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
    and the peak memory.
12. ImageNet-64 training: ``make_train_step`` with exact OT-CFM and the
    labels, bf16, batch 32, dropout 0.1, Adam 1e-4 with the warmup
    schedule, clip 1.0, EMA 0.9999, on random uint8 images and labels put
    on the card once; 3 warm-up steps, then 20 with 1 auction, 7 + 7
    multi-head attention, 8 + 8 attention-block and 87 + 87 GroupNorm
    launches a step; then three steps profiled as in 9.

The last three lines are the kernels' JSON record (``launches`` summed over
the paths of phases 6, 8, 10, 11 and 12), the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
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
# generation shapes, the gate's smallest S, a long S, and head dim 128.
ATTN_SHAPES = ((IMAGENET_BATCH, 9, 256, 64), (IMAGENET_GEN, 9, 256, 64), (4, 1, 128, 64),
               (2, 2, 512, 64), (4, 2, 256, 128))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # abs and rel, kernel vs plain version
# The backward's weight gradients, relative to each one's max-abs. In bf16 the
# kernel reads up to 5.8e-4 there and rounding do and ds to bf16 (what feeding
# them to bf16 tensor cores would do) reads 1.4e-3 or more; check_attn_block_bwd
# shows on every run that the limit sits between the two.
WGRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 128, 3, 30
BLOCK_SHAPES = ((64, 64, 256, 4), (8, 72, 128, 2), (8, 64, 256, 2), (4, 136, 384, 2),
                (IMAGENET_BATCH, 64, 768, 12))  # the last: ImageNet-64's 8x8 blocks
GRADS = ("dx", "dgscale", "dgbias", "dwq", "dbq", "dwo", "dbo")
GN_PER_EVAL = {"cifar10": 46, "mnist": 27, "imagenet64": 87}  # GroupNorm32 calls per evaluation
MNIST_GEN = 80                              # 8 samples of each of the 10 classes
# f32 operations per element (non-tensor-core rate): the forward's two
# statistics passes and its affine + SiLU; the backward's SiLU derivative,
# two column sums and dx, each recomputing norm.
GN_FWD_OPS, GN_BWD_OPS = 12, 30


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
    shapes, the gate's smallest S, a ragged key tile (S=72), and head dims
    128 and 192 (the latter takes the FMA attention kernel in bf16). Returns
    the largest bf16 error at the training and generation shapes."""
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
            if dtype == torch.bfloat16 and N in (TRAIN_BATCH, GEN_BATCH):
                worst = max(worst, err.max().item())
    return worst


def time_attn_block(N, S=256, C=256, H=4, G=32):
    """Phase 4 at batch N (training or generation) and S, C, H, bf16."""
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
    a kernel that rounded them. Returns the largest bf16 dx error at the
    training shape."""
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
                ref = ab.attention_block_backward_reference(*args)
            torch.cuda.synchronize()
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
            log(f"attn_block_bwd N={N} S={S} C={C} H={H} {dtype}: max error (dx abs, weights "
                f"relative to max-abs) {line}")
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
    TOL abs + rel, at ATTN_SHAPES in float32 (TF32 off) and bfloat16. Returns
    the largest bf16 forward and backward errors at the ImageNet-64 shapes."""
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
            if (att.attention_t.launches - launched[0], att.attention_t_bwd.launches
                    - launched[1]) != (1, 1):
                raise AssertionError(f"attention at N={N} H={H} S={S} D={D} did not launch "
                                     f"both kernels once")
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
            log(f"attention N={N} H={H} S={S} D={D} {dtype}: max abs err forward "
                f"{errs['fwd']:.3e}, backward {errs['bwd']:.3e} (within {tol} abs+rel)")
    return worst


def attention_bound(N, H, S, D, backward):
    """(bound ms, bound_by) of #3 or #4 in bf16 at (N, H, S, D). Bytes: qkv and
    the output (and do, dqkv) once. Operations: 2 Z S^2 D per product over
    Z = N H pairs; the forward's two products take bf16 operands; the
    backward's logits recompute, dp and dv take bf16 operands and dq, dk the
    f32 ds, at the non-tensor f32 rate."""
    prod = 2 * N * H * S * S * D
    elems = N * H * S * D
    if backward:
        nbytes, ops_s = 2 * (3 * elems + elems + 3 * elems), (3 * prod / PEAK_BF16_FLOPS
                                                               + 2 * prod / PEAK_F32_FLOPS)
    else:
        nbytes, ops_s = 2 * (3 * elems + elems), 2 * prod / PEAK_BF16_FLOPS
    bytes_s = nbytes / PEAK_BYTES
    return max(bytes_s, ops_s) * 1e3, "bytes" if bytes_s >= ops_s else "operations"


def time_attention():
    """Phase 4: #3 and #4 at the ImageNet-64 training shape (N=32, 9 heads,
    S=256, D=64), bf16, beside their plain versions and the library
    yardsticks: ``F.scaled_dot_product_attention`` on the same q, k, v for #3
    and the backward alone of autograd through it for #4."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import attention as att

    N, H, S, D = ATTN_SHAPES[0]
    scale = 1.0 / math.sqrt(D)
    qkv, do = attention_inputs(N, H, S, D, torch.bfloat16)
    q, k, v = (t.detach().requires_grad_() for t in qkv.unbind(1))
    with torch.no_grad():
        fwd = dict(ms=cuda_ms(lambda: att.attention_t(qkv, scale)),
                   plain_ms=cuda_ms(lambda: att.attn_reference_t(qkv, scale), iters=5),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
    y = F.scaled_dot_product_attention(q, k, v)
    bwd = dict(ms=cuda_ms(lambda: att.attention_t_bwd(qkv, do, scale)),
               plain_ms=cuda_ms(lambda: att.attention_t_bwd_reference(qkv, do, scale), iters=5),
               library_ms=cuda_ms(lambda: torch.autograd.grad(y, (q, k, v), do, retain_graph=True)))
    out = {}
    for name, t, backward in (("attention_fwd", fwd, False), ("attention_bwd", bwd, True)):
        bound_ms, bound_by = attention_bound(N, H, S, D, backward)
        out[name] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name} timing N={N} H={H} S={S} D={D} bf16: kernel {t['ms']:.4f} ms "
            f"({100 * bound_ms / t['ms']:.2f}% of the {bound_ms:.4f} ms bound by {bound_by}), "
            f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms")
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
    version's, round count included, and its cost within 1e-5 relative of
    scipy's optimum."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    for n in (2, 64, 128, 200, 256, 512):
        line = []
        for kind in ("gauss", "ties", "dups", "rank1"):
            cost = auction_cost(n, kind, seed=n)
            perm = au.pallas_auction_assignment(cost)
            ref, rounds = au.auction_assignment_onehot(cost)
            torch.cuda.synchronize()
            k_rounds = int(au.pallas_auction_assignment.last_rounds.item())
            if not torch.equal(perm, ref) or k_rounds != rounds:
                raise AssertionError(f"auction n={n} {kind}: the kernel's perm or round count "
                                     f"({k_rounds} vs {rounds}) differs from its plain version")
            c = cost.double().cpu().numpy()
            r, col = linear_sum_assignment(c)
            opt, got = c[r, col].sum(), c[r, perm.cpu().numpy()].sum()
            if abs(got - opt) > 1e-5 * max(abs(opt), 1e-30):
                raise AssertionError(f"auction n={n} {kind}: cost {got} vs scipy's {opt}")
            line.append(f"{kind} {rounds} rounds")
        log(f"auction n={n}: identical perms; " + ", ".join(line) + "; costs at scipy's optimum")


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


def time_auction():
    """Phase 4 at the training shape (n = 128). The kernel's time is the
    wrapper's (epsilon schedule, launch, completion pass). The bound is
    rounds x n^2 element operations over the f32 rate: loose, since a solve
    is latency-bound. No PyTorch call computes an assignment; scipy's solver
    is timed on the host instead."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    cost = coupling_cost()
    n = cost.shape[0]
    ms = cuda_ms(lambda: au.pallas_auction_assignment(cost))
    rounds = int(au.pallas_auction_assignment.last_rounds.item())
    plain_ms = cuda_ms(lambda: au.auction_assignment_onehot(cost), iters=2, warmup=1)
    c = cost.double().cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(20):
        linear_sum_assignment(c)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    ops_s = rounds * n * n / PEAK_F32_FLOPS
    bytes_s = (n * n * 4 + n * 8) / PEAK_BYTES
    bound_ms = max(ops_s, bytes_s) * 1e3
    log(f"auction timing n={n}: kernel {ms:.4f} ms for {rounds} rounds ({1e3 * ms / rounds:.3f} us "
        f"per round), bound {bound_ms:.6f} ms (loose), plain {plain_ms:.3f} ms, scipy on the "
        f"host {host_ms:.4f} ms (host time)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_s >= bytes_s else "bytes", library_ms=None,
                host_ms=host_ms, rounds=rounds)


def bwd_flops(N, S, C, H):
    """(bf16-operand FLOPs, f32-operand FLOPs) of the backward, recompute
    included: qkv, logits, attn, dattn, dwo, dwq, dtokens take model-dtype
    operands; dp, dq, dk, dv take f32 ones (do and ds are f32)."""
    D, M, Z = C // H, N * S, N * H
    att = 2 * Z * S * S * D
    lp = 2 * M * C * 3 * C + 2 * att + 2 * (2 * M * C * C) + 2 * (2 * M * C * 3 * C)
    return lp, 4 * att


def time_attn_block_bwd(N=TRAIN_BATCH, S=256, C=256, H=4, G=32):
    """Phase 4 at a training shape (by default CIFAR-10's, N=128, S=256,
    C=256), bf16. The yardstick is the backward alone of F.group_norm +
    F.linear + scaled_dot_product_attention + F.linear + residual in bf16."""
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
    times = dict(ms=cuda_ms(lambda: ab.fused_attention_block_bwd(*args)),
                 plain_ms=cuda_ms(lambda: ab.attention_block_backward_reference(*args), iters=3),
                 library_ms=cuda_ms(lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)))
    lp_flops, f32_flops = bwd_flops(N, S, C, H)
    ops_s = lp_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS
    nbytes = 3 * N * S * C * 2 + 2 * 4 * (C * 3 * C + 3 * C + C * C + 3 * C)
    bytes_s = nbytes / PEAK_BYTES
    bound_ms = max(ops_s, bytes_s) * 1e3
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    log(f"attn_block_bwd timing N={N} S={S} C={C} bf16: kernel {times['ms']:.4f} ms "
        f"({(lp_flops + f32_flops) / times['ms'] / 1e9:.2f} TFLOP/s; {lp_flops / 1e9:.2f} GFLOP "
        f"bf16-operand + {f32_flops / 1e9:.2f} GFLOP f32-operand), {100 * bound_ms / times['ms']:.2f}% "
        f"of the {bound_ms:.4f} ms bound by {bound_by}, plain {times['plain_ms']:.4f} ms, "
        f"library backward {times['library_ms']:.4f} ms")
    return dict(times, bound_ms=bound_ms, bound_by=bound_by)


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

    worst = {"out": 0.0, "dx": 0.0}
    shapes = dict.fromkeys(k for p in paths.values() for k in p)
    for i, (N, H, W, C, G, dt, silu) in enumerate(shapes):
        x, scale, bias, dy = gn_inputs(N, H, W, C, getattr(torch, dt), seed=i)
        errs = check_gn_case(x, scale, bias, dy, G, silu, f"{N}x{H}x{W}x{C} {dt} silu={silu}")
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        log(f"gn_silu N={N} {H}x{W}x{C}/{G} {dt} silu={silu}: " +
            ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
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


def time_gn(train_shapes):
    """Phase 4: #8 and #9 at the largest training shape (N=128, 32x32x128,
    bf16, SiLU) beside the plain versions and the yardstick ``F.group_norm``
    on the NCHW view then ``F.silu`` (autograd of the same for #9, with the
    affine parameters in bf16 as the library takes them); then kernel and
    plain summed over one CIFAR-10 training step's 46 calls."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import groupnorm as gn

    N, H, C, G = TRAIN_BATCH, 32, 128, 32
    x, scale, bias, dy = gn_inputs(N, H, H, C, torch.bfloat16)
    sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    with torch.no_grad():
        fwd = dict(ms=cuda_ms(lambda: gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True)),
                   plain_ms=cuda_ms(lambda: gn.gn_silu_fwd_reference(x, scale, bias, G, 1e-5, True),
                                    iters=5),
                   library_ms=cuda_ms(lambda: F.silu(F.group_norm(x.permute(0, 3, 1, 2), G, sb, bb))))
        _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True)
    xl, wl, bl = (t.detach().requires_grad_() for t in (x, sb, bb))
    y = F.silu(F.group_norm(xl.permute(0, 3, 1, 2), G, wl, bl))
    dyl = dy.permute(0, 3, 1, 2)
    bwd = dict(ms=cuda_ms(lambda: gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy, G, True)),
               plain_ms=cuda_ms(lambda: gn.gn_silu_bwd_reference(x, scale, bias, mean, inv, dy, G, True),
                                iters=5),
               library_ms=cuda_ms(lambda: torch.autograd.grad(y, (xl, wl, bl), dyl, retain_graph=True)))
    out = {}
    for name, t, backward in (("gn_silu_fwd", fwd, False), ("gn_silu_bwd", bwd, True)):
        bound_ms, bound_by = gn_bound(N, H * H, C, 2, backward)
        out[name] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name} timing N={N} {H}x{H}x{C} bf16 silu: kernel {t['ms']:.4f} ms "
            f"({100 * bound_ms / t['ms']:.2f}% of the {bound_ms:.4f} ms bound by {bound_by}), "
            f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms")
    sums = dict(fwd=0.0, bwd=0.0, plain_fwd=0.0, plain_bwd=0.0, bound_fwd=0.0, bound_bwd=0.0)
    for (n, h, w, c, g, dt, silu), k in train_shapes.items():
        xs, ss, bs, gs = gn_inputs(n, h, w, c, getattr(torch, dt))
        with torch.no_grad():
            _, m_, i_ = gn.fused_group_norm_silu_fwd(xs, ss, bs, g, 1e-5, silu)
            sums["fwd"] += k * cuda_ms(lambda: gn.fused_group_norm_silu_fwd(xs, ss, bs, g, 1e-5, silu))
            sums["bwd"] += k * cuda_ms(
                lambda: gn.fused_group_norm_silu_bwd(xs, ss, bs, m_, i_, gs, g, silu))
            sums["plain_fwd"] += k * cuda_ms(
                lambda: gn.gn_silu_fwd_reference(xs, ss, bs, g, 1e-5, silu), iters=3)
            sums["plain_bwd"] += k * cuda_ms(
                lambda: gn.gn_silu_bwd_reference(xs, ss, bs, m_, i_, gs, g, silu), iters=3)
        for d in ("fwd", "bwd"):
            sums[f"bound_{d}"] += k * gn_bound(n, h * w, c, xs.element_size(), d == "bwd")[0]
    log(f"GroupNorm over one training step's {sum(train_shapes.values())} calls: forward kernels "
        f"{sums['fwd']:.4f} ms (plain {sums['plain_fwd']:.4f}, bound {sums['bound_fwd']:.4f}), "
        f"backward kernels {sums['bwd']:.4f} ms (plain {sums['plain_bwd']:.4f}, bound "
        f"{sums['bound_bwd']:.4f})")
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
    from cfm_tpu_torch.ops import groupnorm as gn

    return {"attn_block_fwd": ab.fused_attention_block,
            "attn_block_bwd": ab.fused_attention_block_bwd,
            "attention_fwd": att.attention_t, "attention_bwd": att.attention_t_bwd,
            "auction": au.pallas_auction_assignment,
            "gn_silu_fwd": gn.fused_group_norm_silu, "gn_silu_bwd": gn.fused_group_norm_silu_bwd}


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


KERNEL_GROUPS = (
    ("GroupNorm kernels (#8 forward, #9 backward)",
     ("gn_silu_fwd_kernel", "gn_silu_bwd_kernel", "gn_silu_wgrad_kernel")),
    ("auction kernel", ("auction_kernel",)),
    ("attention kernels (#1, #2, #3, #4: their stages share code)",
     ("mma_gemm_kernel", "attention_mma_kernel", "gn_stats_kernel", "round_transpose_kernel",
      "attention_kernel", "gemm_kernel", "bmma_kernel", "fgemm_kernel", "softmax_rows_kernel",
      "softmax_bwd_rows_kernel", "colsum_partial_kernel", "sum_parts_kernel", "gn_bwd_kernel")),
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
    Returns the window's wall time per repetition in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / per
    rows = [(e.self_device_time_total / per, e.count // per, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise AssertionError(f"the profiler recorded no device time over {what}")
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
    return wall_us / 1e3


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
    from torch.profiler import ProfilerActivity, profile

    wall_ms = device_profile(lambda: trainer.fit(trainer.state.step + steps),
                             f"a {trainer.cfg.name} train step (batch 128, bf16; mean of {steps})",
                             per=steps)
    log(f"  the same steps took {ms_per_step:.2f} ms each untraced, "
        f"{wall_ms:.2f} ms under device tracing")
    step = trainer.state.step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(step + steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ops = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)
    host_us = sum(e.self_cpu_time_total for e in ops) / steps
    log(f"  host per step, tracing host and device (wall {wall_ms:.3f} ms a step): "
        f"{host_us / 1e3:.3f} ms of self CPU time in {sum(e.count for e in ops) // steps} "
        f"recorded calls; the largest:")
    for e in ops[:10]:
        log(f"  {e.self_cpu_time_total / steps / 1e3:9.3f} ms x{e.count // steps:<5d} {e.key[:80]}")


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
            i = state.step * B
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
    gn_paths = record_gn_shapes(imagenet)
    err_gn = check_gn(gn_paths)
    time_attn_block(GEN_BATCH)
    time_attn_block(IMAGENET_BATCH, S=64, C=768, H=12)
    timing = time_attn_block(TRAIN_BATCH)
    timing_bwd = time_attn_block_bwd()
    time_attn_block_bwd(IMAGENET_BATCH, S=64, C=768, H=12)
    timing_attn = time_attention()
    timing_auction = time_auction()
    timing_gn = time_gn(gn_paths["cifar10 training"])
    check_small_generation(SMALL)
    check_small_generation(IMAGENET_SMALL)
    check_small_train_step(SMALL)
    check_small_train_step(dict(SMALL, class_cond=True, num_classes=10))
    check_small_train_step(IMAGENET_SMALL)
    check_new_models()
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
             **{k: v for k, v in timing_auction.items() if k not in ("host_ms", "rounds")}),
        dict(name="gn_silu_fwd", route="cuda", source=src + "groupnorm.cu",
             replaces="cfm_tpu/ops/pallas_groupnorm.py:60", max_abs_err=err_gn["out"],
             **timing_gn["gn_silu_fwd"]),
        dict(name="gn_silu_bwd", route="cuda", source=src + "groupnorm.cu",
             replaces="cfm_tpu/ops/pallas_groupnorm.py:88", max_abs_err=err_gn["dx"],
             **timing_gn["gn_silu_bwd"]),
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
