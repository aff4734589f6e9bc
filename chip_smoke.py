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
   (#3, #4) at the ImageNet-64 training and generation shapes of the 16x16
   and the 32x32 blocks (the latter on the streamed route, the backward
   from the forward's statistics) and at others that take other branches,
   the gate's edges (S = 896 at D = 64, 768 at D = 128) among them, with
   the bf16 forward's and backward's reruns
   giving the same bits; the auction's
   permutation and round count, which must be identical, on a rerun too, on
   Gaussian, tied, duplicated and rank-1 costs up to n = 512, with its
   assignment cost against scipy's; the tiled auction's (#6) permutation and
   round count, identical to its plain version's, on the four kinds at
   n = 256, 1024 and 2048 (but rank 1 at 1024 and 2048 and ties at 2048,
   and W1 at 4096, held to scipy's optimum only), and on the 2-D
   evaluation's W1 and W2 costs at 1024 and 2048; and the
   GroupNorm(+SiLU) forward and
   backward (#8, #9) at every (N, H, W, C, dtype, SiLU) that one model
   evaluation of each path gives ``GroupNorm32`` (recorded by wrapping the
   wrapper for that pass; the ImageNet-64 paths included), plus a
   recentred-variance case in float32, and at ``ResNetDiffEq``'s
   (64, 28, 28, 64), 16 groups of 4 channels, eps 1e-4 (phase 31's), both
   rerun for the same bits (their cluster combines and #9's item sum have
   a fixed order), at ``ResNetDiffEq(1, 6, 4)``'s width-6 shapes (6 groups
   of one channel, 24-byte rows) and at GN_BEYOND's shapes that no strip
   on chip holds or whose N passes a grid's 65535 rows (float32 2x256x256x256
   in 32 groups, bf16 C = 12 in 12 groups, 2x4x4x8192 in 16 groups,
   70000x1x1x32 and 70000x17x17x32), with and without the SiLU, each rerun
   for the same bits; and flash
   Sinkhorn (#7)
   at the 2d_sf2m path's shape (n = m = 2048, d = 2, reg 2), at n != m with tails,
   at d = 32, with a non-uniform loga, at a small reg, at 4096 + 4096 2-D
   points (beyond the clouds' room in shared memory, so tiled) and at
   CIFAR-10's batch and width (128 points, d = 3072, too wide for a tile
   of coordinates in shared memory; scaled to the d = 32 case's costs):
   f and g within
   1e-4 relative + 1e-5 reg absolute of the plain version after 50
   iterations, and at tol 1e-6 stopping counts within 1 of each other and
   both implied plans within the tolerance, a rerun repeating the bits and
   the iteration count; then at CIFAR-10's raw scale (d = 3072, reg 100,
   50 iterations) the plans that the kernel's and the plain version's
   potentials imply, within 4 f32 ulps of the costs' magnitude over reg of
   the f64 plan's in the log of every entry.
4. Times each kernel with CUDA events (the attention-block forward at the
   training and the generation batch and at ImageNet-64's 8x8 shape, and
   its backward at the CIFAR-10 and ImageNet-64 training shapes, by device
   time in turns with the library composition, with their device
   operations a call and their kernels' times; the multi-head attention forward and
   backward at the ImageNet-64 training shape, in turns with
   ``F.scaled_dot_product_attention`` and its backward, by device time from
   the profiler as well, with the backward's FMA variant of dq and dk, and
   again at the 32x32 blocks' (64, 6, 1024, 64) on the streamed route, with
   the backward also without the forward's statistics and the plain
   composition's forward and backward through autograd; each kernel's time
   by name; the
   GroupNorm kernels at every recorded shape of every path, by device time
   in CUDA graphs beside ``F.group_norm`` + ``F.silu``, and summed over
   each path's evaluation, and at 2x256x256x256 float32 (the split route)
   beside its bytes bound and the library's forward and autograd; the
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
    steps: 14 multi-head attention (#3: 7 at 16x16, 7 at 32x32 on the
    streamed route), 8 attention-block and 87 GroupNorm launches per
    evaluation. Prints images per second, ms per evaluation
    and the peak memory; then profiles one evaluation as in 7.
12. ImageNet-64 training: ``make_train_step`` with exact OT-CFM and the
    labels, bf16, batch 32, dropout 0.1, Adam 1e-4 with the warmup
    schedule, clip 1.0, EMA 0.9999, on random uint8 images and labels put
    on the card once; 3 warm-up steps, then 20 with 1 auction, 14 + 14
    multi-head attention, 8 + 8 attention-block and 87 + 87 GroupNorm
    launches a step; then three steps profiled as in 9.
13. The 2-D tutorial: ``Trainer`` on ``2d_otcfm`` as the preset gives it
    (MLP width 64, batch 256, W1 and W2 on 2048 points every 1000 steps)
    for 2000 of its 5000 steps (phase 34 trains the same recipe): 2000
    dense (#5) and 4 tiled (#6) auction launches. Prints
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
18. The presets as given: ``cli.main(["train", "cifar10_otcfm", ...])`` with
    only the step count and the intervals cut (40 steps, a checkpoint at 20,
    an evaluation at 40: 2048 images by dopri5 and the tracking FID), then
    its final evaluation; a new ``Trainer`` resumes at 40 with the saved
    tensors bit for bit (and a restore on the CPU too) and fits to 60 (1
    auction, 5 + 5 attention-block and 46 + 46 GroupNorm launches a step); a
    third resumes at 60, and one step from it and from the live state, with
    the same ``StepDraws`` under ``cudnn.deterministic``, gives the same
    bits; one more step with ``trainer.debug_nans`` (anomaly mode: the
    same launches); ``cli eval``; ``compute_fid --synthetic`` from that checkpoint,
    2048 images by euler-100 through the tracking features, then 512 by
    dopri5 through the Inception trunk with random weights from an npz
    (``CFM_TPU_INCEPTION_WEIGHTS``), the trunk's card and CPU features
    agreeing under ``strict_f32`` on 2 images. Logs the seconds to save and
    restore a recipe checkpoint, to evaluate and to take a tracking FID,
    Inception images/s and the FID lines, beside the card's name and power
    limit.

19. MNIST [SF]2M by SDE: ``train_mnist.main(["--matcher", "sbcfm", "--sde",
    "--synthetic", ...])`` at the preset's width and batch (two bf16 UNets,
    batch 128): 30 steps (1 auction, 54 + 54 GroupNorm launches a step) and
    64 images by the SDE of both EMA heads (Euler-Maruyama, 100 steps: 54
    GroupNorm launches a step, nothing else); 20 more steps timed; one
    evaluation with ``eval.sde`` (2048 images: euler-100, then the SDE with
    the KL); 64 images by ``generate_sde`` timed; the same rollout on the
    same noise with random seeded heads through the kernels and through the
    plain versions on the card, the final within MNIST_SDE_TOL of its
    max-abs.
20. ``2d_sf2m`` as given with ``eval.sde=True``, 300 steps, then one
    evaluation: W1, W2, ``sde_kl``, ``sde_w2`` on the same 2048 target
    points, three #6 launches; then the heun method's rollout.
21. Activation checkpointing: ``cifar10_otcfm`` (dropout 0.1, through the
    ``Trainer``) and the ImageNet-64 model (dropout 0.1, batch 32), each
    with ``use_checkpoint`` off, on with policy None and on with "dots":
    ms and device ms a step, the peak memory, the launches (a wrapped
    block's forward kernels twice a step: #1 5 + 5 and #8 46 + 45 for
    CIFAR-10; #3 14 + 14, #1 8 + 8 and #8 87 + 86 for ImageNet-64); then one
    step from the same state with the same ``StepDraws`` under
    ``cudnn.deterministic`` for each policy, whose parameters and generator
    state must equal the unwrapped step's bit for bit.
22. tsit5 and the adjoint: the recipe width (random weights) generating
    512 images by tsit5 over ``generate``'s two-point span and over
    ``Trainer.generate``'s 101-point grid, beside phase 6's dopri5; then
    ``odeint_adjoint`` through the MNIST flow head on 8 images at
    rtol = atol = 1e-4 (#8 in every evaluation, #9 in every vector-Jacobian
    product of the backward), its gradients within ADJOINT_GRAD_TOL of the
    same adjoint through the plain versions on the card.

23. The single-cell path as given: ``single_cell.run(["--synthetic"])``
    (the tree population, n = 4096 a timepoint, T = 5, dim 2, batch 256,
    2000 steps, MLP width 64, f32): one dense auction (#5) a step and
    nothing else, the first 3 steps' #5 permutations and round counts equal
    to its plain version's on the same costs; ms a step, the device-busy
    share of 3 profiled steps, the one evaluation's seconds and the rounds
    of its 8 plain scatter-auction solves at n = 1000 (not a multiple of
    256, so neither kernel, by JAX's rule), the 8 metrics. Then the
    ``--npz`` route on a 5-D tree population of unequal sizes a timepoint,
    written by the phase, 300 steps (the evaluation's 8 solves at n = 512
    are #5 launches).
24. ``--synthetic --joint-plans --leaveout 2`` through ``SingleCell``: 7
    exact plans of the whole marginals up front, each one tiled-auction
    (#6) launch at n = 4096, each permutation valid and SC_SCIPY_PLANS'
    within 1e-5 relative of scipy's optimum; no solve a
    step; the held-out timepoint's W2 alone (phase 23 times the whole
    evaluation). Prints the seconds to solve the plans and build the CDFs,
    ms a step and the held-out W2. It runs before phase 3, whose untimed
    checks overlap scipy's solves in worker processes.
25. Spline CFM (``SplineConditionalFlowMatcher(sigma=0.1,
    ot_method="exact")``) training the MLP on (256, 5, 2) batches for 300
    steps, 4 #5 launches a step, after one batch's (t, xt, ut) on the card
    held within 1e-5 of the CPU's; then ``interpolate_with_ot`` at
    timepoint 2 from phase 24's plan between timepoints 1 and 3 and its
    ``earth_mover_distance`` to the held-out marginal.
26. GRN: ``MLPODEF`` structure recovery (500 steps, true edges above
    absent ones); a 5-member ``MLPODEF`` ensemble and a DiBS particle set
    with one ``svgd_update`` at 100 genes, hidden 10, 1000 cells, the card
    within 1e-5 of the CPU.

27. CNF maximum likelihood, ``maximum_likelihood_CNF_tutorial`` as given:
    ``MLP(2, w=64)`` trained by ``make_cnf_nll_loss(n_steps=40,
    divergence="exact")`` on moons at batch 128, Adam 2e-3, 300 steps (cut
    to 120 for the time limit, the cut printed; the NLL must fall);
    ``cnf_log_likelihood`` on the 60x60 grid at 60 steps; card
    against CPU: one batch's loss and gradients, the adaptive-adjoint route
    with Hutchinson probes (and two more steps by it), ``augmented_odeint``
    by dopri5 with the six regularisers.
28. The minibatch-OT study notebook as given: 20 exact plans at 256 (#5),
    Var[u] under OT below the independent coupling's; I-CFM and OT-CFM 600
    steps each (OT-CFM's 600 #5 launches), OT-CFM straighter on 1024
    points; ``reflow_pairs`` at 1024 points and 100 steps.
29. Bridges: SB-CFM on the SB Gaussians (a = 0.1, sigma 0.5, 400 steps,
    rk4 on 4096 points, largest marginal KL under 0.15); DSBM with two
    MLPs for 400 steps and its ``sb_trajectory_kl``;
    ``ScheduleBridgeMatcher`` under three schedules and forward and reverse
    ``ipf_resample_pairs`` at 4096 points, card against CPU.
30. Action matching (``_ActionNet``, 300 steps) and ``GradModel``, card
    against CPU; the dual ICNNs for 500 alternating steps, their
    ``w2_estimate`` beside half the exact squared W2 at 2048 (one #6
    launch); ``average_ut``, card against CPU.
31. The diffeq zoo at real width, forward and gradients card against CPU:
    ``ODEnet`` of the seven linear types, ``ConvODEnet`` at FFJORD's MNIST
    widths on (256, 28, 28, 1), the (1, 2, -2, 1) stride stack with a
    squeeze, ``ResNetDiffEq(1, 64, 4)`` (its GroupNorms #8 and #9; phase 3
    holds both kernels at its shapes), ``HyperConv2d``,
    ``AutoencoderDiffEqNet``; the FFJORD net's Hutchinson log-likelihood
    timed.

32. Data parallelism at world size 1 under NCCL on the CIFAR-10 recipe
    (35,746,307 parameters, bf16, global batch 128, dropout 0.1, under
    ``cudnn.deterministic``): 3 steps of ``make_data_parallel_train_step``
    equal the one-process step bit for bit given the same draws, with the
    same launches a step (1 auction, 5 + 5 attention-block, 46 + 46
    GroupNorm); one step under ``set_sync_debug_mode("error")``; 10 steps
    timed beside phase 8's; ``Trainer.fit`` with ``trainer.data_parallel``
    on and off, the same bits.
33. Two ranks on the one card over gloo (NCCL takes one rank a card): the
    replicated-coupling recipe step at global batch 128 against the
    one-process oracle, the ranks' parameters equal bit for bit; the
    data-parallel sampler (256 images, euler-100) against one-process
    ``odeint``; ``sharded_sinkhorn_plan`` at n = m = 2048, d = 2, reg 2
    against the dense plan; ms a step and a gloo all-reduce's ms (through
    the host). Phases 32-33 must finish within DP_BUDGET_S.

34. The examples: ``train_2d.main`` in this process, OT-CFM at its
    defaults (2000 steps at batch 256, 2000 #5 launches, W2 under 0.9),
    SB-CFM with the score head and the SDE and I-CFM with dopri5 (300 steps
    each: 300 and 0 #5 launches), three #6 launches an evaluation (W1, W2,
    the source's W2 at 2048), the counts exact; ``tabular_forest_flow.main``
    raising scikit-learn's ``ImportError`` where it is not installed.
35. The notebooks: each of ``cfm_tpu_torch/notebooks/`` read as JSON, its
    code cells but the ``plot`` ones run in order in one namespace at the
    CPU test's sizes (``gen_notebooks.SMOKE``, ``DEVICE = "cuda"``), the
    launches of each counted exactly (#5 and #6 in the 2-D and single-cell
    ones, #5, #8 and #9 in the MNIST ones, none in the CNF one); the
    Forest-Flow notebook raising scikit-learn's ``ImportError``. Phases
    34-35 must finish within EXAMPLES_BUDGET_S.

Every ``Trainer`` and ``cli`` run writes its checkpoints and logs into a
fresh directory under ``build/smoke_runs/``. The phases that time ``fit``
(8 to 10, 13, 16, 19 and 21) build their trainers with checkpoint saves
skipped, so their windows hold the steps alone; phase 18 times the saves.

The last three lines are the kernels' JSON record (``launches`` summed over
the paths of phases 6, 8, 10 to 14, 16 to 25, 28 to 32, 34 and 35), the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
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
# Launches per ImageNet-64 evaluation: the 16x16 blocks take #3, the 32x32
# blocks #3 on its streamed route, the 8x8 blocks #1.
IMAGENET_PER_EVAL = dict(attention_fwd=14, attn_block_fwd=8, gn_silu_fwd=87)
# (N, H, S, D) of the multi-head attention checks: the ImageNet-64 training and
# generation shapes of the 16x16 blocks and of the 32x32 blocks (beyond the
# gate: #3 and #4 on their streamed route; generation's is also a card's 64
# rows in the data-parallel training cell), the gate's smallest S, a long S,
# head dim 128, the gate's edges at D = 64 and 128, which take the two-pass
# routes, and D = 128 on the streamed route.
ATTN_SHAPES = ((IMAGENET_BATCH, 9, 256, 64), (IMAGENET_GEN, 9, 256, 64),
               (IMAGENET_BATCH, 6, 1024, 64), (IMAGENET_GEN, 6, 1024, 64), (4, 1, 128, 64),
               (2, 2, 512, 64), (4, 2, 256, 128), (2, 2, 896, 64), (1, 1, 768, 128),
               (2, 2, 1024, 128))
ATTN_MAIN = ATTN_SHAPES[:4]  # the main path's, whose bf16 errors the kernels' record keeps
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
FLASH_RAW_ULPS = 4  # flash_raw_scale's gate on the implied plans, in f32 ulps of the costs
ROOT = os.path.dirname(os.path.abspath(__file__))
# Phase 18: cifar10_otcfm as given but for the steps and intervals.
PRESET_STEPS, PRESET_CKPT, PRESET_EVAL, PRESET_RESUMED = 40, 20, 40, 60
# The FID images: 2048 and 512 (4096 and 1024 until phases 32-33 joined the
# script's time limit).
PRESET_FID_GEN, PRESET_INCEPTION_N = 2048, 512
INCEPTION_TOL = 1e-4  # the trunk's card vs CPU features under strict_f32, relative to the max


def flash_ops(d):
    """Operations per cost entry and pass of #7: d multiply-adds (2d) for
    the dot product, the norms' add, the -2 x.y term, the subtraction from
    the potential, the scale by 1/reg, the subtraction of the running max,
    the exp (counted as one operation) and the add to the running sum."""
    return 2 * d + 7


def log(*a):
    print(*a, flush=True)


def run_dir(tag):
    """A fresh directory for one phase's checkpoints and logs."""
    d = os.path.join(ROOT, "build", "smoke_runs", tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def phase_trainer(preset, overrides, tag, skip_saves=False):
    """``Trainer(load_config(preset, overrides))`` with its checkpoints and
    logs under ``run_dir(tag)``. With ``skip_saves`` its checkpoint
    manager saves nothing: the phases that time ``fit`` keep the save out of
    their windows (phase 18 times it)."""
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.trainer import Trainer

    d = run_dir(tag)
    trainer = Trainer(load_config(preset, list(overrides) + [f"trainer.ckpt_dir={d}/ckpt"]),
                      log_dir=f"{d}/logs")
    if skip_saves:
        trainer.ckpt.save = lambda *args, **kwargs: False
    return trainer


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
            ms, n_ops, _ = device_ms_and_launches(fn)
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
    bf16 forward and backward called again on the same inputs must give the
    same bits.
    Returns the largest bf16 forward and backward errors at the ImageNet-64
    shapes (ATTN_MAIN)."""
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
            gated = att.gate(H, S, D, dtype) or att.streamed_route(S, D, dtype)
            if (att.attention_t.launches - launched[0], att.attention_t_bwd.launches
                    - launched[1]) != (int(gated), int(gated)):
                raise AssertionError(f"attention at N={N} H={H} S={S} D={D} {dtype} launched "
                                     f"the kernels otherwise than its route says ({gated})")
            key = str(dtype).split(".")[1]
            tol, errs = TOL[key], {}
            for name, a, r in (("fwd", out, ref), ("bwd", leaf.grad, ref_bwd)):
                e = (a.float() - r.float()).abs()
                errs[name] = e.max().item()
                if (e > tol + tol * r.float().abs()).any() or not torch.isfinite(a).all():
                    raise AssertionError(f"attention_{name} disagrees with its plain version at "
                                         f"N={N} H={H} S={S} D={D} {dtype}: max error "
                                         f"{errs[name]:.3e}")
                if dtype == torch.bfloat16 and (N, H, S, D) in ATTN_MAIN:
                    worst[name] = max(worst[name], errs[name])
            rerun = ""
            if dtype == torch.bfloat16:
                with torch.no_grad():
                    fwd_again = att.attention_t(qkv, scale)
                again = att.attention_t_bwd(qkv, do.contiguous(), scale)
                torch.cuda.synchronize()
                if not torch.equal(fwd_again, out.detach()):
                    raise AssertionError(f"attention_fwd at N={N} H={H} S={S} D={D} gave other "
                                         f"bits on a rerun")
                if not torch.equal(again, leaf.grad):
                    raise AssertionError(f"attention_bwd at N={N} H={H} S={S} D={D} gave other "
                                         f"bits on a rerun")
                rerun = "; the forward's and the backward's reruns give the same bits"
            route = "" if gated else " (the plain composition, as in JAX)"
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


def device_ms_and_launches(fn, calls=20, names=()):
    """``device_ms``, the device operations (kernels, copies, fills) the
    profiler records per call and the device ms a call by kernel name: each
    of ``names`` sums the kernels whose name holds it, "other" the rest.
    Where no session records device time, the time is taken by CUDA events
    around the calls instead (``cuda_ms``, host time included) and the
    operations and the split are None: not measured."""
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
        return cuda_ms(fn, iters=calls), None, None
    by = dict.fromkeys((*names, "other"), 0.0)
    for e in events:
        key = next((n for n in names if n in e.key), "other")
        by[key] += e.self_device_time_total / calls / 1e3
    return sum(by.values()), sum(e.count for e in events) / calls, by


def time_attention(shape=ATTN_SHAPES[0]):
    """Phase 4: #3 and #4 at an ImageNet-64 training shape (by default the
    16x16 blocks', N=32, 9 heads, S=256, D=64), bf16, beside their plain
    versions and the library yardsticks: ``F.scaled_dot_product_attention``
    on the same q, k, v for #3 and the backward alone of autograd through it
    for #4. Kernel and library are timed in turns (kernel, library, library,
    kernel), by device time (``device_ms``: what the JSON record keeps; the
    kernel's also by kernel name) and by CUDA events around 20 eager calls
    (host time included where the host is slower than the card). #4 takes dq
    and dk as three exact bf16 products; its f32 FMA variant is timed in the
    same turns, the A/B behind that choice. Above S = 256 #4 takes the rows'
    statistics the forward kept, as the autograd Function does, and is timed
    without them in the same turns too; a shape beyond the gate (the 32x32
    blocks', on the streamed route) also times the plain composition's
    forward and backward through autograd, what such blocks ran before."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import attention as att

    N, H, S, D = shape
    scale = 1.0 / math.sqrt(D)
    qkv, do = attention_inputs(N, H, S, D, torch.bfloat16)
    q, k, v = (t.detach().requires_grad_() for t in qkv.unbind(1))
    y = F.scaled_dot_product_attention(q, k, v)
    saved = None
    if S > 256:
        saved = torch.empty((2, N, H, S), dtype=torch.float32, device="cuda")
        with torch.no_grad():
            att._forward(qkv, scale, saved)
    fns = {"attention_fwd": (lambda: att.attention_t(qkv, scale),
                             lambda: F.scaled_dot_product_attention(q.detach(), k.detach(),
                                                                    v.detach())),
           "attention_bwd": (lambda: att.attention_t_bwd(qkv, do, scale, saved),
                             lambda: torch.autograd.grad(y, (q, k, v), do, retain_graph=True))}
    names = {"attention_fwd": ("attention_resident", "attention_streamed"),
             "attention_bwd": ("attention_bwd_rows", "attention_bwd_cols")}
    variants = {"fma": ("the FMA variant of dq and dk",
                        lambda: att._backward(qkv, do, scale, split=False))}
    if saved is not None:
        variants["unsaved"] = ("without the forward's statistics",
                               lambda: att.attention_t_bwd(qkv, do, scale))
    route = "" if att.gate(H, S, D, torch.bfloat16) else " (streamed route)"
    out = {}
    for name, (kernel, library) in fns.items():
        extra = variants if name == "attention_bwd" else {}
        turns = {who: [] for who in ("kernel", "library", *extra)}
        by_kernel = []
        for who in ("kernel", "library", "library", "kernel"):
            fn = kernel if who == "kernel" else library
            ms, _, by = device_ms_and_launches(fn, names=names[name] if who == "kernel" else ())
            turns[who].append((ms, cuda_ms(fn)))
            if who == "kernel":
                by_kernel.append(by)
                for var, (_, f) in extra.items():
                    turns[var].append((device_ms(f), cuda_ms(f)))
        mean = {who: [sum(t[i] for t in ts) / len(ts) for i in (0, 1)] for who, ts in turns.items()}
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
        split = ""
        if None not in by_kernel:
            split = "; " + ", ".join(f"{n} {sum(b[n] for b in by_kernel) / len(by_kernel):.4f}"
                                     for n in by_kernel[0] if any(b[n] for b in by_kernel))
        line = (f"{name} timing N={N} H={H} S={S} D={D} bf16{route}, device time: kernel "
                f"{ms:.4f} ms ({fmt(turns['kernel'])}{split}; {100 * bound_ms / ms:.1f}% of the "
                f"{bound_ms:.4f} ms bound by {bound_by}), library {lib_ms:.4f} ms "
                f"({fmt(turns['library'])}), kernel / library {ms / lib_ms:.3f}")
        for var, (label, _) in extra.items():
            line += (f"; {label} {mean[var][0]:.4f} ms ({fmt(turns[var])}), kernel / {var} "
                     f"{ms / mean[var][0]:.3f}")
        line += (f"; eager, 20 calls between CUDA events: kernel {eager(turns['kernel'])}, "
                 f"library {eager(turns['library'])}")
        for var in extra:
            line += f", {var} {eager(turns[var])}"
        log(line + f" ms; plain {plain_ms:.4f} ms")
    if route:
        leaf = qkv.clone().requires_grad_()
        ms = cuda_ms(lambda: torch.autograd.grad(att.attn_reference_t(leaf, scale), leaf, do),
                     iters=3, warmup=1)
        log(f"attention N={N} H={H} S={S} D={D} bf16: the plain composition's forward and "
            f"backward through autograd {ms:.3f} ms (CUDA events)")
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
    for n in (2, 8, 64, 128, 200, 256, 512):
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
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost

    trainer = phase_trainer("2d_otcfm", ["trainer.ckpt_interval=0"], "twod_cost")
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
        dev_ms, ops, _ = device_ms_and_launches(lambda: fn(cost))
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
    n = 256, 1024 and 2048 (the 2-D evaluation's size; not rank 1 at 1024
    and 2048 nor ties at 2048), and on the evaluation's W1 and W2 costs at
    768 (the notebooks' size in phase 35), 1024 and 2048. The plain version takes about 1 ms a round on the card
    (rank 1 at n = 2048, where every row bids in most rounds, some 60k
    rounds), so there and at n = 4096 (row tile 128, the benefit in HBM) the
    kernel's permutation is held to scipy's alone: every checked
    permutation must be valid and its cost within 1e-5 relative of scipy's
    optimum. The W1 and W2 costs are phase 4's (seed n + 1), so phase 4
    reports the plain version's time on W1 from here. Returns {n: the plain
    version's seconds on the W1 cost}."""
    import torch
    from scipy.optimize import linear_sum_assignment
    from cfm_tpu_torch.ops import auction as au

    plain_s = {}
    fn = au.pallas_auction_assignment_tiled
    kinds = ("gauss", "ties", "dups", "rank1", "w1", "w2")
    # The slowest plain solves (35-61 s each on the card's host), held to
    # scipy's optimum alone since phases 32-33 joined the script's time
    # limit; rank 1 and ties keep their plain check at the sizes below.
    no_plain = {(1024, "rank1"), (2048, "rank1"), (2048, "ties")}
    cases = [(256, k) for k in kinds[:4]] + [(768, "w1"), (768, "w2")]
    cases += [(1024, k) for k in kinds]
    cases += [(2048, k) for k in kinds] + [(4096, "w1")]
    for n, kind in cases:
        cost = (eval_cost(n, seed=n + 1, power=int(kind[1])) if kind in ("w1", "w2")
                else auction_cost(n, kind, seed=n))
        perm = fn(cost)
        torch.cuda.synchronize()
        k_rounds, scans = int(fn.last_rounds.item()), int(fn.last_row_scans.item())
        line = f"tiled auction n={n} {kind}: {k_rounds} rounds, {scans} row scans"
        if n < 4096 and (n, kind) not in no_plain:
            t0 = time.perf_counter()
            ref, rounds = au.auction_assignment_tiled_reference(cost)
            torch.cuda.synchronize()
            if not torch.equal(perm, ref) or k_rounds != rounds:
                raise AssertionError(f"{line}: the kernel's perm or round count ({k_rounds} vs "
                                     f"{rounds}) differs from its plain version")
            if kind == "w1":
                plain_s[n] = time.perf_counter() - t0
            line += f"; identical to the plain version ({time.perf_counter() - t0:.1f} s)"
        if sorted(perm.tolist()) != list(range(n)):
            raise AssertionError(f"{line}: not a permutation")
        c = cost.double().cpu().numpy()
        r, col = linear_sum_assignment(c)
        opt, got = c[r, col].sum(), c[r, perm.cpu().numpy()].sum()
        if abs(got - opt) > 1e-5 * max(abs(opt), 1e-30):
            raise AssertionError(f"{line}: cost {got} vs scipy's {opt}")
        log(f"{line}; cost {got:.6f}, scipy's optimum {opt:.6f}")
    return plain_s


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


def time_auction_tiled(plain_s):
    """Phase 4: #6 at n = 1024, 2048 (the 2-D evaluation's size) and 4096 on
    the W1 evaluation cost, beside its plain version (``plain_s``: phase 3's
    wall time of it on the same cost, {n: seconds}), scipy's solver on the
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
            plain_ms = plain_s[n] * 1e3
            plain = f"{plain_ms:.1f} ms (phase 3's check on this cost)"
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
        ms, n_ops, _ = device_ms_and_launches(fn)
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


NB_MNIST_BATCH = 8  # the MNIST notebooks' batch at phase 35's sizes (gen_notebooks.SMOKE)


def notebook_mnist_models():
    """The MNIST notebooks' UNets: the presets at 16 channels, as their
    ``Trainer`` builds them (class-conditional, unconditional)."""
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.trainer import build_model

    return tuple(build_model(load_config(preset, ["model.num_channels=16"]), "cuda")
                 for preset in ("mnist_otcfm_cond", "mnist_otcfm"))


def record_gn_shapes(imagenet):
    """Phase 3: the (N, H, W, C, groups, dtype, SiLU) tuples, with their counts,
    that ``GroupNorm32`` gives the GroupNorm wrapper in one model evaluation of
    each path at its batch: CIFAR-10 generation (512) and training (128, in
    train mode), MNIST training (128) and generation (80, 8 per class), the
    ImageNet-64 model ``imagenet`` in generation (64) and training (32, in
    train mode), and the MNIST notebooks' 16-channel UNets at phase 35's
    sizes (training and evaluation at 8, generation at 80 by class and at
    64)."""
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
        nb_cond, nb_mnist = notebook_mnist_models()
        train = dict(train=True, generator=torch.Generator(device="cuda"))
        with torch.no_grad():
            for name, model, n, dim, kw in (
                    ("cifar10 generation", recipe, GEN_BATCH, RECIPE["dim"], {}),
                    ("cifar10 training", recipe, TRAIN_BATCH, RECIPE["dim"], train),
                    ("mnist training", mnist, TRAIN_BATCH, (28, 28, 1), {}),
                    ("mnist generation", mnist, MNIST_GEN, (28, 28, 1), {}),
                    ("imagenet64 generation", imagenet, IMAGENET_GEN, IMAGENET64["dim"], {}),
                    ("imagenet64 training", imagenet, IMAGENET_BATCH, IMAGENET64["dim"], train),
                    ("mnist notebook training", nb_cond, NB_MNIST_BATCH, (28, 28, 1), {}),
                    ("mnist notebook generation", nb_cond, MNIST_GEN, (28, 28, 1), {}),
                    ("mnist notebook unconditional generation", nb_mnist, 64, (28, 28, 1), {})):
                seen.clear()
                labelled = model is not recipe and model is not nb_mnist
                y = (torch.arange(n, device="cuda") % 10,) if labelled else ()
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


def check_gn_case(x, scale, bias, dy, G, silu, what, eps=1e-5):
    """#8 and #9 against the plain versions on the same card tensors: out and
    dx element-wise within TOL abs + rel; mean within 1e-5 of |mean| + std and
    inv within 1e-5 relative; dscale and dbias within WGRAD_TOL of their
    max-abs. Returns the largest absolute out and dx errors."""
    import torch
    from cfm_tpu_torch.ops import groupnorm as gn

    key = str(x.dtype).split(".")[1]
    tol, wtol = TOL[key], WGRAD_TOL[key]
    out, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, eps, silu)
    dx, dscale, dbias = gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy, G, silu)
    r_out, r_mean, r_inv = gn.gn_silu_fwd_reference(x, scale, bias, G, eps, silu)
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
    """Phase 3: every recorded shape, where both kernels' reruns must give
    the same bits, then the recentred-variance case: f32
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
        _, mean, inv = first
        grads = [gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy, G, silu)
                 for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*grads)):
            raise AssertionError(f"gn_silu_bwd's rerun differs at {N}x{H}x{W}x{C} {dt}")
        plan = gn.strip_plan(N, H * W, C, G, x.element_size())
        bplan = gn.strip_plan(N, H * W, C, G, x.element_size(), backward=True)
        log(f"gn_silu N={N} {H}x{W}x{C}/{G} {dt} silu={silu}: " +
            ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
            f"; the forward's and the backward's reruns give the same bits; plan width "
            f"{plan.width}, cluster {plan.cluster}, items {plan.items}; backward plan width "
            f"{bplan.width}, cluster {bplan.cluster}, items {bplan.items}")
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


def check_gn_diffeq(width=64):
    """Phase 3: #8 and #9 at every shape ``ResNetDiffEq(1, width, 4)`` gives
    the GroupNorm wrapper on phase 31's (64, 28, 28, 1) images (recorded by
    wrapping it for one forward): min(16, width) groups (16 of 4 channels at
    width 64; 6 of one channel at width 6, whose 24-byte rows take the split
    route), eps 1e-4, no SiLU, f32; both rerun for the same bits. Returns
    the largest out and dx errors."""
    import torch
    from cfm_tpu_torch.models import diffeq
    from cfm_tpu_torch.ops import groupnorm as gn

    wrapped, seen = diffeq.fused_group_norm_silu, []

    def recording(x, scale, bias, num_groups, eps, apply_silu):
        seen.append(tuple(x.shape) + (num_groups, eps, apply_silu))
        return wrapped(x, scale, bias, num_groups, eps, apply_silu)

    diffeq.fused_group_norm_silu = recording
    try:
        with torch.no_grad():
            diffeq.ResNetDiffEq(1, width, 4, device="cuda")(0.5, torch.randn(64, 28, 28, 1,
                                                                             device="cuda"))
    finally:
        diffeq.fused_group_norm_silu = wrapped
    worst = {"out": 0.0, "dx": 0.0}
    for i, (N, H, W, C, G, eps, silu) in enumerate(dict.fromkeys(seen)):
        x, scale, bias, dy = gn_inputs(N, H, W, C, torch.float32, seed=100 + i)
        what = f"ResNetDiffEq's {N}x{H}x{W}x{C}/{G} float32 eps {eps}"
        errs = check_gn_case(x, scale, bias, dy, G, silu, what, eps=eps)
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        runs = [gn.fused_group_norm_silu_fwd(x, scale, bias, G, eps, silu) for _ in range(2)]
        grads = [gn.fused_group_norm_silu_bwd(x, scale, bias, *runs[0][1:], dy, G, silu)
                 for _ in range(2)]
        if not (all(torch.equal(a, b) for a, b in zip(*runs))
                and all(torch.equal(a, b) for a, b in zip(*grads))):
            raise AssertionError(f"a GroupNorm kernel's rerun differs at {what}")
        log(f"gn_silu at {what}, {seen.count((N, H, W, C, G, eps, silu))} calls a pass: " +
            ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
            f"; reruns give the same bits; plan {gn.strip_plan(N, H * W, C, G, 4)}; backward "
            f"plan {gn.strip_plan(N, H * W, C, G, 4, backward=True)}")
    return worst


# (N, H, W, C, G, dtype) that no strip on chip holds, so #8 and #9 take the
# split route (csrc/gn_split.cuh): a float32 strip of 8 channels over 256x256
# rows (2 MB; guided-diffusion's 256x256 UNet's first level), bf16 C = 12 in
# 12 groups (24-byte rows), groups of 512 channels (ResNetDiffEq at
# intermediate_dim 8192); and N above a grid's 65535 rows, where the strip
# launches once for each 65535 rows of items (at 17x17 a block takes one
# item; at 1x1 eight, so one launch).
GN_BEYOND = ((2, 256, 256, 256, 32, "float32"), (64, 28, 28, 12, 12, "bfloat16"),
             (2, 4, 4, 8192, 16, "float32"), (70000, 1, 1, 32, 16, "float32"),
             (70000, 17, 17, 32, 32, "float32"))


def check_gn_beyond():
    """Phase 3: #8 and #9 at GN_BEYOND's shapes, with and without the SiLU,
    as ``check_gn_case`` holds them, both rerun for the same bits (the split
    route's combines have a fixed order too). Returns the largest out and dx
    errors."""
    import torch
    from cfm_tpu_torch.ops import groupnorm as gn

    worst = {"out": 0.0, "dx": 0.0}
    for i, (N, H, W, C, G, dt) in enumerate(GN_BEYOND):
        x, scale, bias, dy = gn_inputs(N, H, W, C, getattr(torch, dt), seed=200 + i)
        what = f"{N}x{H}x{W}x{C}/{G} {dt}"
        for silu in (False, True):
            errs = check_gn_case(x, scale, bias, dy, G, silu, f"{what} silu={silu}")
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
        runs = [gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True) for _ in range(2)]
        grads = [gn.fused_group_norm_silu_bwd(x, scale, bias, *runs[0][1:], dy, G, True)
                 for _ in range(2)]
        if not (all(torch.equal(a, b) for a, b in zip(*runs))
                and all(torch.equal(a, b) for a, b in zip(*grads))):
            raise AssertionError(f"a GroupNorm kernel's rerun differs at {what}")
        log(f"gn_silu beyond the strip at {what}: " +
            ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
            f" (silu); reruns give the same bits; plan "
            f"{gn.strip_plan(N, H * W, C, G, x.element_size())}; backward plan "
            f"{gn.strip_plan(N, H * W, C, G, x.element_size(), backward=True)}")
        del x, dy, runs, grads
    torch.cuda.empty_cache()
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


def time_gn_beyond(smi):
    """Phase 4: #8 and #9 at (2, 256, 256, 256) float32 in 32 groups with the
    SiLU (the split route), by device time in CUDA graphs, beside their
    bytes bounds and ``F.group_norm`` + ``F.silu`` (the backward: autograd
    of it, by the profiler's device time). Returns the times."""
    import torch
    import torch.nn.functional as F
    from cfm_tpu_torch.ops import groupnorm as gn

    N, H, W, C, G = GN_BEYOND[0][:5]
    x, scale, bias, dy = gn_inputs(N, H, W, C, torch.float32)
    out = {}
    with torch.no_grad():
        _, mean, inv = gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True)
        out["fwd"] = graph_ms(lambda: gn.fused_group_norm_silu_fwd(x, scale, bias, G, 1e-5, True))
        out["bwd"] = graph_ms(lambda: gn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, dy,
                                                                   G, True))
        out["lib_fwd"] = graph_ms(lambda: F.silu(F.group_norm(x.permute(0, 3, 1, 2), G, scale,
                                                              bias)))
    xl, wl, bl = (t.detach().requires_grad_() for t in (x, scale, bias))
    y = F.silu(F.group_norm(xl.permute(0, 3, 1, 2), G, wl, bl))
    out["lib_bwd"] = device_ms(lambda: torch.autograd.grad(y, (xl, wl, bl), dy.permute(0, 3, 1, 2),
                                                           retain_graph=True))
    for d, backward in (("fwd", False), ("bwd", True)):
        out[f"bound_{d}"], _ = gn_bound(N, H * W, C, 4, backward)
        log(f"gn_silu_{d} at {N}x{H}x{W}x{C}/{G} float32 silu (split route, plan "
            f"{gn.strip_plan(N, H * W, C, G, 4, backward)}): {out[d]:.4f} ms device time, "
            f"{100 * out[f'bound_{d}'] / out[d]:.1f}% of its {out[f'bound_{d}']:.4f} ms bytes "
            f"bound; library {out[f'lib_{d}']:.4f} ms ({smi})")
    del x, dy, xl, y
    torch.cuda.empty_cache()
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


TWOD_STEPS = 2000  # phase 13's steps of 2d_otcfm (5000 in the preset; cut for the time limit)


def twod_training():
    """Phase 13: ``Trainer`` on ``2d_otcfm`` as the preset gives it (MLP
    width 64, batch 256, Adam 2e-3, EMA 0.99, W1/W2 on 2048 points every
    1000 steps) for TWOD_STEPS of its 5000 steps (phase 34 trains the same
    recipe through ``train_2d``) with ``trainer.ckpt_interval=0`` (and the
    loss logged every 1000 steps instead of 100). The launch
    counts are set to 0 just before ``fit`` and read just after: one dense
    auction (#5) a step, two tiled auctions (#6) an evaluation. Prints ms per
    step (evaluations excluded) and each evaluation; the final W2 must be
    under 1.1 (the JAX package's 800-step gate), printed beside the 2-moons
    band's OT-CFM threshold. Then three more steps profiled as in phase 9.
    Returns the counts of the steps."""
    import torch

    trainer = phase_trainer("2d_otcfm", ["trainer.ckpt_interval=0", "trainer.log_interval=1000",
                                         f"trainer.total_steps={TWOD_STEPS}"],
                            "2d_otcfm", skip_saves=True)
    cfg = trainer.cfg
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
        d = run_dir(f"cli_2d_{kind}")
        zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train", f"2d_{kind}", f"trainer.total_steps={steps}",
                       "trainer.ckpt_interval=0", "trainer.eval_interval=0",
                       f"trainer.log_interval={steps}", f"trainer.ckpt_dir={d}/ckpt",
                       "--log_dir", f"{d}/logs"])
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
        if name == "dopri5":
            main_path.dopri5 = (out.nfe, GEN_BATCH / sec)  # phase 22's yardstick
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
# with its SiLU epilogue (SiluOut) apart from #1's and #2's GroupNorm stages
# (TokensOut, TokensStats, gn_bwd_strip_kernel).
KERNEL_GROUPS = (
    ("GroupNorm kernels (#8 forward, #9 backward)",
     ("SiluOut", "strip_bwd_kernel", "item_sum_kernel")),
    ("auction kernels (#5, #6)", ("auction_kernel", "auction_tiled_kernel")),
    ("flash Sinkhorn (#7)", ("flash_sinkhorn_kernel",)),
    ("attention-block kernels (#1, #2; their stages share code)",
     ("TokensOut", "TokensStats", "round_weights_kernel", "BlockLayout", "mma_gemm_kernel",
      "gn_stats_kernel", "round_transpose_kernel", "attention_kernel", "gemm_kernel",
      "bmma_kernel", "fgemm_kernel", "softmax_rows_kernel", "softmax_bwd_rows_kernel",
      "colsum_partial_kernel", "sum_parts_kernel", "sum_jobs_kernel", "gn_bwd_kernel",
      "gn_bwd_strip_kernel")),
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

    trainer = phase_trainer(preset, ["trainer.log_interval=1000", "data.synthetic_fallback=True",
                                     f"data.data_dir={data_dir}"], preset, skip_saves=True)
    cfg = trainer.cfg
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
    per_step = dict(auction=1, attention_fwd=14, attention_bwd=14, attn_block_fwd=8,
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
    """Phase 3: #7 and its plain version at CIFAR-10's batch and width
    unscaled (128 points, d = 3072, costs near 9,000, reg 100), 50
    iterations, each against the same iteration in float64 on the dense
    cost. The potentials are fixed only up to (f + k, g - k), and an f32
    solve drifts along that shift as it rounds them (one near 9,000), so f
    and g are logged, not gated: the line gives each solve's mean shift of f
    from the f64 one and the kernel's difference from the plain version
    with the shift removed. The gate holds the plans they imply, pi_ij =
    exp((f_i + g_j - C_ij) / reg), which the shift leaves alone: each
    entry's log, (f_i + g_j - C_ij) / reg, within FLASH_RAW_ULPS f32 ulps of
    the largest magnitude the iteration rounds (the costs, near 9,000, or a
    potential) over reg of the f64 plan's, for the kernel and for the plain
    version. f_i and g_j are each an f32 value of at most that magnitude,
    rounded once and computed from an lse whose terms (a potential less a
    cost) are rounded at the same scale: two ulps each, four for their
    sum."""
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
    # the log of the plan's entries against the f64 plan's: the cost cancels
    plan_err = {name: ((a.double()[:, None] + b.double()[None, :])
                       - (f64[:, None] + g64[None, :])).abs().max().item() / reg
                for name, (a, b) in (("kernel", (f, g)), ("plain", (fr, gr)))}
    top = max(f64.abs().max().item(), g64.abs().max().item(), c.max().item())
    tol = FLASH_RAW_ULPS * 2.0 ** (math.floor(math.log2(top)) - 23) / reg
    line = (f"flash sinkhorn raw scale ({n}, {n}, d={d}) reg {reg}, {iters} iterations: "
            f"max |df| kernel vs plain {(f - fr).abs().max().item():.3e}, of which a shift "
            f"k = {k:.3e} (f + k, g - k), the rest {free:.3e}; mean f - f64: kernel "
            f"{(f.double() - f64).mean().item():.3e}, plain {(fr.double() - f64).mean().item():.3e}"
            f"; implied plans, max |log pi - log pi64|: kernel {plan_err['kernel']:.3e}, plain "
            f"{plan_err['plain']:.3e} (within {tol:.3e}: {FLASH_RAW_ULPS} f32 ulps of {top:.1f}, "
            f"the largest of max C = {c.max().item():.1f}, |f| = {f64.abs().max().item():.1f} "
            f"and |g| = {g64.abs().max().item():.1f}, over reg)")
    if not max(plan_err.values()) <= tol:
        raise AssertionError(line)
    log(line)


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
    dev_ms, ops, _ = device_ms_and_launches(lambda: fn(x, y, la, lb, SF2M_REG, FLASH_CAP,
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

    for preset, overrides in (("2d_otcfm", ["trainer.ckpt_interval=0"]), ("2d_sf2m", SF2M)):
        trainer = phase_trainer(preset, overrides, f"sync_free_{preset}")
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
    from cfm_tpu_torch.ops import flash_sinkhorn as fs

    trainer = phase_trainer("2d_sf2m", SF2M + ["trainer.log_interval=100000",
                                               "trainer.eval_interval=0"], "2d_sf2m",
                            skip_saves=True)
    cfg = trainer.cfg
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


def captured(fn, args):
    """``fn(args)`` with its standard output captured; the output is also
    logged, the config tree left out. Returns (result, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(args)
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith(("|", "`", " ")) or line.startswith("  eval"):
            log(f"  | {line}")
    return result, text


def printed_dict(text, prefix):
    """The dict that the last line starting with ``prefix`` prints."""
    import ast

    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    if not lines:
        raise AssertionError(f"no {prefix!r} line in the output")
    return ast.literal_eval(lines[-1][len(prefix):].strip())


def state_tensors(state):
    return [t.detach() for lst in (state.params, state.ema_params, state.opt_state.mu,
                                   state.opt_state.nu) for t in lst]


def same_bits(a, b):
    """Whether two lists of tensors hold the same bits, and the indices of
    those that differ."""
    import torch

    def raw(t):
        return t.detach().cpu().reshape(-1).view(torch.uint8)

    bad = [i for i, (x, y) in enumerate(zip(a, b))
           if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(raw(x), raw(y))]
    return len(a) == len(b) and not bad, bad


def eval_launches(nfe):
    """The kernels one recipe-width image evaluation of ``nfe`` model
    evaluations launches."""
    return dict(attn_block_fwd=5 * nfe, gn_silu_fwd=GN_PER_EVAL["cifar10"] * nfe)


def random_inception_npz(path, seed=0):
    """The Inception trunk with He-normal kernels and a randomised folded
    BatchNorm (mean and bias N(0, 0.1), var U(0.5, 1.5)) drawn from ``seed``,
    written as the ported-weights npz."""
    import torch
    from cfm_tpu_torch.eval.inception import InceptionV3Features, port_torch_inception_weights

    g = torch.Generator().manual_seed(seed)
    model = InceptionV3Features()
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("conv.weight"):
                t.copy_(torch.randn(t.shape, generator=g) * math.sqrt(2.0 / t[0].numel()))
            elif name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith(("bn.bias", "running_mean")):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    port_torch_inception_weights(model.state_dict(), path)


def presets_as_given(per_step, smi):
    """Phase 18: ``cifar10_otcfm`` as the preset gives it, but for the step
    count and the intervals, through the entry points a user calls: train
    with a checkpoint and two evaluations, resume, evaluate, compute the
    FID both ways. Returns the launch counts of its main-path windows."""
    import numpy as np
    import torch
    from cfm_tpu_torch import cli, compute_fid
    from cfm_tpu_torch.checkpoint import restore_train_state, save_train_state
    from cfm_tpu_torch.config import load_config
    from cfm_tpu_torch.data.images import load_cifar10
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.eval.fid import batched_features, inception_feature_fn
    from cfm_tpu_torch.train import OptState, StepDraws, TrainState
    from cfm_tpu_torch.trainer import Trainer

    root = run_dir("presets")
    out_dir, data_dir = os.path.join(root, "results"), "build/no_cifar10"
    logs = os.path.join(out_dir, "logs")
    ckpt = os.path.join(out_dir, "checkpoints", "cifar10_otcfm")
    over = [f"trainer.ckpt_dir={out_dir}/checkpoints", f"data.data_dir={data_dir}",
            f"trainer.ckpt_interval={PRESET_CKPT}", f"trainer.eval_interval={PRESET_EVAL}"]
    total = dict.fromkeys(kernel_fns(), 0)

    def add(launched):
        for k, v in launched.items():
            total[k] += v

    def expect(what, launched, *parts):
        want = dict.fromkeys(launched, 0)
        for part in parts:
            for k, v in part.items():
                want[k] = want.get(k, 0) + v
        if launched != want:
            raise AssertionError(f"{what}: launches {launched}, expected {want}")
        add(launched)

    # 1. cli train: 40 steps, a checkpoint at 20, the evaluation at 40, the final one.
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rc, text = captured(cli.main, ["train", "cifar10_otcfm", f"trainer.total_steps={PRESET_STEPS}",
                                   *over, "--log_dir", logs])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = read_counts()
    rows = [json.loads(line) for line in open(os.path.join(logs, "cifar10_otcfm_metrics.jsonl"))]
    in_loop = [r for r in rows if "eval/nfe" in r]
    final = printed_dict(text, "final eval:")
    if rc != 0 or len(in_loop) != 1 or in_loop[0]["step"] != PRESET_EVAL:
        raise AssertionError(f"cli train cifar10_otcfm: rc {rc}, evaluations {in_loop}")
    evals = [{k[5:]: v for k, v in in_loop[0].items() if k != "step"}, final]
    if not all(math.isfinite(v) for e in evals for v in e.values()) or any(
            set(e) != {"gen_mean", "gen_std", "nfe", "tracking_fid"} for e in evals):
        raise AssertionError(f"cli train cifar10_otcfm: evaluations {evals}")
    steps = sorted(f for f in os.listdir(ckpt) if f.endswith(".pt"))
    if steps != ["torch_step_20.pt", "torch_step_40.pt"]:
        raise AssertionError(f"cli train cifar10_otcfm: checkpoints {steps}")
    nfe = int(evals[0]["nfe"] + evals[1]["nfe"])
    expect("cli train cifar10_otcfm", launched, {k: v * PRESET_STEPS for k, v in per_step.items()},
           eval_launches(nfe))
    log(f"cli train cifar10_otcfm: {PRESET_STEPS} steps, checkpoints {steps}, evaluations at "
        f"step {PRESET_EVAL} {evals[0]} and final {evals[1]} in {sec:.3f} s; launches "
        f"{launched} ({smi})")

    # 2. A new Trainer resumes at 40 with the saved bits, on the card and on the CPU.
    cfg = load_config("cifar10_otcfm", [f"trainer.total_steps={PRESET_RESUMED}", *over])
    trainer = Trainer(cfg, log_dir=logs)
    saved = torch.load(os.path.join(ckpt, "torch_step_40.pt"), map_location="cpu",
                       weights_only=True)
    saved_tensors = [t for k in ("params", "ema_params", "mu", "nu") for t in saved[k]]
    ok, bad = same_bits(state_tensors(trainer.state), saved_tensors)
    if not ok or trainer.state.step != PRESET_STEPS or trainer.state.opt_state.count != PRESET_STEPS:
        raise AssertionError(f"resume at {trainer.state.step}: tensors {bad} differ from the file")
    cpu_state = TrainState([torch.empty_like(p, device="cpu") for p in trainer.state.params],
                           [torch.empty_like(p, device="cpu") for p in trainer.state.params],
                           OptState(0, [torch.empty_like(p, device="cpu")
                                        for p in trainer.state.params],
                                    [torch.empty_like(p, device="cpu")
                                     for p in trainer.state.params]))
    restore_train_state(os.path.join(ckpt, "torch_step_40.pt"), cpu_state)
    ok_cpu, bad_cpu = same_bits(state_tensors(cpu_state), state_tensors(trainer.state))
    if not ok_cpu or cpu_state.step != PRESET_STEPS:
        raise AssertionError(f"restore on the CPU: tensors {bad_cpu} differ from the card's")
    n_params = sum(p.numel() for p in trainer.state.params)
    log(f"resumed at step {trainer.state.step}: {len(saved_tensors)} tensors "
        f"({4 * n_params} floats) equal the file's bits on the card and restored on the CPU")

    # The recipe checkpoint's save and restore seconds.
    path = os.path.join(root, "timing.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(path, trainer.state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_train_state(path, trainer.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_train_state(path, cpu_state)
    restore_cpu_s = time.perf_counter() - t0
    log(f"recipe checkpoint ({n_params} parameters x 4 f32 copies, "
        f"{os.path.getsize(path) / 1e9:.3f} GB): save {save_s:.3f} s, restore to the card "
        f"{restore_s:.3f} s, restore to the CPU {restore_cpu_s:.3f} s ({smi})")

    # Fit on to 60 from the restored state: the launches of phase 8 a step.
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = read_counts()
    expect("the resumed fit", launched,
           {k: v * (PRESET_RESUMED - PRESET_STEPS) for k, v in per_step.items()})
    log(f"resumed fit to step {trainer.state.step}: {sec:.3f} s with the save at "
        f"{PRESET_RESUMED}; checkpoints {trainer.ckpt.all_steps()}; launches {launched}")

    # 3. The next step from the live state and from the state restored from its
    # checkpoint, with the same draws, under cudnn.deterministic: the same bits.
    again = Trainer(cfg, log_dir=logs)
    ok, bad = same_bits(state_tensors(again.state), state_tensors(trainer.state))
    if not ok or again.state.step != PRESET_RESUMED:
        raise AssertionError(f"resume at {again.state.step}: tensors {bad} differ")
    x0, x1 = trainer._prep(trainer._batch()[0])

    def draws():
        return StepDraws.draw(torch.Generator(device="cuda").manual_seed(7), x0, coupled=True,
                              dropout=True)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        zero_counts()
        losses = [t.step_fn(t.state, x0, x1, draws=draws())["loss"] for t in (trainer, again)]
        torch.cuda.synchronize()
        launched = read_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    expect("the two next steps", launched, {k: 2 * v for k, v in per_step.items()})
    ok, bad = same_bits(state_tensors(again.state) + [losses[1]],
                        state_tensors(trainer.state) + [losses[0]])
    if not ok:
        names = [n for n, _ in trainer.model.named_parameters()]
        k = len(names)
        where = [f"{('params', 'ema', 'mu', 'nu', 'loss')[i // k]}:{names[i % k] if i < 4 * k else ''}"
                 for i in bad]
        raise AssertionError(f"the next step from the restored state differs from the live "
                             f"state's in {len(bad)} tensors: {where[:10]}")
    log(f"next step from the live and the restored state at {PRESET_RESUMED} (same StepDraws, "
        f"cudnn.deterministic): the same bits in all {len(state_tensors(trainer.state))} "
        f"tensors and the loss {float(losses[0]):.6f}; launches {launched}")

    # Seconds per image evaluation and per tracking FID, on the restored trainer.
    again.evaluate()  # the tracking reference features, made once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = again.evaluate()
    eval_s = time.perf_counter() - t0
    gen = again.generate(cfg.eval.num_eval_samples, return_solution=True).final
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tfid = again.tracking_fid(gen)
    tfid_s = time.perf_counter() - t0
    log(f"image evaluation ({cfg.eval.num_eval_samples} images, {cfg.eval.ode_method}, NFE "
        f"{ev['nfe']:.0f}, tracking FID {ev['tracking_fid']:.4f}): {eval_s:.3f} s; a tracking FID "
        f"of {gen.shape[0]} samples against the cached reference: {tfid_s:.3f} s "
        f"(FID {tfid:.4f}) ({smi})")
    del trainer, gen

    # trainer.debug_nans: anomaly mode for one fit step; the kernels'
    # autograd Functions (#2, #9) still launch under it, and it is restored.
    last = again.state.step + 1  # its step above counted
    cfg.trainer.debug_nans = True
    zero_counts()
    t0 = time.perf_counter()
    again.fit(last)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = read_counts()
    cfg.trainer.debug_nans = False
    if torch.is_anomaly_enabled() or again.ckpt.latest_step() != last:
        raise AssertionError(f"anomaly mode on after fit, or no checkpoint at {last}")
    expect("a step under anomaly mode", launched, per_step)
    log(f"one step with trainer.debug_nans (autograd anomaly mode) and its save: {sec:.3f} s; "
        f"launches {launched}")
    del again

    # 4. cli eval restores the latest checkpoint (62) and evaluates.
    zero_counts()
    t0 = time.perf_counter()
    rc, text = captured(cli.main, ["eval", "cifar10_otcfm", f"trainer.total_steps={PRESET_RESUMED}",
                                   *over, "--log_dir", logs])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = read_counts()
    ev = printed_dict(text, "eval:")
    if rc != 0 or f"resumed from step {last}" not in text or not all(
            math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"cli eval: rc {rc}, {ev}")
    expect("cli eval", launched, eval_launches(int(ev["nfe"])))
    log(f"cli eval cifar10_otcfm at step {last}: {ev} in {sec:.3f} s with the "
        f"Trainer's construction; launches {launched}")

    # 5. compute_fid through the tracking features: PRESET_FID_GEN images by euler-100.
    base = ["--synthetic", "--output_dir", out_dir, "--data_dir", data_dir]
    weights = os.environ.pop("CFM_TPU_INCEPTION_WEIGHTS", None)
    try:
        zero_counts()
        t0 = time.perf_counter()
        fid, text = captured(compute_fid.main, ["--num_gen", str(PRESET_FID_GEN),
                                                "--integration_method", "euler"] + base)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = read_counts()
        batches = -(-PRESET_FID_GEN // 1024)
        if not math.isfinite(fid) or "FID[tracking" not in text:
            raise AssertionError(f"compute_fid (tracking): {fid}")
        expect("compute_fid euler", launched, eval_launches(100 * batches))
        fid_line = [ln for ln in text.splitlines() if ln.startswith("FID[")][-1]
        log(f"compute_fid --synthetic --num_gen {PRESET_FID_GEN} euler-100: {fid_line} in "
            f"{sec:.3f} s; launches {launched} ({smi})")

        # 6. compute_fid through the Inception trunk with random weights.
        npz = os.path.join(root, "inception_random.npz")
        random_inception_npz(npz)
        os.environ["CFM_TPU_INCEPTION_WEIGHTS"] = npz
        zero_counts()
        t0 = time.perf_counter()
        fid, text = captured(compute_fid.main, ["--num_gen", str(PRESET_INCEPTION_N), "--num_ref",
                                                str(PRESET_INCEPTION_N)] + base)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = read_counts()
        nfe = int(re.findall(r"generated \d+/\d+ \(nfe/batch (\d+)\)", text)[-1])
        if not math.isfinite(fid) or "FID[inception[legacy_tensorflow]]" not in text:
            raise AssertionError(f"compute_fid (inception): {fid}")
        expect("compute_fid dopri5", launched, eval_launches(nfe))
        fid_line = [ln for ln in text.splitlines() if ln.startswith("FID[")][-1]
        log(f"compute_fid --synthetic --num_gen {PRESET_INCEPTION_N} --num_ref "
            f"{PRESET_INCEPTION_N} dopri5 (random Inception weights): {fid_line} in {sec:.3f} s; "
            f"launches {launched} ({smi})")
    finally:
        os.environ.pop("CFM_TPU_INCEPTION_WEIGHTS", None)
        if weights is not None:
            os.environ["CFM_TPU_INCEPTION_WEIGHTS"] = weights

    # The trunk on the card against the CPU, and its rate.
    images = load_cifar10(data_dir, synthetic=True)[0][:PRESET_INCEPTION_N]
    card = inception_feature_fn(npz, device="cuda")
    cpu = inception_feature_fn(npz, device="cpu")
    with torch.inference_mode(), strict_f32():
        f_card = card(torch.from_numpy(images[:2]).cuda()).cpu()
        f_cpu = cpu(torch.from_numpy(images[:2]))
    err = float((f_card - f_cpu).abs().max() / f_cpu.abs().max())
    if not err <= INCEPTION_TOL:
        raise AssertionError(f"Inception card vs CPU: relative error {err}")
    batched_features(card, images[:256], 256, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = batched_features(card, images, 256, device="cuda")
    sec = time.perf_counter() - t0
    if feats.shape != (PRESET_INCEPTION_N, 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"Inception features {feats.shape}")
    log(f"Inception trunk (legacy_tensorflow, random weights): card vs CPU under strict_f32 on 2 "
        f"images, max error {err:.2e} of the features' max (limit {INCEPTION_TOL}); "
        f"{PRESET_INCEPTION_N} images in {sec:.3f} s = {PRESET_INCEPTION_N / sec:.1f} images/s "
        f"at batch 256, TF32 as compute_fid runs ({smi})")
    return total


# Phases 19-22: SDE generation, activation checkpointing, tsit5 and the adjoint.
MNIST_SDE_STEPS, MNIST_SDE_TIMED, MNIST_SDE_GEN = 30, 20, 64
MNIST_SDE_TOL = 2e-2      # kernels vs plain versions, SDE rollout: of the final's max-abs
SF2M_SDE_STEPS = 300      # 2d_sf2m steps before its evaluation with eval.sde
CKPT_WARMUP, CKPT_STEPS, CKPT_PROFILED = 2, 8, 2
CKPT_POLICIES = ((False, None), (True, None), (True, "dots"))
TSIT5_GEN = 256  # 512 until phases 32-33 joined the script's time limit
ADJOINT_N, ADJOINT_TOL, ADJOINT_GRAD_TOL = 8, 1e-4, 5e-2
MNIST = dict(dim=(28, 28, 1), num_channels=32, num_res_blocks=1, channel_mult=(1, 2, 2),
             num_heads=1, num_head_channels=-1, attention_resolutions="14")


@contextlib.contextmanager
def plain_versions():
    """The UNet's kernel wrappers swapped for their plain PyTorch versions,
    which run on the card as on the CPU and differentiate by autograd: the
    yardstick of phases 19 and 22. Nothing launches inside."""
    from cfm_tpu_torch.models import unet
    from cfm_tpu_torch.ops import attention as att
    from cfm_tpu_torch.ops import attn_block as ab
    from cfm_tpu_torch.ops import groupnorm as gn

    names = ("fused_group_norm_silu", "fused_attention_block", "attention_t")
    saved = {n: getattr(unet, n) for n in names}
    unet.fused_group_norm_silu = gn.gn_silu_reference
    unet.fused_attention_block = ab.attention_block_reference
    unet.attention_t = att.attn_reference_t
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(unet, n, f)


def per_step_launches(per_step, steps):
    return {k: per_step.get(k, 0) * steps for k in kernel_fns()}


def mnist_sde(smi):
    """Phase 19: [SF]2M on MNIST through ``train_mnist.main(["--matcher",
    "sbcfm", "--sde", "--synthetic", ...])`` at the preset's width and batch
    (two UNets, bf16, batch 128): MNIST_SDE_STEPS steps and 64 images by
    the SDE (euler, 100 steps), the counts set to 0 just before and read
    just after; then MNIST_SDE_TIMED more steps timed, one evaluation with
    ``eval.sde`` at the preset's 2048 samples, 64 images by ``generate_sde``
    timed, and the same rollout on the same noise with random seeded
    weights in both heads through the kernels and through the plain
    versions. Returns the trainer and the launch counts of its windows."""
    import numpy as np
    import torch
    from cfm_tpu_torch import train_mnist

    d = run_dir("mnist_sde")
    gn_eval = GN_PER_EVAL["mnist"]
    train_step = dict(auction=1, gn_silu_fwd=2 * gn_eval, gn_silu_bwd=2 * gn_eval)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer, text = captured(train_mnist.main, [
        "--matcher", "sbcfm", "--sde", "--synthetic", "--steps", str(MNIST_SDE_STEPS),
        "--data_dir", "build/no_mnist", "--output_dir", d,
        "--override", "trainer.log_interval=1000", "--override", "trainer.ckpt_interval=0"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"mnist sde cli": read_counts()}
    cfg = trainer.cfg
    samples = np.load(os.path.join(d, "mnist_samples.npy"))
    want = per_step_launches(train_step, MNIST_SDE_STEPS)
    want["gn_silu_fwd"] += 2 * gn_eval * 100
    log(f"train_mnist --matcher sbcfm --sde: {MNIST_SDE_STEPS} steps (batch "
        f"{cfg.data.batch_size}, bf16 {cfg.model.bf16}, two UNets) and {samples.shape[0]} SDE "
        f"samples in {sec:.3f} s; launches {launches['mnist sde cli']}")
    if (launches["mnist sde cli"] != want or samples.shape != (MNIST_SDE_GEN, 28, 28, 1)
            or cfg.data.batch_size != TRAIN_BATCH or not cfg.model.bf16
            or (cfg.matcher.kind, cfg.matcher.sigma, cfg.eval.sde) != ("sbcfm", 1.0, True)
            or "saved 64 samples (NFE 100)" not in text):
        raise AssertionError(f"train_mnist --sde: launches {launches['mnist sde cli']}, expected "
                             f"{want}; samples {samples.shape}")
    trainer.ckpt.save = lambda *args, **kwargs: False
    step_fn, recorded = trainer.step_fn, []

    def recording_step(*args, **kwargs):
        metrics = step_fn(*args, **kwargs)
        recorded.append(metrics["loss"])
        return metrics

    trainer.step_fn = recording_step
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer.fit(MNIST_SDE_STEPS + MNIST_SDE_TIMED)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches["mnist sde training"] = read_counts()
    trainer.step_fn = step_fn
    losses = [float(v) for v in recorded]
    log(f"training mnist_sbcfm + score head bf16 batch {TRAIN_BATCH}: {MNIST_SDE_TIMED} steps in "
        f"{sec:.3f} s = {1e3 * sec / MNIST_SDE_TIMED:.2f} ms per step; loss first "
        f"{losses[0]:.5f} last {losses[-1]:.5f}; launches {launches['mnist sde training']} "
        f"({smi})")
    if (launches["mnist sde training"] != per_step_launches(train_step, MNIST_SDE_TIMED)
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"mnist sde training: launches {launches['mnist sde training']}, "
                             f"losses {losses}")
    zero_counts()
    t0 = time.perf_counter()
    ev = trainer.evaluate()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches["mnist sde evaluation"] = read_counts()
    n_eval = cfg.eval.num_eval_samples
    log(f"  evaluation with eval.sde at {n_eval} samples in {sec:.3f} s: "
        f"{ {k: round(v, 5) for k, v in ev.items()} }; launches "
        f"{launches['mnist sde evaluation']}")
    want = per_step_launches(dict(gn_silu_fwd=gn_eval * (100 + 2 * 100)), 1)
    if (set(ev) != {"gen_mean", "gen_std", "nfe", "tracking_fid", "sde_kl"}
            or not math.isfinite(ev["sde_kl"]) or launches["mnist sde evaluation"] != want):
        raise AssertionError(f"mnist sde evaluation {ev}, launches "
                             f"{launches['mnist sde evaluation']}, expected {want}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    trainer.generate_sde(MNIST_SDE_GEN, generator=gen)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    sol = trainer.generate_sde(MNIST_SDE_GEN, generator=gen)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches["mnist sde generation"] = read_counts()
    log(f"generation by SDE (mnist_sbcfm, both EMA heads, euler-100): {MNIST_SDE_GEN} images in "
        f"{sec:.3f} s = {MNIST_SDE_GEN / sec:.2f} imgs/s, NFE {sol.nfe}, launches "
        f"{launches['mnist sde generation']} ({smi})")
    want = per_step_launches(dict(gn_silu_fwd=2 * gn_eval * 100), 1)
    if (launches["mnist sde generation"] != want or sol.nfe != 100
            or not bool(torch.isfinite(sol.final).all())):
        raise AssertionError(f"mnist sde generation: launches {launches['mnist sde generation']}, "
                             f"expected {want}, NFE {sol.nfe}")
    # Kernels against plain versions: both heads given random seeded weights.
    heads = [seeded_model(MNIST, torch.bfloat16, "cpu", seed=s) for s in (41, 43)]
    with torch.no_grad():
        for e, p in zip(trainer.state.ema_params,
                        [p for h in heads for p in h.parameters()]):
            e.copy_(p)
    g = torch.Generator().manual_seed(45)
    x0 = torch.randn((MNIST_SDE_GEN, 28, 28, 1), generator=g).cuda()
    noise = [torch.randn((MNIST_SDE_GEN, 28, 28, 1), generator=g).cuda() for _ in range(100)]
    zero_counts()
    kern = trainer.generate_sde(MNIST_SDE_GEN, x0=x0, noise=noise, logqp=True)
    got = read_counts()
    with plain_versions():
        plain = trainer.generate_sde(MNIST_SDE_GEN, x0=x0, noise=noise, logqp=True)
    if read_counts() != got or got["gn_silu_fwd"] != 2 * gn_eval * 100:
        raise AssertionError(f"SDE check launches {got}, then {read_counts()}")
    scale = plain.final.abs().max().item()
    err = (kern.final - plain.final).abs().max().item() / scale
    kl_err = ((kern.logqp - plain.logqp).abs().max() / plain.logqp.abs().max()).item()
    log(f"  SDE rollout (random seeded heads, 64 images, 100 steps, the same noise): kernels vs "
        f"plain versions on the card, final within {err:.2e} of its max-abs {scale:.3f} "
        f"(limit {MNIST_SDE_TOL}), KL within {kl_err:.2e} relative")
    if not err <= MNIST_SDE_TOL or not kl_err <= MNIST_SDE_TOL:
        raise AssertionError(f"SDE rollout kernels vs plain: {err}, KL {kl_err}")
    return trainer, launches


def sf2m_sde(smi):
    """Phase 20: ``2d_sf2m`` as the preset gives it with ``eval.sde=True``:
    SF2M_SDE_STEPS steps, then one evaluation (W1, W2, sde_kl, sde_w2 at
    2048 points), the counts set to 0 just before: three #6 launches and
    nothing else. Then the heun method's rollout (200 NFE) and its W2 (one
    #6 launch). Returns the counts of both windows."""
    import torch
    from cfm_tpu_torch.coupling import wasserstein

    trainer = phase_trainer("2d_sf2m", ["eval.sde=True", "trainer.eval_interval=0",
                                        "trainer.log_interval=100000"], "2d_sf2m_sde",
                            skip_saves=True)
    trainer.fit(SF2M_SDE_STEPS)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    ev = trainer.evaluate()
    sec = time.perf_counter() - t0
    launched = read_counts()
    log(f"2d_sf2m evaluation with eval.sde after {SF2M_SDE_STEPS} steps: "
        f"{ {k: round(v, 6) for k, v in ev.items()} } in {sec:.3f} s; launches {launched} ({smi})")
    want = dict.fromkeys(launched, 0)
    want["auction_tiled"] = 3
    if (launched != want or set(ev) != {"w1", "w2", "nfe", "sde_kl", "sde_w2"}
            or not all(math.isfinite(v) for v in ev.values())):
        raise AssertionError(f"2d_sf2m eval.sde: {ev}, launches {launched}, expected {want}")
    g = torch.Generator(device="cuda").manual_seed(7)
    zero_counts()
    t0 = time.perf_counter()
    heun = trainer.generate_sde(trainer.cfg.eval.num_eval_samples, logqp=True, method="heun",
                                generator=g)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    target = trainer._target(g, trainer.cfg.eval.num_eval_samples, "cuda")
    w2 = float(wasserstein(heun.final, target, power=2))
    heun_launched = read_counts()
    log(f"  heun rollout: NFE {heun.nfe}, {sec:.3f} s, KL mean {float(heun.logqp.mean()):.6f}, "
        f"W2 against fresh target points {w2:.6f}; launches {heun_launched}")
    want["auction_tiled"] = 1
    if heun.nfe != 200 or not math.isfinite(w2) or heun_launched != want:
        raise AssertionError(f"2d_sf2m heun: NFE {heun.nfe}, W2 {w2}, launches {heun_launched}")
    return {k: v + heun_launched[k] for k, v in launched.items()}


def checkpoint_runs(name, run_steps, reset, model, per_step, smi):
    """Phase 21 for one path: for each (use_checkpoint, policy) of
    CKPT_POLICIES, ``reset()`` the state, CKPT_WARMUP steps, then
    CKPT_STEPS with the counts and the peak memory set just before and read
    just after, then CKPT_PROFILED steps under the device profiler. A
    wrapped block's forward kernels run twice a step (the forward and the
    recompute). Returns the counts summed over the policies."""
    import torch

    total = dict.fromkeys(kernel_fns(), 0)
    for use, policy in CKPT_POLICIES:
        model.use_checkpoint, model.checkpoint_policy = use, policy
        what = f"use_checkpoint={use}" + (f" policy={policy}" if use else "")
        reset()
        run_steps(CKPT_WARMUP)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        losses = run_steps(CKPT_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall = device_profile(lambda: run_steps(CKPT_PROFILED),
                              f"a {name} train step, {what}", top=0, per=CKPT_PROFILED)
        busy = device_profile.last["busy_ms"] if device_profile.last else float("nan")
        want = per_step_launches(per_step(use), CKPT_STEPS)
        log(f"checkpointing {name} {what}: {1e3 * sec / CKPT_STEPS:.2f} ms a step, device "
            f"{busy:.3f} ms a step (wall {wall:.2f} traced), max memory allocated {peak:.3f} GiB; "
            f"loss last {float(losses[-1]):.5f}; launches {launched} ({smi})")
        if launched != want or not all(math.isfinite(float(v)) for v in losses):
            raise AssertionError(f"checkpointing {name} {what}: launches {launched}, "
                                 f"expected {want}")
        total = {k: v + launched[k] for k, v in total.items()}
    model.use_checkpoint, model.checkpoint_policy = False, None
    return total


def same_step_bits(name, reset, one_step, model):
    """Phase 21: from the same state, one step with the same draws (dropout
    masks from a fresh seeded generator) under ``cudnn.deterministic``, for
    each policy: the parameters and the generator's state after the step
    must equal the unwrapped step's bit for bit."""
    import torch

    ref = None
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for use, policy in CKPT_POLICIES:
            model.use_checkpoint, model.checkpoint_policy = use, policy
            reset()
            params, gen_state = one_step()
            if ref is None:
                ref = (params, gen_state)
                continue
            ok, bad = same_bits(params, ref[0])
            if not ok or not torch.equal(gen_state, ref[1]):
                raise AssertionError(f"{name} policy {policy}: {len(bad)} tensors differ from the "
                                     f"unwrapped step (first {bad[:5]})")
            log(f"  {name} policy {policy}: one step's {len(params)} parameters and the "
                f"generator's state equal the unwrapped step's bit for bit")
    finally:
        torch.backends.cudnn.deterministic = prev
        model.use_checkpoint, model.checkpoint_policy = False, None


def checkpointing(imagenet, smi):
    """Phase 21: activation checkpointing on ``cifar10_otcfm`` (dropout 0.1,
    bf16, batch 128, synthetic data, through ``Trainer``) and on the
    ImageNet-64 model (dropout 0.1, bf16, batch 32, ``make_train_step``),
    each off, with policy None and with "dots". Returns the counts."""
    import numpy as np
    import torch
    from cfm_tpu_torch.data.images import normalize_images
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
    from cfm_tpu_torch.train import StepDraws, init_train_state, make_optimizer, make_train_step

    out = {}
    # CIFAR-10: the Trainer's model; its state reset to the initial tensors.
    trainer = phase_trainer("cifar10_otcfm", ["trainer.log_interval=100000",
                                              "data.synthetic_fallback=True",
                                              "data.data_dir=build/no_cifar10"],
                            "cifar10_checkpointing", skip_saves=True)
    init = [t.detach().cpu().clone() for t in state_tensors(trainer.state)]

    def reset_cifar():
        with torch.no_grad():
            for t, v in zip(state_tensors(trainer.state), init):
                t.copy_(v)
        trainer.state.opt_state.count, trainer.state.step = 0, 0

    def cifar_steps(n):
        return [trainer._step(trainer.state.step)["loss"] for _ in range(n)]

    gn_c = GN_PER_EVAL["cifar10"]
    out["cifar10 checkpointing"] = checkpoint_runs(
        "cifar10_otcfm", cifar_steps, reset_cifar, trainer.model,
        lambda use: dict(auction=1, attn_block_fwd=10 if use else 5, attn_block_bwd=5,
                         gn_silu_fwd=2 * gn_c - 1 if use else gn_c, gn_silu_bwd=gn_c), smi)
    x1 = normalize_images(trainer._device_data[:TRAIN_BATCH])
    x0 = torch.randn(x1.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda")

    def cifar_one_step():
        g = torch.Generator(device="cuda").manual_seed(5)
        draws = StepDraws.draw(g, x0, coupled=True, dropout=True)
        trainer.step_fn(trainer.state, x0, x1, draws=draws)
        torch.cuda.synchronize()
        return [p.detach().clone() for p in trainer.state.params], g.get_state()

    same_step_bits("cifar10_otcfm", reset_cifar, cifar_one_step, trainer.model)
    del trainer, init

    # ImageNet-64: the phase 11-12 model; its parameters reset to a copy.
    B = IMAGENET_BATCH
    init = [p.detach().cpu().clone() for p in imagenet.parameters()]
    rng = np.random.default_rng(21)
    n_batches = 8
    images = torch.from_numpy(rng.integers(0, 256, (n_batches * B,) + IMAGENET64["dim"],
                                           dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, IMAGENET64["num_classes"], n_batches * B)).cuda()
    opt = make_optimizer(lr=1e-4, grad_clip=1.0)
    holder = {}

    def reset_imagenet():
        holder.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with torch.no_grad():
            for p, v in zip(imagenet.parameters(), init):
                p.copy_(v)
        holder["state"] = init_train_state(imagenet, opt)
        holder["step"] = make_train_step(ExactOptimalTransportConditionalFlowMatcher(), imagenet,
                                         opt, ema_decay=0.9999, train_mode=True,
                                         class_conditional=True)
        holder["g"] = torch.Generator(device="cuda").manual_seed(12)

    def imagenet_steps(n):
        losses, state = [], holder["state"]
        for _ in range(n):
            i = state.step % n_batches * B
            x1, y = normalize_images(images[i:i + B]), labels[i:i + B]
            x0 = torch.randn(x1.shape, generator=holder["g"], device="cuda")
            losses.append(holder["step"](state, x0, x1, y, y, generator=holder["g"])["loss"])
        return losses

    gn_i = GN_PER_EVAL["imagenet64"]
    out["imagenet64 checkpointing"] = checkpoint_runs(
        "imagenet64", imagenet_steps, reset_imagenet, imagenet,
        lambda use: dict(auction=1, attention_fwd=28 if use else 14, attention_bwd=14,
                         attn_block_fwd=16 if use else 8, attn_block_bwd=8,
                         gn_silu_fwd=2 * gn_i - 1 if use else gn_i, gn_silu_bwd=gn_i), smi)
    x1 = normalize_images(images[:B])
    y = labels[:B]
    x0 = torch.randn(x1.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda")

    def imagenet_one_step():
        g = torch.Generator(device="cuda").manual_seed(5)
        draws = StepDraws.draw(g, x0, coupled=True, dropout=True)
        holder["step"](holder["state"], x0, x1, y, y, draws=draws)
        torch.cuda.synchronize()
        return [p.detach().clone() for p in holder["state"].params], g.get_state()

    same_step_bits("imagenet64", reset_imagenet, imagenet_one_step, imagenet)
    holder.clear()
    with torch.no_grad():
        for p, v in zip(imagenet.parameters(), init):
            p.copy_(v)
    return out


def tsit5_generation(dopri5, smi):
    """Phase 22: the recipe width (random seeded weights, bf16) generating
    TSIT5_GEN images by tsit5 at rtol = atol = 1e-5, over ``generate``'s
    two-point span and over ``Trainer.generate``'s 101-point grid, beside
    phase 6's dopri5 (``dopri5``: (NFE, images/s)). Returns the counts."""
    import numpy as np
    import torch
    from cfm_tpu_torch.generate import generate

    model = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0)
    total = dict.fromkeys(kernel_fns(), 0)
    for what, grid in (("two-point span", None),
                       ("101-point grid", np.linspace(0.0, 1.0, 101, dtype=np.float32))):
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = generate(model, TSIT5_GEN, generator=gen, method="tsit5", grid=grid)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = read_counts()
        log(f"generation tsit5 ({what}): {TSIT5_GEN} images in {sec:.3f} s = "
            f"{TSIT5_GEN / sec:.2f} imgs/s, NFE {out.nfe}; dopri5 (phase 6) NFE {dopri5[0]}, "
            f"{dopri5[1]:.2f} imgs/s; launches {launched} ({smi})")
        want = dict.fromkeys(total, 0)
        want.update(eval_launches(out.nfe))
        if launched != want or out.images.float().std().item() < 1.0 or (
                grid is not None and out.nfe < 2 + 6 * 100):
            raise AssertionError(f"tsit5 {what}: launches {launched} for NFE {out.nfe}")
        total = {k: v + launched[k] for k, v in total.items()}
    return total


def adjoint_gradients(trainer, smi):
    """Phase 22: ``odeint_adjoint`` through the MNIST flow head (phase 19's
    trainer, its zero-initialised layers given seeded values) on
    ADJOINT_N images at rtol = atol = ADJOINT_TOL, the gradients of
    sum(x(1)^2) for every parameter and x0; then the same through the plain
    versions, within ADJOINT_GRAD_TOL of each gradient's max-abs, or of 1e-3
    of the largest gradient's where that is more: a bias added before a
    GroupNorm of one channel a group (the MNIST UNet's 32 channels in 32
    groups) is removed by it, so its true gradient is 0 and its values are
    rounding noise, as phase 5's train-step check allows. The backward's
    vector-Jacobian products run #9 inside ``torch.autograd.grad``.
    Returns the counts of the kernel run."""
    import torch
    from cfm_tpu_torch.integrate import odeint_adjoint

    model = randomize_zero_layers(trainer.model, 47).train(False)
    params = tuple(model.parameters())
    x0 = torch.randn((ADJOINT_N, 28, 28, 1), generator=torch.Generator().manual_seed(48)).cuda()
    calls = {"fwd": 0, "vjp": 0}

    def f(p, t, x):
        calls["vjp" if torch.is_grad_enabled() else "fwd"] += 1
        return model(torch.full((x.shape[0],), t, device=x.device), x)

    def grads():
        for p in params:
            p.grad = None
        x = x0.clone().requires_grad_(True)
        final = odeint_adjoint(f, params, x, [0.0, 1.0], rtol=ADJOINT_TOL, atol=ADJOINT_TOL)
        (final ** 2).sum().backward()
        torch.cuda.synchronize()
        return [x.grad] + [p.grad.clone() for p in params]

    grads()  # warm-up
    calls.update(fwd=0, vjp=0)
    zero_counts()
    t0 = time.perf_counter()
    kern = grads()
    sec = time.perf_counter() - t0
    launched, n = read_counts(), dict(calls)
    gn_eval = GN_PER_EVAL["mnist"]
    want = dict.fromkeys(launched, 0)
    want.update(gn_silu_fwd=gn_eval * (n["fwd"] + n["vjp"]), gn_silu_bwd=gn_eval * n["vjp"])
    log(f"odeint_adjoint over the MNIST flow head (bf16, {ADJOINT_N} images, rtol = atol = "
        f"{ADJOINT_TOL}): {n['fwd']} forward and {n['vjp']} adjoint evaluations in {sec:.3f} s; "
        f"launches {launched} ({smi})")
    if launched != want or not all(bool(torch.isfinite(g).all()) for g in kern):
        raise AssertionError(f"adjoint launches {launched}, expected {want}")
    with plain_versions():
        calls.update(fwd=0, vjp=0)
        plain = grads()
    if read_counts() != launched:
        raise AssertionError("the plain adjoint launched a kernel")
    gmax = max(b.abs().max().item() for b in plain)
    worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-3 * gmax)
                for a, b in zip(kern, plain))
    log(f"  gradients (x0 and {len(params)} parameters) against the plain versions' adjoint "
        f"({calls['fwd']} and {calls['vjp']} evaluations): worst {worst:.2e} of a gradient's "
        f"max-abs or 1e-3 of the largest's {gmax:.4g} (limit {ADJOINT_GRAD_TOL})")
    if not worst <= ADJOINT_GRAD_TOL:
        raise AssertionError(f"adjoint gradients kernels vs plain: {worst}")
    return launched


# The single-cell trajectory path (phases 23-26).
SC_STEPS, SC_NPZ_STEPS, SC_SPLINE_STEPS, SC_PROFILED = 2000, 300, 300, 3
SC_NPZ_SIZES = (640, 560, 512, 600, 700)  # cells a timepoint of the npz run, 5-D
SC_CHECKED = 3            # phase 23's first steps whose #5 solves are held to the plain version
SC_W2_GATE = 0.5          # phase 23's mean W2 over timepoints 1-4 (CPU run of the command: 0.20)
SC_TOL = 1e-5             # card vs CPU, of each tensor's max-abs (phases 25, 26)
GRN_GENES, GRN_HIDDEN, GRN_CELLS, GRN_MEMBERS = 100, 10, 1000, 5


@contextlib.contextmanager
def recorded_solves(name, keep):
    """Calls of ``ops.assignment``'s solver ``name`` (a kernel wrapper, or the
    plain "auction_assignment") wrapped where the assignment dispatch finds
    them, so that the first ``keep`` calls' (cost, permutation, rounds) are
    recorded; yields the list."""
    import torch
    from cfm_tpu_torch.ops import assignment

    fn, out = getattr(assignment, name), []

    def wrapper(cost):
        perm = fn(cost)
        if len(out) < keep:
            # The plain auction sets its rounds on its name in ``assignment``,
            # which is this wrapper now; the kernels set theirs on themselves.
            rounds = (wrapper if name == "auction_assignment" else fn).last_rounds
            out.append((cost.clone(), perm.clone(),
                        rounds.clone() if torch.is_tensor(rounds) else rounds))
        return perm

    setattr(assignment, name, wrapper)
    try:
        yield out
    finally:
        setattr(assignment, name, fn)


def single_cell_run(argv, what, smi, solver=None, keep=0):
    """``single_cell.run(argv)`` with the counts set to 0 just before and
    read just after; with ``solver`` the first ``keep`` solves of that
    assignment solver are recorded (``recorded_solves``), and so are the
    plain scatter auction's. Returns (run, launches, records, plain
    records)."""
    import torch
    from cfm_tpu_torch import single_cell

    ctx = recorded_solves(solver, keep) if solver else contextlib.nullcontext([])
    with ctx as records, recorded_solves("auction_assignment", 1000) as plain:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        sc = single_cell.run(argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launched = read_counts()
    steps = sc.args.steps
    log(f"single_cell {' '.join(argv)}: {sec:.2f} s in all; {steps} steps in "
        f"{sc.train_seconds:.3f} s = {1e3 * sc.train_seconds / steps:.3f} ms a step (ten loss "
        f"reads included); joint plans and their CDFs {sc.plan_seconds:.3f} s; the evaluation "
        f"{sc.eval_seconds:.3f} s, {len(plain)} plain-auction solves of "
        f"{[int(r[2]) for r in plain]} rounds; launches {launched} ({smi})")
    metrics = dict(zip(sc.names[-8:], sc.values[-8:]))
    log(f"  {what}: {', '.join(f'{k} {v:.6f}' for k, v in metrics.items())}")
    if not all(math.isfinite(v) for v in sc.values) or len(metrics) != 8:
        raise AssertionError(f"single_cell {argv}: metrics {sc.names} {sc.values}")
    return sc, launched, records, plain


def single_cell_synthetic(smi):
    """Phase 23: ``single_cell --synthetic`` as given (n = 4096 a timepoint,
    T = 5, dim 2, batch 256, SC_STEPS steps, MLP width 64, f32): one #5
    launch a step and nothing else (the evaluation's 8 exact solves at
    n = 1000, not a multiple of 256, take the plain scatter auction, as
    JAX's rule routes them); the first SC_CHECKED steps' #5 permutations and
    round counts equal to its plain version's on the same costs; the mean W2
    under SC_W2_GATE; ms a step,
    the evaluation's seconds and its solves' rounds; then SC_PROFILED steps
    profiled. Then the ``--npz`` route on a 5-D tree population with
    SC_NPZ_SIZES cells a timepoint, which the phase writes (SC_NPZ_STEPS
    steps; n_eval = 512, so the evaluation's solves are #5 launches).
    Returns the launch counts of both runs."""
    import numpy as np
    import torch
    from cfm_tpu_torch.data.trajectory import tree_population
    from cfm_tpu_torch.ops import auction as au

    sc, launched, records, plain = single_cell_run(
        ["--synthetic"], "the 8 metrics (means over timepoints 1-4)", smi,
        solver="pallas_auction_assignment", keep=SC_CHECKED)
    w2 = sc.values[sc.names.index("2-Wasserstein")]
    if not w2 < SC_W2_GATE:
        raise AssertionError(f"single_cell --synthetic: mean W2 {w2} (gate {SC_W2_GATE})")
    want = dict.fromkeys(launched, 0)
    want["auction"] = SC_STEPS
    if launched != want or len(plain) != 8:
        raise AssertionError(f"single_cell --synthetic: launches {launched}, expected {want}; "
                             f"{len(plain)} plain solves, expected 8")
    for i, (cost, perm, rounds) in enumerate(records):
        ref, ref_rounds = au.auction_assignment_onehot(cost)
        if not torch.equal(perm, ref) or int(rounds) != ref_rounds:
            raise AssertionError(f"single_cell step {i}: #5's perm or rounds ({int(rounds)} vs "
                                 f"{ref_rounds}) differ from the plain version's")
    log(f"  the first {len(records)} steps' #5 solves (n = {records[0][0].shape[0]}): perms and "
        f"rounds ({[int(r[2]) for r in records]}) equal to the plain version's")
    device_profile(lambda: [sc.step(sc.batch()) for _ in range(SC_PROFILED)],
                   f"a single_cell step (batch 256; mean of {SC_PROFILED})", per=SC_PROFILED)
    log_kernel_share("#5", "auction kernels (#5, #6)")

    d = run_dir("single_cell_npz")
    g = torch.Generator().manual_seed(23)
    X = tree_population(g, max(SC_NPZ_SIZES), T=len(SC_NPZ_SIZES), dim=5).numpy()
    pcs = np.concatenate([X[torch.randperm(len(X), generator=g)[:n].numpy(), t]
                          for t, n in enumerate(SC_NPZ_SIZES)]) * 3.0 + 1.0
    labels = np.concatenate([np.full(n, 2.0 * t) for t, n in enumerate(SC_NPZ_SIZES)])
    np.savez(f"{d}/trajectory.npz", pcs=pcs, sample_labels=labels)
    npz, npz_launched, _, npz_plain = single_cell_run(
        ["--npz", f"{d}/trajectory.npz", "--steps", str(SC_NPZ_STEPS)],
        "the npz route's 8 metrics", smi)
    want = dict.fromkeys(launched, 0)
    want["auction"] = SC_NPZ_STEPS + 8
    if npz_launched != want or npz.dim != 5 or npz_plain:
        raise AssertionError(f"single_cell --npz: launches {npz_launched}, expected {want}; "
                             f"dim {npz.dim}, {len(npz_plain)} plain solves")
    return {"single_cell synthetic": launched, "single_cell npz": npz_launched}


def scipy_optimum(cost):
    """The optimal assignment cost of ``cost`` (a numpy array, solved in
    float64) by scipy's solver; a module-level function, so that a worker
    process can run it."""
    from scipy.optimize import linear_sum_assignment

    cost = cost.astype("float64")
    rows, cols = linear_sum_assignment(cost)
    return float(cost[rows, cols].sum())


# Phase 24's joint plans held to scipy's optimum (the first adjacent one;
# all 7 until phases 32-33 joined the script's time limit: 7 solves in 7
# workers beside phase 3's plain solves took 217-271 s of the card's host,
# 3 in 3 workers 160 s).
SC_SCIPY_PLANS = (0,)


def scipy_pool():
    """Worker processes for scipy's solves, one a plan, at most one a core but one."""
    import concurrent.futures
    import multiprocessing

    workers = max(1, min(len(SC_SCIPY_PLANS), len(os.sched_getaffinity(0)) - 1))
    return concurrent.futures.ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))


def single_cell_joint_plans(smi, pool):
    """Phase 24: ``single_cell --synthetic --joint-plans --leaveout 2``
    through the entry point's ``SingleCell``: the exact plans of the whole
    marginals solved up front, 4 adjacent and 3 straddling, each one #6
    launch at n = 4096; the steps, with no solve; then the held-out
    timepoint's W2 alone, as the example computes it (one plain
    scatter-auction solve at n = 1000; phase 23 times the whole evaluation).
    Prints the seconds to solve the plans and build the CDFs, ms a step and
    the held-out W2. Each permutation must be valid, and SC_SCIPY_PLANS'
    costs within 1e-5 relative of scipy's optimum (the plain version takes
    minutes at 4096). scipy takes about a minute a solve on these costs on
    the card's host, so once the run's window is read those costs go to
    ``pool``'s worker processes, and main runs this phase before phase 3,
    whose untimed checks overlap them. Returns the run, its launch counts, the
    held-out W2 and a function that waits for scipy and holds the plans to
    its optima."""
    import torch
    from cfm_tpu_torch import single_cell
    from cfm_tpu_torch.coupling import wasserstein

    argv = ["--synthetic", "--joint-plans", "--leaveout", "2"]
    args = single_cell.build_parser().parse_args(argv)
    leave = args.leaveout
    with recorded_solves("pallas_auction_assignment_tiled", 7) as records, \
            recorded_solves("auction_assignment", 2) as plain:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        sc = single_cell.SingleCell(args)
        t1 = time.perf_counter()
        sc.fit(args.steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        preds = sc.rollout()
        w2 = float(wasserstein(preds[leave - 1], sc.marginals[leave][:preds[0].shape[0]],
                               power=2))
        t3 = time.perf_counter()
        launched = read_counts()
    log(f"single_cell {' '.join(argv)}: plans and their CDFs {sc.plan_seconds:.3f} s; "
        f"{args.steps} steps in {t2 - t1:.3f} s = {1e3 * (t2 - t1) / args.steps:.3f} ms a step "
        f"(ten loss reads included); the roll-out and the held-out W2 {t3 - t2:.3f} s, "
        f"{len(plain)} plain-auction solve of {[int(r[2]) for r in plain]} rounds; held-out "
        f"timepoint {leave} W2 {w2:.6f}; {t3 - t0:.2f} s in all; launches {launched} ({smi})")
    want = dict.fromkeys(launched, 0)
    want["auction_tiled"] = 7
    if launched != want or len(records) != 7 or len(plain) != 1 or not math.isfinite(w2):
        raise AssertionError(f"joint plans: launches {launched}, expected {want}; "
                             f"{len(records)} plans, {len(plain)} plain solves, W2 {w2}")
    t0 = time.perf_counter()
    futures = {i: pool.submit(scipy_optimum, records[i][0].cpu().numpy())
               for i in SC_SCIPY_PLANS}

    def check():
        optima = {i: f.result() for i, f in futures.items()}
        log(f"phase 24's plans: scipy's optima of plans {SC_SCIPY_PLANS} "
            f"{time.perf_counter() - t0:.1f} s after they were submitted (worker processes, "
            f"beside phase 3)")
        for i, (cost, perm, rounds) in enumerate(records):
            n = cost.shape[0]
            p = perm.cpu().numpy()
            if n != 4096 or sorted(p.tolist()) != list(range(n)):
                raise AssertionError(f"joint plan {i}: n = {n}, not a permutation")
            got = cost.double().cpu().numpy()[range(n), p].sum()
            line = f"  joint plan {i}: #6 at n = {n}, {int(rounds)} rounds; cost {got:.6f}"
            if i in optima:
                if abs(got - optima[i]) > 1e-5 * max(abs(optima[i]), 1e-30):
                    raise AssertionError(f"joint plan {i}: cost {got} vs scipy's {optima[i]}")
                line += f", scipy's optimum {optima[i]:.6f}"
            log(line)

    return sc, launched, w2, check


def spline_and_interpolation(joint, w2, smi):
    """Phase 25: ``SplineConditionalFlowMatcher(sigma=0.1, ot_method="exact")``
    trains the MLP (width 64, Adam 1e-3, EMA 0.99, f32) on tree-population
    batches (256, 5, 2) resampled from phase 24's marginals, SC_SPLINE_STEPS
    steps, 4 #5 launches a step (the chaining's plans). First, on a batch of
    distinct cells (tie-free, so every exact plan is one permutation) and
    the same draws, (t, xt, ut) on the card within SC_TOL of the CPU's (TF32
    off). Then ``interpolate_with_ot`` at timepoint 2 from phase 24's plan
    between timepoints 1 and 3, and its ``earth_mover_distance`` to the
    held-out marginal beside the CFM's held-out W2 (``w2``, phase 24's).
    Returns the counts of the training."""
    import torch
    from cfm_tpu_torch.data.trajectory import resample_to_trajectory
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.eval.growth import earth_mover_distance, interpolate_with_ot
    from cfm_tpu_torch.models.mlp import MLP
    from cfm_tpu_torch.spline import SplineConditionalFlowMatcher
    from cfm_tpu_torch.train import init_train_state, make_optimizer
    from cfm_tpu_torch.utils import ema_update

    m = joint.marginals
    matcher = SplineConditionalFlowMatcher(sigma=0.1, ot_method="exact")
    g = torch.Generator().manual_seed(25)
    X = torch.stack([mt[torch.randperm(len(mt), generator=g)[:256].cuda()] for mt in m], 1)
    draws = dict(gumbel=[-torch.empty(256, 256).exponential_(generator=g).log() for _ in range(4)],
                 t=torch.rand(256, generator=g) * 4.0, eps=torch.randn((256, 2), generator=g))
    with strict_f32():
        card = matcher.sample_location_and_conditional_flow(
            None, X, **{k: ([v.cuda() for v in d] if k == "gumbel" else d.cuda())
                        for k, d in draws.items()})
        cpu = matcher.sample_location_and_conditional_flow(None, X.cpu(), **draws)
    worst = max(((a.cpu() - b).abs().max() / b.abs().max()).item() for a, b in zip(card, cpu))
    log(f"spline CFM batch (256, 5, 2) of distinct cells: (t, xt, ut) card vs CPU worst "
        f"{worst:.2e} of max-abs (limit {SC_TOL})")
    if not worst <= SC_TOL:
        raise AssertionError(f"spline CFM card vs CPU: {worst}")

    gen = torch.Generator(device="cuda").manual_seed(25)
    model = MLP(2, w=64, seed=25, device="cuda")
    opt = make_optimizer(lr=1e-3, warmup_steps=0)
    state = init_train_state(model, opt)

    def step():
        t, xt, ut = matcher.sample_location_and_conditional_flow(
            gen, resample_to_trajectory(gen, m, 256))
        loss = torch.mean(torch.square(model(t, xt) - ut))
        for p in state.params:
            p.grad = None
        loss.backward()
        opt.apply(state.params, [p.grad for p in state.params], state.opt_state)
        ema_update(state.ema_params, state.params, 0.99)
        return loss.detach()

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(SC_SPLINE_STEPS)]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = read_counts()
    first, last = (float(torch.stack(part).mean()) for part in (losses[:20], losses[-20:]))
    log(f"spline CFM training: {SC_SPLINE_STEPS} steps in {sec:.3f} s = "
        f"{1e3 * sec / SC_SPLINE_STEPS:.3f} ms a step; loss {first:.4f} -> {last:.4f} (means of "
        f"the first and the last 20); launches {launched} ({smi})")
    want = dict.fromkeys(launched, 0)
    want["auction"] = 4 * SC_SPLINE_STEPS
    if launched != want or not math.isfinite(last) or not last < first:
        raise AssertionError(f"spline CFM: launches {launched}, expected {want}; loss "
                             f"{first} -> {last}")

    n = 1000
    t0 = time.perf_counter()
    interp = interpolate_with_ot(gen, m[1], m[3], joint.straddle_plans[1], 0.5, n)
    emd = float(earth_mover_distance(interp, m[2][:n]))
    sec = time.perf_counter() - t0
    log(f"OT interpolation at timepoint 2 from the 1 -> 3 plan (n = {m[1].shape[0]}): {n} points, "
        f"EMD to the held-out marginal {emd:.6f} (entropic, reg 0.01) in {sec:.3f} s, beside the "
        f"CFM's held-out W2 {w2:.6f} ({smi})")
    if not math.isfinite(emd):
        raise AssertionError(f"OT interpolation EMD {emd}")
    return launched


def grn_models(smi):
    """Phase 26: ``MLPODEF`` structure recovery at the JAX test's setting
    (x' = x A^T, d = 4, k = 8, gl_reg 1e-3, 512 points, Adam 5e-3, 500
    steps): true edges must rank above absent ones. Then at GRN_GENES genes,
    hidden GRN_HIDDEN, GRN_CELLS cells, TF32 off, for a GRN_MEMBERS-member
    ``MLPODEF`` ensemble and a DiBS particle set (``DibsMLPODEF`` under
    ``make_ensemble``): the outputs, the gradients of a data-fit loss and
    one ``svgd_update``, the card within SC_TOL of the CPU on the same
    parameters and cells, each tensor (each leaf of the gradient and of the
    direction) relative to its own max-abs, or to 1e-3 of the largest
    leaf's of the same kind where that is more, as phase 5 does. A leaf
    whose particles all hold one value and whose gradient is exactly 0 (the
    DiBS std leaves, as the forward pass draws no noise) has a direction of
    exactly 0: both devices compute the rounding of the repulsion terms
    that cancel there, so it is held to the largest leaf's max-abs."""
    import torch
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.models import grn
    from cfm_tpu_torch.train import make_optimizer

    A = torch.tensor([[0.0, 1.5, 0.0, 0.0], [0.0, 0.0, -1.5, 0.0], [0.0, 0.0, 0.0, 1.5],
                      [1.5, 0.0, 0.0, 0.0]], device="cuda")
    model = grn.MLPODEF([4, 8, 1], gl_reg=1e-3, seed=1, device="cuda")
    x0 = torch.randn((512, 4), generator=torch.Generator().manual_seed(1)).cuda()
    v_true = x0 @ A.T
    opt = make_optimizer(lr=5e-3, warmup_steps=0, grad_clip=0.0)
    params = list(model.parameters())
    state = opt.init(params)
    t0 = time.perf_counter()
    for _ in range(500):
        for p in params:
            p.grad = None
        loss = torch.mean(torch.square(model(0.0, x0) - v_true)) + model.group_lasso_reg()
        loss.backward()
        opt.apply(params, [p.grad for p in params], state)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    scores = model.get_structure().detach().T.cpu()
    true = A.cpu().abs() > 0
    log(f"MLPODEF structure recovery: 500 steps in {sec:.3f} s; true edges' least score "
        f"{float(scores[true].min()):.4f}, absent edges' largest {float(scores[~true].max()):.4f} "
        f"({smi})")
    if not float(scores[true].min()) > float(scores[~true].max()):
        raise AssertionError(f"MLPODEF structure not recovered: {scores}")

    d, k = GRN_GENES, GRN_HIDDEN
    x = torch.randn((GRN_CELLS, d), generator=torch.Generator().manual_seed(26))
    out = {}
    for name, module in (("MLPODEF ensemble", grn.MLPODEF([d, k, 1])),
                         ("DiBS particles", grn.DibsMLPODEF([d, k, 1]))):
        init_fn, _ = grn.make_ensemble(module, GRN_MEMBERS)
        stacked = init_fn(torch.Generator().manual_seed(27))
        for dev in ("cpu", "cuda"):
            _, apply_fn = grn.make_ensemble(module.to(dev), GRN_MEMBERS)
            leaves = {n: v.detach().to(dev, copy=True).requires_grad_(True)
                      for n, v in stacked.items()}
            with strict_f32():
                t0 = time.perf_counter()
                v = apply_fn(leaves, 0.0, x.to(dev))
                torch.mean(v ** 2).backward()
                grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in leaves.items()}
                phi = grn.svgd_update({n: p.detach() for n, p in leaves.items()}, grads)
                if dev == "cuda":
                    torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            out[dev] = {"output": {"v": v.detach().cpu()},
                        "gradient": {n: t.cpu() for n, t in grads.items()},
                        "direction": {n: t.cpu() for n, t in phi.items()}}
        zero = [n for n, p in stacked.items()
                if bool((p == p[:1]).all()) and not bool(out["cpu"]["gradient"][n].any())]
        errs = {}
        for kind, cpu in out["cpu"].items():
            top = max(t.abs().max().item() for t in cpu.values())
            for n, want in cpu.items():
                scale = (top if kind == "direction" and n in zero
                         else max(want.abs().max().item(), 1e-3 * top))
                errs[f"{kind} {n}"] = (out["cuda"][kind][n] - want).abs().max().item() / scale
        where = max(errs, key=lambda e: math.inf if math.isnan(errs[e]) else errs[e])
        worst = errs[where]
        log(f"{name} ({GRN_MEMBERS} members, {d} genes, hidden {k}, {GRN_CELLS} cells): outputs "
            f"{tuple(v.shape)}, gradients and one svgd_update on the card in {sec:.3f} s; card vs "
            f"CPU worst {worst:.2e} ({where}) of each tensor's max-abs, or 1e-3 of the largest "
            f"leaf's of its kind; directions held to the largest leaf's: {zero} (limit {SC_TOL})")
        if not worst <= SC_TOL:
            raise AssertionError(f"{name} card vs CPU: {worst} ({where})")


# The research variants (phases 27-31).
VARIANT_TOL = 1e-4        # card vs CPU, fixed-step losses and gradients (of each tensor's max-abs,
                          # or 1e-3 of the largest of its kind where that is more); forwards 1e-5
# Phase 27 holds the card against the CPU through the notebook's SELU MLP in
# float64. SELU's derivative jumps at 0, so the trace jumps where a
# pre-activation crosses 0; in float32 the two devices' roundings now and then
# put one on either side (one reading of 1.25e-4 in 40 euler steps) and dopri5
# then takes other steps on each device. In float64 the roundings are 1e-16.
CNF_TOL = 1e-9
SB_KL_GATE = 0.15         # phase 29: SB-CFM's largest marginal KL (tests/test_sb_oracle.py's gate)
VARIANT_BUDGET_S = 110.0  # phases 27-31 together; main fails above it
# Phase 27's training: the notebook's 300 steps (220-260 ms a step on the
# card, launch-bound: 40 per-sample Jacobians and their backward), cut only
# where they would overrun CNF_TRAIN_BUDGET_S, the cut printed. The budget is
# VARIANT_BUDGET_S less phase 27's checks (about 20 s) and phases 28-31's
# (about 40 s), with a margin; it was 65 s until phases 32-33 joined the
# script's time limit (70-100 of the 300 steps at 25 s).
CNF_STEPS, CNF_TRAIN_BUDGET_S = 300, 25.0


def max_rel_errors(card, cpu, floor=1e-3):
    """{name: |card - cpu|max / scale}: the scale each CPU tensor's max-abs,
    or ``floor`` times the largest of its kind (the word before the first
    space of its name) where that is more."""
    tops = {}
    for name, t in cpu.items():
        kind = name.split()[0]
        tops[kind] = max(tops.get(kind, 0.0), float(t.abs().max()))
    out = {}
    for name, want in cpu.items():
        scale = max(float(want.abs().max()), floor * tops[name.split()[0]], 1e-30)
        out[name] = float((card[name].detach().cpu() - want).abs().max()) / scale
    return out


def hold(what, card, cpu, tol, floor=1e-3):
    """Raise unless every card tensor is within ``tol`` of its CPU twin
    (``max_rel_errors``); returns the worst error."""
    errs = max_rel_errors(card, cpu, floor)
    where = max(errs, key=lambda k: math.inf if math.isnan(errs[k]) else errs[k])
    log(f"  {what}: card vs CPU worst {errs[where]:.2e} ({where}; limit {tol})")
    if not errs[where] <= tol:
        raise AssertionError(f"{what}: card vs CPU {errs[where]} at {where} (limit {tol})")
    return errs[where]


def both_devices(make):
    """``make()`` builds a module on the CPU from its seed; returns it and a
    copy on the card."""
    import copy

    cpu = make()
    return cpu, copy.deepcopy(cpu).to("cuda")


def loss_and_grads(module, loss):
    """{"loss": loss, "grad <name>": ...} after ``loss.backward()``."""
    import torch

    for p in module.parameters():
        p.grad = None
    loss.backward()
    out = {"loss": loss.detach().cpu().reshape(1)}
    for n, p in module.named_parameters():
        out[f"grad {n}"] = (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
    return out


def cnf_maximum_likelihood(smi):
    """Phase 27: ``maximum_likelihood_CNF_tutorial`` as given: ``MLP(2, w=64)``,
    ``make_cnf_nll_loss(n_steps=40, divergence="exact")``, moons at batch
    128, Adam 2e-3, CNF_STEPS steps (cut only where they would overrun
    CNF_TRAIN_BUDGET_S, the cut printed); the NLL must fall.
    ``cnf_log_likelihood`` on the notebook's 60x60 grid at 60 steps. Then
    card against CPU on the trained weights and the same inputs, in float64
    (CNF_TOL): one batch's loss and gradients, and on its first 32 points
    the adaptive-adjoint route with Hutchinson probes (``adaptive=True``,
    rtol = atol = 1e-5) and ``augmented_odeint`` by dopri5 with l1, l2, squared_l2 and
    the three Jacobian regularisers (the NFE equal); then two more float32
    train steps by the adaptive route on the card. No kernel runs here."""
    import numpy as np
    import torch
    from cfm_tpu_torch import augment, variants
    from cfm_tpu_torch.data.toy import sample_moons
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.integrate import odeint
    from cfm_tpu_torch.models import MLP
    from cfm_tpu_torch.train import make_optimizer

    t_phase = time.perf_counter()
    model = MLP(2, w=64, seed=0, device="cuda")
    nll = variants.make_cnf_nll_loss(model, n_steps=40, divergence="exact")
    opt = make_optimizer(lr=2e-3, warmup_steps=0, grad_clip=0.0)
    params = list(model.parameters())
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step(loss_fn):
        x1 = sample_moons(gen, 128)
        for p in params:
            p.grad = None
        loss, _ = loss_fn(gen, None, x1)
        loss.backward()
        opt.apply(params, [p.grad for p in params], state)
        return loss.detach()

    losses = [step(nll) for _ in range(10)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(nll) for _ in range(10)]
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / 10
    left = CNF_TRAIN_BUDGET_S - (time.perf_counter() - t_phase)
    steps = min(CNF_STEPS, 20 + max(0, int(left / per)))
    if steps < CNF_STEPS:
        log(f"  phase 27: the notebook's {CNF_STEPS} steps cut to {steps}: {1e3 * per:.1f} ms a "
            f"step, {left:.1f} s left of CNF_TRAIN_BUDGET_S")
    t0 = time.perf_counter()
    losses += [step(nll) for _ in range(steps - 20)]
    torch.cuda.synchronize()
    if steps > 20:
        per = (time.perf_counter() - t0) / (steps - 20)
    losses = [float(v) for v in losses]
    log(f"CNF maximum likelihood: {steps} steps at {1e3 * per:.1f} ms a step after the first "
        f"20 (40 euler steps, exact trace, batch 128); NLL {losses[0]:.4f} at step 0, "
        f"{np.mean(losses[-20:]):.4f} over the last 20 ({smi})")
    if not (np.isfinite(losses).all() and np.mean(losses[-20:]) < losses[0] - 0.5):
        raise AssertionError(f"CNF NLL did not fall: {losses[:3]} ... {losses[-3:]}")

    xs, ys = torch.linspace(-1.5, 2.5, 60, device="cuda"), torch.linspace(-1.0, 1.5, 60, device="cuda")
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    f = lambda t, x: model(torch.full((x.shape[0],), t, device=x.device), x)
    t0 = time.perf_counter()
    with torch.no_grad():
        logp = augment.cnf_log_likelihood(f, grid, n_steps=60, divergence="exact")
        data_logp = augment.cnf_log_likelihood(f, sample_moons(gen, 512), n_steps=60)
    torch.cuda.synchronize()
    log(f"  log p on the 60x60 grid at 60 steps: {time.perf_counter() - t0:.2f} s with 512 moons "
        f"points; grid mean {float(logp.mean()):.3f}, max {float(logp.max()):.3f}; data mean "
        f"{float(data_logp.mean()):.3f}")
    if not (torch.isfinite(logp).all() and float(data_logp.mean()) > float(logp.mean())):
        raise AssertionError("CNF log-likelihood on the grid not finite or not above it on the data")

    import copy
    f64 = torch.float64
    cpu_model, card_model = copy.deepcopy(model).cpu().to(f64), copy.deepcopy(model).to(f64)
    x1 = sample_moons(torch.Generator().manual_seed(27), 128).to(f64)
    x32 = x1[:32]
    probes = augment.rademacher(torch.Generator().manual_seed(28), (32, 1, 2), f64)
    worst = {}
    with strict_f32():
        runs = {}
        for dev, m in (("cpu", cpu_model), ("cuda", card_model)):
            loss, _ = variants.make_cnf_nll_loss(m, n_steps=40)(None, None, x1.to(dev))
            runs[dev] = loss_and_grads(m, loss)
        worst["fixed"] = hold("CNF NLL, 40 euler steps, one batch, float64", runs["cuda"],
                              runs["cpu"], CNF_TOL)
        runs, nfe = {}, {}
        for dev, m in (("cpu", cpu_model), ("cuda", card_model)):
            t0 = time.perf_counter()
            loss, _ = variants.make_cnf_nll_loss(m, divergence="hutch", adaptive=True)(
                None, None, x32.to(dev), probes=probes)
            runs[dev] = loss_and_grads(m, loss)
            log(f"  adaptive adjoint (dopri5, hutch, float64) on {dev}: "
                f"{time.perf_counter() - t0:.2f} s, loss {float(loss.detach()):.8f}")
        worst["adaptive"] = hold("CNF NLL by the continuous adjoint, float64", runs["cuda"],
                                 runs["cpu"], CNF_TOL)
        regs, jac = ("l1", "l2", "squared_l2"), augment.JACOBIAN_REGULARIZERS
        out = {}
        for dev, m in (("cpu", cpu_model), ("cuda", card_model)):
            fd = lambda t, x, m=m: m(torch.full((x.shape[0],), t, device=x.device), x)
            aug = augment.make_augmented_field(fd, reg_names=regs, divergence="exact",
                                               jac_reg_names=jac)
            z = torch.zeros(32, device=dev, dtype=f64)
            init = augment.AugmentedState(x32.to(dev), z, {n: z for n in regs + jac})
            t0 = time.perf_counter()
            with torch.no_grad():
                sol = odeint(aug, init, [0.0, 1.0], method="dopri5", return_trajectory=False)
            fin, nfe[dev] = sol.final, sol.nfe
            out[dev] = dict({"x": fin.x, "logp": fin.logp}, **{f"reg {k}": v
                                                                for k, v in fin.regs.items()})
            out[dev] = {k: v.detach().cpu() for k, v in out[dev].items()}
            log(f"  augmented dopri5 (float64) on {dev}: NFE {sol.nfe}, "
                f"{time.perf_counter() - t0:.2f} s, "
                + ", ".join(f"{k} {float(v.mean()):.4f}" for k, v in fin.regs.items()))
        worst["augmented"] = hold("augmented_odeint, dopri5, six regularisers, float64",
                                  out["cuda"], out["cpu"], CNF_TOL)
        if nfe["cuda"] != nfe["cpu"]:
            raise AssertionError(f"augmented dopri5 NFE differs: {nfe}")
    adaptive = variants.make_cnf_nll_loss(model, divergence="hutch", adaptive=True)
    t0 = time.perf_counter()
    more = [float(step(adaptive)) for _ in range(2)]
    torch.cuda.synchronize()
    log(f"  two adaptive-adjoint train steps on the card: {time.perf_counter() - t0:.2f} s, "
        f"losses {more}")
    log(f"phase 27 in {time.perf_counter() - t_phase:.1f} s")
    return worst


def ot_study(smi):
    """Phase 28: the minibatch-OT study notebook as given. 20 exact plans of
    8-Gaussians against moons at 256 (20 #5 launches): Var[u] under OT must
    be below the independent coupling's. I-CFM and OT-CFM (sigma 0.1), MLP
    width 64, 600 steps each at batch 256, Adam 2e-3, EMA 0.99 (OT-CFM's
    steps 600 more #5 launches); ``straightness`` of both EMA flows on the
    same 1024 points (euler, 20 steps): OT-CFM must be straighter, as the
    notebook asserts. Then ``reflow_pairs`` from the OT-CFM flow at 1024
    points and 100 steps. Returns the launch counts."""
    import torch
    from cfm_tpu_torch import variants
    from cfm_tpu_torch.coupling import OTPlanSampler
    from cfm_tpu_torch.data.toy import eight_gaussians, sample_moons
    from cfm_tpu_torch.models import MLP
    from cfm_tpu_torch.paths import (ConditionalFlowMatcher,
                                     ExactOptimalTransportConditionalFlowMatcher)
    from cfm_tpu_torch.train import (ema_module, init_train_state, make_optimizer,
                                     make_train_step)

    t_phase = time.perf_counter()
    zero_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sampler = OTPlanSampler(method="exact")
    u_ind, u_ot = [], []
    for _ in range(20):
        x0, x1 = eight_gaussians(gen, 256), sample_moons(gen, 256)
        u_ind.append(x1 - x0)
        x0p, x1p = sampler.sample_plan(gen, x0, x1)
        u_ot.append(x1p - x0p)
    v_ind, v_ot = float(torch.cat(u_ind).var(correction=0)), float(torch.cat(u_ot).var(correction=0))
    plans = read_counts()["auction"]
    log(f"minibatch-OT study: Var[u_t] independent {v_ind:.3f}, minibatch OT {v_ot:.3f} "
        f"({plans} dense auction launches for the 20 plans)")
    if not (plans == 20 and v_ot < v_ind):
        raise AssertionError(f"OT study plans: {plans} launches, Var {v_ot} vs {v_ind}")

    def train(matcher, steps=600):
        model = MLP(2, w=64, seed=1, device="cuda")
        opt = make_optimizer(lr=2e-3, warmup_steps=0)
        state = init_train_state(model, opt)
        step = make_train_step(matcher, model, opt, ema_decay=0.99)
        g = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            m = step(state, eight_gaussians(g, 256), sample_moons(g, 256), generator=g)
        torch.cuda.synchronize()
        return ema_module(model, state.ema_params), (time.perf_counter() - t0) / steps, float(m["loss"])

    x_eval = eight_gaussians(torch.Generator(device="cuda").manual_seed(2), 1024)
    results = {}
    for name, matcher in (("I-CFM", ConditionalFlowMatcher(sigma=0.1)),
                          ("OT-CFM", ExactOptimalTransportConditionalFlowMatcher(sigma=0.1))):
        before = read_counts()["auction"]
        ema, per, last = train(matcher)
        with torch.no_grad():
            s = float(variants.straightness(ema, x_eval))
        results[name] = (ema, s)
        log(f"  {name}: 600 steps at {1e3 * per:.2f} ms a step, last loss {last:.4f}, "
            f"{read_counts()['auction'] - before} #5 launches; straightness {s:.4f}")
    if not results["OT-CFM"][1] < results["I-CFM"][1]:
        raise AssertionError(f"OT-CFM not straighter: {results['OT-CFM'][1]} vs "
                             f"{results['I-CFM'][1]}")
    t0 = time.perf_counter()
    x0, x1 = variants.reflow_pairs(results["OT-CFM"][0], x_eval, n_steps=100)
    torch.cuda.synchronize()
    log(f"  reflow_pairs from OT-CFM: 1024 pairs by 100 euler steps in "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms; mean |x1 - x0| {float((x1 - x0).norm(dim=1).mean()):.3f}, "
        f"x1 mean {x1.mean(0).tolist()}")
    if not torch.isfinite(x1).all():
        raise AssertionError("reflow pairs not finite")
    launches = read_counts()
    if launches["auction"] != 620:
        raise AssertionError(f"OT study: {launches['auction']} #5 launches, not 620")
    log(f"phase 28 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


def bridges(smi):
    """Phase 29: SB-CFM (sigma 0.5, entropic coupling, 400 steps at batch
    256, Adam 2e-3, EMA 0.99) on the SB Gaussians (a = 0.1), the marginals
    of its rk4 flow from 4096 points at t = 0, 0.25, ..., 1 against the
    closed-form bridge: largest KL under SB_KL_GATE. DSBM: two MLPs of width
    64 trained jointly by ``make_dsbm_loss`` (constant schedule 0.5) for 400
    steps, its probability-flow drift rolled out by rk4 from 4096 points,
    ``sb_trajectory_kl`` printed. ``ScheduleBridgeMatcher`` under the three
    schedules, card against CPU given the same t and eps (1e-5); one forward
    and one reverse ``ipf_resample_pairs`` at 4096 points and 100 steps,
    card against CPU given the same normals (VARIANT_TOL). No kernel runs
    (the entropic coupling at 256 is below the flash route)."""
    import copy

    import numpy as np
    import torch
    from cfm_tpu_torch import schedules, variants
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.eval.sb_oracle import sample_sb_endpoints, sb_marginal_kl, sb_trajectory_kl
    from cfm_tpu_torch.integrate import odeint, vector_field_from_model
    from cfm_tpu_torch.models import MLP
    from cfm_tpu_torch.paths import SchrodingerBridgeConditionalFlowMatcher
    from cfm_tpu_torch.train import (ema_module, init_train_state, make_optimizer,
                                     make_train_step)

    t_phase = time.perf_counter()
    zero_counts()
    a, sigma = 0.1, 0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = MLP(2, w=64, seed=0, device="cuda")
    opt = make_optimizer(lr=2e-3, warmup_steps=0)
    state = init_train_state(model, opt)
    step = make_train_step(SchrodingerBridgeConditionalFlowMatcher(sigma=sigma, ot_method="sinkhorn"),
                           model, opt, ema_decay=0.99)
    t0 = time.perf_counter()
    for _ in range(400):
        x0, x1 = sample_sb_endpoints(gen, 256, a=a)
        step(state, x0, x1, generator=gen)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / 400
    ts = np.linspace(0.0, 1.0, 21, dtype=np.float32)
    x0 = sample_sb_endpoints(gen, 4096, a=a)[0]
    with torch.no_grad():
        sol = odeint(vector_field_from_model(ema_module(model, state.ema_params)), x0, ts,
                     method="rk4")
    kls = [float(sb_marginal_kl(sol.ys[i], a, sigma, float(ts[i]))) for i in range(0, 21, 5)]
    log(f"SB-CFM on the SB Gaussians: 400 steps at {1e3 * per:.2f} ms a step; rk4 marginal KLs "
        f"{[round(k, 4) for k in kls]} (gate {SB_KL_GATE})")
    if not max(kls) < SB_KL_GATE:
        raise AssertionError(f"SB-CFM marginal KLs {kls}")

    fwd, bwd = MLP(2, w=64, seed=1, device="cuda"), MLP(2, w=64, seed=2, device="cuda")
    loss_fn = variants.make_dsbm_loss(fwd, bwd, schedules.ConstantNoiseScheduler(sigma))
    params = list(fwd.parameters()) + list(bwd.parameters())
    dopt = make_optimizer(lr=2e-3, warmup_steps=0)
    dstate = dopt.init(params)
    t0 = time.perf_counter()
    for i in range(400):
        x0, x1 = sample_sb_endpoints(gen, 256, a=a)
        for p in params:
            p.grad = None
        loss, aux = loss_fn(gen, x0, x1)
        loss.backward()
        dopt.apply(params, [p.grad for p in params], dstate)
        if i == 0:
            first = float(loss.detach())
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / 400
    with torch.no_grad():
        traj = odeint(variants.dsbm_ode_drift(fwd, bwd), sample_sb_endpoints(gen, 4096, a=a)[0],
                      ts, method="rk4").ys
    kl = float(sb_trajectory_kl(traj, torch.from_numpy(ts), a, sigma))
    loss, fwd_loss, bwd_loss = (float(v.detach()) for v in (loss, aux["fwd_loss"], aux["bwd_loss"]))
    log(f"  DSBM: 400 steps at {1e3 * per:.2f} ms a step, loss {first:.4f} -> {loss:.4f} "
        f"(fwd {fwd_loss:.4f}, bwd {bwd_loss:.4f}); probability-flow "
        f"rk4 mean KL along the bridge {kl:.4f}")
    if not (np.isfinite(kl) and loss < first):
        raise AssertionError(f"DSBM: loss {first} -> {loss}, KL {kl}")

    rng = np.random.default_rng(29)
    x0c, x1c, eps = (torch.from_numpy(rng.standard_normal((4096, 2)).astype(np.float32))
                     for _ in range(3))
    tc = torch.from_numpy(rng.uniform(size=4096).astype(np.float32))
    with strict_f32():
        for sched in (schedules.ConstantNoiseScheduler(sigma),
                      schedules.LinearDecreasingNoiseScheduler(0.1, 1.0),
                      schedules.CosineNoiseScheduler(0.8)):
            out = {dev: variants.ScheduleBridgeMatcher(sched).sample_location_and_targets(
                None, x0c.to(dev), x1c.to(dev), t=tc.to(dev), eps=eps.to(dev))
                for dev in ("cpu", "cuda")}
            hold(f"ScheduleBridgeMatcher, {type(sched).__name__}, 4096 points",
                 {f"{k} ": v for k, v in out["cuda"].items()},
                 {f"{k} ": v for k, v in out["cpu"].items()}, 1e-5)
        noise = [torch.from_numpy(rng.standard_normal((4096, 2)).astype(np.float32))
                 for _ in range(100)]
        for reverse, drift, start in ((False, fwd, x0c), (True, bwd, x1c + 2 * a)):
            out = {}
            for dev in ("cpu", "cuda"):
                m = drift if dev == "cuda" else copy.deepcopy(drift).cpu()
                t0 = time.perf_counter()
                pair = variants.ipf_resample_pairs(None, m, start.to(dev), sigma_min=sigma,
                                                   n_steps=100, reverse=reverse,
                                                   noise=[z.to(dev) for z in noise])
                out[dev] = {"pair 0": pair[0], "pair 1": pair[1]}
                if dev == "cuda":
                    torch.cuda.synchronize()
                    made = pair[0] if reverse else pair[1]
                    log(f"  ipf_resample_pairs {'reverse' if reverse else 'forward'}: 4096 points, "
                        f"100 Euler-Maruyama steps on the card in {time.perf_counter() - t0:.3f} s; "
                        f"the synthesised marginal's mean {made.mean(0).tolist()}")
            hold(f"ipf_resample_pairs reverse={reverse}", out["cuda"], out["cpu"], VARIANT_TOL)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"bridges launched kernels: {launches}")
    log(f"phase 29 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


def action_and_icnn(smi):
    """Phase 30: action matching with ``_ActionNet`` (width 64) for 300 steps,
    8-Gaussians to moons at batch 256, Adam 1e-3, and one batch's loss and
    gradients card against CPU; ``GradModel`` card against CPU (its output
    and the gradients of a loss through it); the dual ICNNs (dim 2, hidden
    (64, 64, 64, 64)) for 500 alternating g and f steps at batch 256 (Adam
    1e-3 each), ``w2_estimate`` on 2048 points beside half the squared W2
    of the port's exact ``wasserstein(..., power=2)`` on the same points
    (one #6 launch); ``average_ut`` at 256, card against CPU on the same
    indices. Returns the launch counts."""
    import numpy as np
    import torch
    from cfm_tpu_torch import variants
    from cfm_tpu_torch.coupling import wasserstein
    from cfm_tpu_torch.data.toy import eight_gaussians, sample_moons
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.models import ICNN, GradModel
    from cfm_tpu_torch.models.mlp import _ActionNet
    from cfm_tpu_torch.train import make_optimizer

    t_phase = time.perf_counter()
    zero_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    net = _ActionNet(2, 64, seed=0, device="cuda")
    am = variants.make_action_matching_loss(net)
    params = list(net.parameters())
    opt = make_optimizer(lr=1e-3, warmup_steps=0)
    state = opt.init(params)
    t0 = time.perf_counter()
    losses = []
    for _ in range(300):
        for p in params:
            p.grad = None
        loss, _ = am(gen, eight_gaussians(gen, 256), sample_moons(gen, 256))
        loss.backward()
        opt.apply(params, [p.grad for p in params], state)
        losses.append(loss.detach())
    torch.cuda.synchronize()
    losses = [float(v) for v in losses]
    log(f"action matching: 300 steps at {1e3 * (time.perf_counter() - t0) / 300:.2f} ms a step, "
        f"loss {losses[0]:.4f} -> {np.mean(losses[-20:]):.4f} (last 20)")
    if not np.isfinite(losses).all():
        raise AssertionError("action matching losses not finite")
    rng = np.random.default_rng(30)
    xa, xb = (torch.from_numpy(rng.standard_normal((256, 2)).astype(np.float32) * s)
              for s in (3.0, 1.0))
    ta = torch.from_numpy(rng.uniform(size=256).astype(np.float32))
    import copy
    with strict_f32():
        runs = {}
        for dev, m in (("cpu", copy.deepcopy(net).cpu()), ("cuda", net)):
            loss, _ = variants.make_action_matching_loss(m)(None, xa.to(dev), xb.to(dev),
                                                            t=ta.to(dev))
            runs[dev] = loss_and_grads(m, loss)
        hold("action matching, one batch", runs["cuda"], runs["cpu"], VARIANT_TOL)
        cpu_g, card_g = both_devices(lambda: GradModel(2, 64, seed=3))
        runs = {}
        for dev, m in (("cpu", cpu_g), ("cuda", card_g)):
            v = m(ta.to(dev), xa.to(dev))
            runs[dev] = dict(loss_and_grads(m, torch.sum(v ** 2)), **{"v ": v.detach().cpu()})
        hold("GradModel output and second-order gradients", runs["cuda"], runs["cpu"],
             VARIANT_TOL)

    f, g = ICNN(2, (64,) * 4, seed=4, device="cuda"), ICNN(2, (64,) * 4, seed=5, device="cuda")
    g_loss, f_loss, grad_g, w2_estimate = variants.make_icnn_losses(f, g)
    fp, gp = list(f.parameters()), list(g.parameters())
    fo, go = make_optimizer(lr=1e-3, warmup_steps=0), make_optimizer(lr=1e-3, warmup_steps=0)
    fs, gs = fo.init(fp), go.init(gp)
    t0 = time.perf_counter()
    for _ in range(500):
        x, y = eight_gaussians(gen, 256), sample_moons(gen, 256)
        for p in fp + gp:
            p.grad = None
        gl, _ = g_loss(x)
        gl.backward()
        go.apply(gp, [p.grad for p in gp], gs)
        for p in fp + gp:
            p.grad = None
        fl, _ = f_loss(x, y)
        fl.backward()
        fo.apply(fp, [p.grad for p in fp], fs)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / 500
    x, y = eight_gaussians(gen, 2048), sample_moons(gen, 2048)
    with torch.no_grad():
        est = float(w2_estimate(x, y))
    before = read_counts()["auction_tiled"]
    w2 = float(wasserstein(x, y, power=2))
    tiled = read_counts()["auction_tiled"] - before
    log(f"  dual ICNNs: 500 alternating steps at {1e3 * per:.2f} ms a pair; g loss {float(gl):.4f}, "
        f"f loss {float(fl):.4f}; w2_estimate on 2048 points {est:.4f} beside the exact "
        f"W2^2 / 2 {0.5 * w2 * w2:.4f} ({tiled} tiled auction launch)")
    if not (np.isfinite(est) and tiled == 1):
        raise AssertionError(f"ICNN: estimate {est}, {tiled} tiled launches")

    xs, mu, ut = (torch.from_numpy(rng.standard_normal((256, 2)).astype(np.float32))
                  for _ in range(3))
    idx = torch.from_numpy(rng.integers(0, 256, (256, 15)))
    with strict_f32():
        out = {dev: {"ubar ": variants.average_ut(None, xs.to(dev), mu.to(dev), 0.5, ut.to(dev),
                                                  16, idx=idx)}
               for dev in ("cpu", "cuda")}
        hold("average_ut at 256, avg_size 16", out["cuda"], out["cpu"], 1e-5)
    launches = read_counts()
    log(f"phase 30 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


FFJORD_MNIST = dict(hidden=(64, 64, 64), strides=(1, 1, 1, 1), layer_type="concat",
                    nonlinearity="softplus")  # rtqichen/ffjord README's MNIST flags


def diffeq_zoo(smi):
    """Phase 31: the diffeq zoo at real width, each forward and the
    gradients of its sum of squares card against CPU (forwards 1e-5,
    gradients VARIANT_TOL): ``ODEnet`` (hidden (64, 64)) of each of the
    seven linear types on (256, 2); ``ConvODEnet`` at FFJORD's MNIST widths
    (``--dims 64,64,64 --strides 1,1,1,1 --layer_type concat``, softplus)
    on (256, 28, 28, 1) random images (MNIST is not in the repository); the
    (1, 2, -2, 1) stride stack with ``num_squeeze=1``; ``ResNetDiffEq(1, 64,
    4)`` on (64, 28, 28, 1), whose 9 GroupNorms a pass are #8 launches and
    whose backward's are #9; ``HyperConv2d`` and ``AutoencoderDiffEqNet``
    (conv, (1, 2, -2, 1)). Then the NLL of ``ResNetDiffEq(1, 64, 4)`` by a
    Hutchinson trace (batch 8, euler, 4 steps) and its gradients, card
    against CPU (the forward 1e-5, the gradients VARIANT_TOL): its per-sample
    vjp maps the GroupNorms' autograd Functions, so #8 and #9 launch once a
    GroupNorm over the whole batch, and the loss's backward runs their
    second derivative. Then ``cnf_log_likelihood`` with a Hutchinson trace
    over the FFJORD ``ConvODEnet``, batch 64, euler, 20 steps, timed.
    Returns the card runs' launch counts."""
    import numpy as np
    import torch
    from cfm_tpu_torch import augment, variants
    from cfm_tpu_torch.device import strict_f32
    from cfm_tpu_torch.models import diffeq

    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    img = lambda n: torch.from_numpy(rng.standard_normal((n, 28, 28, 1)).astype(np.float32))
    t256 = torch.from_numpy(rng.uniform(size=256).astype(np.float32))
    x2 = torch.from_numpy(rng.standard_normal((256, 2)).astype(np.float32))
    cases = [(f"ODEnet {k}", (lambda k=k: diffeq.ODEnet(2, (64, 64), 2, layer_type=k, seed=1)),
              t256, x2) for k in diffeq._LAYER_TYPES]
    images, same_t = img(256), torch.full((256,), 0.4)
    h = FFJORD_MNIST
    cases += [
        ("ConvODEnet FFJORD MNIST", lambda: diffeq.ConvODEnet(
            1, h["hidden"], 1, layer_type=h["layer_type"], nonlinearity=h["nonlinearity"],
            strides=h["strides"], seed=2), same_t, images),
        ("ConvODEnet (1, 2, -2, 1) squeeze 1", lambda: diffeq.ConvODEnet(
            1, (64, 64, 64), 4, layer_type="concat", strides=(1, 2, -2, 1), num_squeeze=1, seed=3),
         same_t, images),
        ("ResNetDiffEq(1, 64, 4)", lambda: diffeq.ResNetDiffEq(1, 64, 4, seed=4),
         same_t[:64], images[:64]),
        ("HyperConv2d(1, 64)", lambda: diffeq.HyperConv2d(1, 64, seed=5), same_t, images),
        ("AutoencoderDiffEqNet conv", lambda: diffeq.AutoencoderDiffEqNet(
            1, (64, 64, 64), 1, conv=True, strides=(1, 2, -2, 1), seed=6), same_t, images),
    ]
    launches = {k: 0 for k in kernel_fns()}
    with strict_f32():
        for name, make, t, x in cases:
            cpu_m, card_m = both_devices(make)
            runs = {}
            for dev, m in (("cpu", cpu_m), ("cuda", card_m)):
                if dev == "cuda":
                    torch.cuda.synchronize()
                    before = read_counts()
                t0 = time.perf_counter()
                out = m(t.to(dev), x.to(dev))
                parts = out if isinstance(out, tuple) else (out,)
                runs[dev] = dict(loss_and_grads(m, sum((p * p).sum() for p in parts)),
                                 **{f"out{i} ": p.detach().cpu() for i, p in enumerate(parts)})
                if dev == "cuda":
                    torch.cuda.synchronize()
                    got = {k: v - before[k] for k, v in read_counts().items()}
                    launches = {k: launches[k] + got[k] for k in launches}
                    log(f"  {name}: forward and backward on the card in "
                        f"{1e3 * (time.perf_counter() - t0):.1f} ms, outputs "
                        f"{[tuple(p.shape) for p in parts]}, launches "
                        f"{ {k: v for k, v in got.items() if v} }")
            outs = {k: v for k, v in runs["cpu"].items() if k.startswith("out")}
            hold(f"{name} forward", {k: runs["cuda"][k] for k in outs}, outs, 1e-5)
            hold(f"{name} gradients", runs["cuda"], runs["cpu"], VARIANT_TOL)
            if name.startswith("ResNetDiffEq") and (got["gn_silu_fwd"] != 9
                                                    or got["gn_silu_bwd"] != 9):
                raise AssertionError(f"ResNetDiffEq launches {got}")
        cpu_m, card_m = both_devices(lambda: diffeq.ResNetDiffEq(1, 64, 4, seed=4))
        x8 = images[:8]
        probes = augment.rademacher(torch.Generator().manual_seed(32), (8, 1, 784))
        runs = {}
        for dev, m in (("cpu", cpu_m), ("cuda", card_m)):
            if dev == "cuda":
                torch.cuda.synchronize()
                before = read_counts()
            t0 = time.perf_counter()
            loss, _ = variants.make_cnf_nll_loss(m, n_steps=4, divergence="hutch")(
                None, None, x8.to(dev), probes=probes)
            runs[dev] = loss_and_grads(m, loss)
            if dev == "cuda":
                torch.cuda.synchronize()
                got = {k: v - before[k] for k, v in read_counts().items()}
                launches = {k: launches[k] + got[k] for k in launches}
            seen = {k: v for k, v in got.items() if v} if dev == "cuda" else "none"
            log(f"  ResNetDiffEq(1, 64, 4) NLL, Hutchinson, batch 8, 4 euler steps, and its "
                f"gradients on {dev}: {1e3 * (time.perf_counter() - t0):.1f} ms, loss "
                f"{float(loss.detach()):.4f}, launches {seen}")
        hold("ResNetDiffEq NLL", {"loss": runs["cuda"]["loss"]}, {"loss": runs["cpu"]["loss"]},
             1e-5)
        hold("ResNetDiffEq NLL gradients", runs["cuda"], runs["cpu"], VARIANT_TOL)
        if not (got["gn_silu_fwd"] and got["gn_silu_bwd"]):
            raise AssertionError(f"ResNetDiffEq NLL launched no GroupNorm kernel: {got}")
    net = diffeq.ConvODEnet(1, h["hidden"], 1, layer_type=h["layer_type"],
                            nonlinearity=h["nonlinearity"], strides=h["strides"], seed=2,
                            device="cuda")
    f = lambda t, x: net(torch.full((x.shape[0],), t, device=x.device), x)
    x64 = images[:64].cuda()
    gen = torch.Generator(device="cuda").manual_seed(31)
    with torch.no_grad():
        augment.cnf_log_likelihood(f, x64, n_steps=2, divergence="hutch", generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll = augment.cnf_log_likelihood(f, x64, n_steps=20, divergence="hutch", generator=gen)
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    log(f"  FFJORD ConvODEnet log-likelihood, Hutchinson trace, batch 64, euler 20 steps: "
        f"{1e3 * sec:.1f} ms ({64 / sec:.1f} images/s), mean log p {float(ll.mean()):.2f} "
        f"({float(ll.mean()) / 784 / math.log(2):.3f} bits/dim of the random images)")
    if not torch.isfinite(ll).all():
        raise AssertionError("FFJORD log-likelihood not finite")
    log(f"phase 31 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


DP_BUDGET_S = 120.0     # phases 32-33 together; main fails above it
DP_STEPS = 3            # checked steps of phases 32 and 33
DP_TIMED = 10           # timed steps of phase 32's data-parallel step
DP_SAMPLES, DP_SINKHORN = 256, (2048, 2048, 2, 2.0, 500)  # phase 33: images; n, m, d, reg, iters
DP_TOL = 2e-2           # phase 33, bf16: loss, grad norm and the moves of parameters
PHASE8_MS = 126.80      # phase 8's ms a step in an earlier full run (H100 80GB HBM3, 700 W), for probes


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_draws(B, shards, steps, seed):
    """Every draw of ``steps`` replicated-coupling steps of a global batch of
    B in ``shards`` rows: x0, x1 and per step the coupling's uniforms and
    each shard's t and eps, from one card generator (so every rank draws the
    same), and each shard's dropout seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x0 = torch.randn((B, 32, 32, 3), generator=g, device="cuda")
    x1 = torch.rand((B, 32, 32, 3), generator=g, device="cuda") * 2 - 1
    rows = B // shards
    per_step = [dict(plan_u=torch.rand(B, generator=g, device="cuda"),
                     shards=[dict(t=torch.rand(rows, generator=g, device="cuda"),
                                  eps=torch.randn((rows, 32, 32, 3), generator=g, device="cuda"),
                                  dropout=1000 * seed + 10 * i + s) for s in range(shards)])
                for i in range(steps)]
    return x0, x1, per_step


def recipe_state(lr=2e-4, warmup=5000):
    """The CIFAR-10 recipe's UNet (bf16, dropout 0.1, seeded weights) and its
    optimizer and train state; lr and warmup as given."""
    import torch
    from cfm_tpu_torch import train as ttr

    model = seeded_model(RECIPE, torch.bfloat16, "cuda", seed=0, dropout=0.1)
    opt = ttr.make_optimizer(lr=lr, warmup_steps=warmup)
    return model, opt, ttr.init_train_state(model, opt)


def data_parallel_one_rank(cifar_per_step, ms_per_step, smi):
    """Phase 32: data parallelism at world size 1 under NCCL on the CIFAR-10
    recipe (35,746,307 parameters, bf16, global batch 128, dropout 0.1),
    under ``cudnn.deterministic``. ``make_data_parallel_train_step`` for
    DP_STEPS steps against the one-process ``make_train_step`` given the
    same draws: the same bits in the parameters, EMA, moments and metrics
    after every step, and the same launches of #1, #2, #5, #8 and #9 a step
    (``cifar_per_step``). One step, its draws from a generator, under
    ``set_sync_debug_mode("error")``; then DP_TIMED steps timed beside
    phase 8's ``ms_per_step``. Then ``Trainer.fit`` of ``cifar10_otcfm``
    for 3 steps with ``trainer.data_parallel=True`` against one with it
    off: the same bits. Returns the counts of the data-parallel steps."""
    import torch
    import torch.distributed as dist
    from cfm_tpu_torch import train as ttr
    from cfm_tpu_torch.parallel import initialize_distributed
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher

    initialize_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"phase 32 runs under NCCL, got {dist.get_backend()}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = ttr.make_mesh()
        x0, x1, per_step = dp_draws(TRAIN_BATCH, 1, DP_STEPS, seed=32)
        kw = dict(ema_decay=0.9999, train_mode=True)
        matcher = ExactOptimalTransportConditionalFlowMatcher()
        model_a, opt_a, state_a = recipe_state()
        model_b, opt_b, state_b = recipe_state()
        n_params = sum(p.numel() for p in model_a.parameters())
        if n_params != 35_746_307:
            raise AssertionError(f"the recipe's UNet has {n_params} parameters")
        one = ttr.make_train_step(matcher, model_a, opt_a, **kw)
        dp = ttr.make_data_parallel_train_step(matcher, model_b, opt_b, mesh, **kw)
        counts = {k: 0 for k in kernel_fns()}
        for i, d in enumerate(per_step):
            sh = d["shards"][0]
            gen = lambda: torch.Generator(device="cuda").manual_seed(sh["dropout"])
            zero_counts()
            m_a = one(state_a, x0, x1, draws=ttr.StepDraws(sh["t"], sh["eps"], d["plan_u"], gen()))
            c_a = read_counts()
            zero_counts()
            m_b = dp(state_b, x0, x1, plan_noise=d["plan_u"],
                     draws=ttr.StepDraws(sh["t"], sh["eps"], None, gen()))
            c_b = read_counts()
            counts = {k: counts[k] + c_b[k] for k in counts}
            torch.cuda.synchronize()
            same, bad = same_bits(state_tensors(state_a), state_tensors(state_b))
            metrics_same = all(torch.equal(m_a[k], m_b[k]) for k in m_a)
            want = {k: cifar_per_step.get(k, 0) for k in c_a}
            if not (same and metrics_same) or c_a != c_b or c_b != want:
                raise AssertionError(f"phase 32 step {i}: same bits {same} (tensors {bad[:5]}), "
                                     f"metrics {metrics_same}, launches one-process {c_a}, "
                                     f"data-parallel {c_b}, expected {want}")
        log(f"phase 32: {DP_STEPS} data-parallel steps (world size 1, NCCL) equal the "
            f"one-process step bit for bit (parameters, EMA, moments, metrics); launches a step "
            f"{c_b}; loss {float(m_b['loss']):.5f}")
        g = torch.Generator(device="cuda").manual_seed(320)
        dp(state_b, x0, x1, generator=g)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dp(state_b, x0, x1, generator=g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_TIMED):
            metrics = dp(state_b, x0, x1, generator=g)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / DP_TIMED
        log(f"phase 32: a data-parallel step under set_sync_debug_mode('error'): no "
            f"synchronisation; {ms:.2f} ms a step over {DP_TIMED} (phase 8's one-process step "
            f"{ms_per_step:.2f} ms), loss {float(metrics['loss']):.5f} ({smi})")
        del model_a, model_b, state_a, state_b, one, dp
        trained = {}
        for flag in (True, False):
            trainer = phase_trainer("cifar10_otcfm", [
                f"trainer.data_parallel={flag}", "trainer.log_interval=1000",
                "data.synthetic_fallback=True", "data.data_dir=build/no_cifar10"],
                f"dp_world1_{flag}", skip_saves=True)
            trainer.fit(3)
            torch.cuda.synchronize()
            trained[flag] = state_tensors(trainer.state)
            del trainer
        same, bad = same_bits(trained[True], trained[False])
        if not same:
            raise AssertionError(f"phase 32: Trainer.fit with data_parallel=True differs from "
                                 f"the one-process fit in tensors {bad[:5]}")
        log("phase 32: Trainer.fit of cifar10_otcfm (3 steps) with trainer.data_parallel=True "
            "under the NCCL group of one rank equals the fit with it off, bit for bit")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return counts


def data_parallel_rank(rank, world, store, out):
    """Phase 33's rank ``rank`` of ``world`` (a process of its own, run as
    ``python3 chip_smoke.py --dp-rank RANK WORLD STORE OUT``): gloo through
    the ``file://`` store, CUDA tensors on the one card. Writes its findings
    to ``OUT`` as JSON."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from cfm_tpu_torch import train as ttr
    from cfm_tpu_torch.integrate import odeint, vector_field_from_model
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost
    from cfm_tpu_torch.ops.sharded_sinkhorn import sharded_sinkhorn_plan
    from cfm_tpu_torch.ops.sinkhorn import sinkhorn
    from cfm_tpu_torch.parallel import initialize_distributed, make_mesh
    from cfm_tpu_torch.paths import (ConditionalFlowMatcher,
                                     ExactOptimalTransportConditionalFlowMatcher)
    from cfm_tpu_torch.utils import ema_update

    initialize_distributed("cpu", init_method=f"file://{store}", world_size=world, rank=rank)
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh(devices="cuda")
    res = {"rank": rank, "backend": dist.get_backend()}
    B, lr, warmup = TRAIN_BATCH, 1e-3, 10
    x0, x1, per_step = dp_draws(B, world, DP_STEPS, seed=33)
    matcher = ExactOptimalTransportConditionalFlowMatcher()
    uncoupled = ConditionalFlowMatcher()
    model, opt, state = recipe_state(lr, warmup)
    oracle, opt_o, state_o = recipe_state(lr, warmup)
    init = [p.detach().clone() for p in oracle.parameters()]
    step = ttr.make_data_parallel_train_step(matcher, model, opt, mesh, ema_decay=0.9999,
                                             train_mode=True)
    rows = B // world
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    res["steps"], moved = [], 0.0
    for i, d in enumerate(per_step):
        sh = d["shards"][rank]
        metrics = step(state, x0, x1, plan_noise=d["plan_u"],
                       draws=ttr.StepDraws(sh["t"], sh["eps"], None, gen(sh["dropout"])))
        # The oracle: the global coupling, each shard's gradients, their mean, one update.
        c0, c1 = matcher.ot_sampler.sample_plan(None, x0, x1, noise=d["plan_u"])
        grads, losses = None, []
        for s, shs in enumerate(d["shards"]):
            t, xt, ut = uncoupled.sample_location_and_conditional_flow(
                None, c0[s * rows:(s + 1) * rows], c1[s * rows:(s + 1) * rows], t=shs["t"],
                eps=shs["eps"])
            vt = oracle(t, xt, train=True, generator=gen(shs["dropout"]))
            loss = torch.mean(torch.square(vt - ut))
            g = torch.autograd.grad(loss, state_o.params, allow_unused=True,
                                    materialize_grads=True)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            losses.append(loss.detach())
        grads = [a * (1.0 / world) for a in grads]
        norm = opt_o.apply(state_o.params, grads, state_o.opt_state)
        ema_update(state_o.ema_params, state_o.params, 0.9999)
        moved += ttr.warmup_lr_schedule(lr, warmup)(i)
        noise = [(a.abs() < 1e-3 * a.abs().max()) for a in grads]
        worst, worst_noise = 0.0, 0.0
        for p, q, n in zip(state.params, state_o.params, noise):
            diff = (p.detach() - q.detach()).abs()
            worst = max(worst, diff[~n].max().item() if (~n).any() else 0.0)
            worst_noise = max(worst_noise, diff[n].max().item() if n.any() else 0.0)
        res["steps"].append(dict(
            loss=float(metrics["loss"]), oracle_loss=float(sum(losses) / world),
            grad_norm=float(metrics["grad_norm"]), oracle_grad_norm=float(norm),
            move=worst, move_noise=worst_noise, moved=moved,
            same_bits=same_bits(list(state.params), list(state_o.params))[0],
            params_sha=hashlib.sha256(torch.cat([p.detach().reshape(-1) for p in state.params])
                                      .cpu().numpy().tobytes()).hexdigest()))
    del oracle, state_o, opt_o, init
    g = gen(330)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        step(state, x0, x1, generator=g)
    torch.cuda.synchronize()
    res["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / DP_STEPS
    flat = torch.ones(sum(p.numel() for p in state.params), device="cuda")
    dist.all_reduce(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    res["all_reduce_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    res["params_sha"] = hashlib.sha256(torch.cat([p.detach().reshape(-1) for p in state.params])
                                       .cpu().numpy().tobytes()).hexdigest()

    noise = torch.randn((DP_SAMPLES, 32, 32, 3), generator=gen(331), device="cuda")
    t0 = time.perf_counter()
    mine = ttr.make_data_parallel_sample_fn(model, mesh, DP_SAMPLES, (32, 32, 3), n_steps=100)(
        x0=noise)
    torch.cuda.synchronize()
    res["sample_s"] = time.perf_counter() - t0
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    if rank == 0:
        with torch.inference_mode():
            ref = odeint(vector_field_from_model(model), noise,
                         np.linspace(0.0, 1.0, 101, dtype=np.float32), method="euler",
                         return_trajectory=False).final
        got = torch.cat(parts)
        res["sample_err"] = ((got - ref).abs().max() / ref.abs().max()).item()
        res["sample_same_bits"] = bool(torch.equal(got, ref))
        res["sample_finite"] = bool(torch.isfinite(got).all())

    n, m, dim, reg, iters = DP_SINKHORN
    sg = gen(332)
    a = torch.randn((n, dim), generator=sg, device="cuda")
    b = torch.randn((m, dim), generator=sg, device="cuda") + 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = sharded_sinkhorn_plan(mesh, a[rank * n // world:(rank + 1) * n // world], b, reg,
                                 num_iters=iters)
    torch.cuda.synchronize()
    res["sinkhorn_s"] = time.perf_counter() - t0
    parts = [torch.empty_like(plan) for _ in range(world)]
    dist.all_gather(parts, plan)
    if rank == 0:
        u = torch.full((n,), 1.0 / n, device="cuda")
        dense = sinkhorn(u, torch.full((m,), 1.0 / m, device="cuda"), sq_euclidean_cost(a, b),
                         reg, num_iters=iters, tol=0.0)
        res["sinkhorn_err"] = ((torch.cat(parts) - dense).abs().max() / dense.abs().max()).item()
    with open(out, "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


def data_parallel_two_ranks(smi, world=2):
    """Phase 33: two ranks on the one card. NCCL takes one rank a card, so
    this phase runs gloo, which all-reduces CUDA tensors through the host.
    Each rank (a process of its own, ``data_parallel_rank``) trains the
    replicated-coupling CIFAR-10 step at global batch 128 (64 a rank) for
    DP_STEPS steps (lr 1e-3, warmup 10, so each step moves the parameters
    measurably) and holds it against the one-process oracle of
    tests/test_train_e2e.py:151 (couple the global batch, each shard's
    gradients, their mean, one update): loss and grad norm within DP_TOL,
    each parameter within DP_TOL of what the steps' learning rates could
    move it (its whole move where its gradient is noise, under 1e-3 of its
    tensor's max-abs); the ranks' parameters equal bit for bit after every
    step; then ``make_data_parallel_sample_fn`` for DP_SAMPLES images by
    euler-100 against one-process ``odeint`` of the same noise (DP_TOL of
    the largest value; the kernels plan other blocks at batch 128 than at
    256), and ``sharded_sinkhorn_plan`` at DP_SINKHORN against the dense
    Sinkhorn plan (1e-5 of its maximum). Times: ms a step and a gloo
    all-reduce of the gradients' size, through the host: not what NCCL
    across cards gives."""
    d = run_dir("dp_two_ranks")
    store, outs = os.path.join(d, "store"), [os.path.join(d, f"rank{r}.json") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dp-rank",
                               str(r), str(world), store, outs[r]], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=DP_BUDGET_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 33 rank {r} failed:\n{text[-6000:]}")
    res = []
    for o in outs:
        with open(o) as fh:
            res.append(json.load(fh))
    for i in range(DP_STEPS):
        for r in res:
            st = r["steps"][i]
            bad = [k for k in ("loss", "grad_norm")
                   if not abs(st[k] - st[f"oracle_{k}"]) <= DP_TOL * abs(st[f"oracle_{k}"])]
            if bad or not st["move"] <= DP_TOL * st["moved"] or not st["move_noise"] <= st["moved"]:
                raise AssertionError(f"phase 33 rank {r['rank']} step {i} against the oracle: "
                                     f"{st}")
        if len({r["steps"][i]["params_sha"] for r in res}) != 1:
            raise AssertionError(f"phase 33: the ranks' parameters differ after step {i}")
    r0 = res[0]
    if len({r["params_sha"] for r in res}) != 1 or r0["backend"] != "gloo":
        raise AssertionError("phase 33: the ranks' parameters differ after the timed steps")
    if not (r0["sample_finite"] and r0["sample_err"] <= DP_TOL and r0["sinkhorn_err"] <= 1e-5):
        raise AssertionError(f"phase 33: sampler {r0['sample_err']}, sinkhorn "
                             f"{r0['sinkhorn_err']}")
    for r in res:
        log(f"phase 33 rank {r['rank']} of {world} (gloo, one card): steps against the oracle " +
            "; ".join(f"loss {st['loss']:.5f}/{st['oracle_loss']:.5f}, grad norm "
                      f"{st['grad_norm']:.4f}/{st['oracle_grad_norm']:.4f}, largest move "
                      f"difference {st['move']:.2e} (noise {st['move_noise']:.2e}) of "
                      f"{st['moved']:.2e}, same bits as the oracle {st['same_bits']}"
                      for st in r["steps"]) +
            f"; {r['ms_per_step']:.1f} ms a step, a gloo all-reduce of the gradients "
            f"{r['all_reduce_ms']:.1f} ms (through the host, not NCCL); {DP_SAMPLES // world} "
            f"images by euler-100 in {r['sample_s']:.2f} s; sharded Sinkhorn "
            f"{r['sinkhorn_s']:.2f} s ({smi})")
    log(f"phase 33: the ranks' parameters equal bit for bit after every step; the sampler's "
        f"{DP_SAMPLES} images against one-process odeint {r0['sample_err']:.2e} of the largest "
        f"(same bits {r0['sample_same_bits']}); the sharded plan against the dense one "
        f"{r0['sinkhorn_err']:.2e} of its maximum")


# Phases 34-35: the examples and the notebooks.
EXAMPLES_BUDGET_S = 60.0  # phases 34-35 together; main fails above it
TRAIN_2D_W2_GATE = 0.9    # train_2d's OT-CFM at its defaults (the JAX example's gate)
TRAIN_2D_RUNS = ((["--matcher", "otcfm"], 2000),
                 (["--matcher", "sbcfm", "--sde", "--steps", "300"], 300),
                 (["--matcher", "icfm", "--ode-method", "dopri5", "--steps", "300"], 0))
TABULAR_ARGS = ["--n_t", "3", "--dup", "3", "--steps", "10"]


def has_sklearn():
    import importlib.util

    return importlib.util.find_spec("sklearn") is not None


def train_2d_runs(smi):
    """Phase 34: ``train_2d.main`` in this process on the card, as a user
    runs it: OT-CFM at its defaults (2000 steps at batch 256, one dense
    auction launch, #5, a step), W2 under TRAIN_2D_W2_GATE; SB-CFM with the
    score head and the SDE (300 steps, #5 a step); I-CFM with dopri5 (300
    steps, no coupling). Each evaluation is three tiled auction launches
    (#6: W1, W2 and the source's W2 at n = 2048); the counts must be
    exactly these. Then ``tabular_forest_flow.main``: where scikit-learn is
    not installed (the card's machine) it must raise ``ImportError`` naming
    it; where it is, its W2 must beat the noise baseline. Returns the
    counts of each run."""
    import torch
    from cfm_tpu_torch import tabular_forest_flow, train_2d

    t_phase = time.perf_counter()
    out = {}
    for argv, dense in TRAIN_2D_RUNS:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, text = captured(train_2d.main, argv)
        sec = time.perf_counter() - t0
        counts = read_counts()
        want = dict.fromkeys(counts, 0)
        want.update(auction=dense, auction_tiled=3)
        finite = all(math.isfinite(res[k]) for k in ("w1", "w2", "w2_src"))
        log(f"train_2d {' '.join(argv)}: {sec:.2f} s with the evaluation; W1 {res['w1']:.6f} "
            f"W2 {res['w2']:.6f} (source W2 {res['w2_src']:.6f}); launches {counts} ({smi})")
        if counts != want or not finite or not res["samples"].is_cuda:
            raise AssertionError(f"train_2d {argv}: launches {counts}, expected {want}; {res}")
        if argv[1] == "otcfm" and not res["w2"] < TRAIN_2D_W2_GATE:
            raise AssertionError(f"train_2d otcfm: W2 {res['w2']} not under {TRAIN_2D_W2_GATE}")
        out[f"train_2d {' '.join(argv)}"] = counts
    if has_sklearn():
        zero_counts()
        res, _ = captured(tabular_forest_flow.main, TABULAR_ARGS)
        if not res["w2"] < res["base"]:
            raise AssertionError(f"tabular_forest_flow: {res}")
        out["tabular_forest_flow"] = read_counts()
    else:
        try:
            tabular_forest_flow.main(TABULAR_ARGS)
        except ImportError as e:
            if "sklearn" not in str(e):
                raise
            log(f"tabular_forest_flow without scikit-learn: ImportError ({e})")
        else:
            raise AssertionError("tabular_forest_flow ran without scikit-learn")
    log(f"phase 34 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return out


def assignment_kernel(n):
    """The kernel of an n-point exact assignment on the card."""
    from cfm_tpu_torch.ops.assignment import resolve_solver

    return {"pallas": "auction", "pallas_tiled": "auction_tiled"}.get(
        resolve_solver(n=n, device="cuda"), "plain")


def notebook_launches(name, p):
    """The launches of the notebook ``name`` at the sizes ``p`` (its
    ``parameters`` cell's names), summed as its cells make them: a coupled
    step is one assignment at BATCH, a W1 or W2 one at the cloud's size; an
    MNIST UNet evaluation calls GroupNorm GN_PER_EVAL["mnist"] times, and a
    training step as many times backward."""
    from collections import Counter

    from cfm_tpu_torch.config import load_config

    c = Counter()
    solve = lambda n, k=1: c.update({assignment_kernel(n): k})  # noqa: E731
    gn_calls = GN_PER_EVAL["mnist"]
    if name == "flow_matching_tutorial.ipynb":   # OT-CFM and SB-CFM steps; 3 W2
        solve(p["BATCH"], 2 * p["STEPS"]), solve(p["N"], 3)
    elif name == "SF2M_tutorial.ipynb":          # SB-CFM steps; the ODE's and SDE's W2
        solve(p["BATCH"], p["STEPS"]), solve(p["N"], 2)
    elif name in ("conditional_mnist.ipynb", "mnist_example.ipynb"):
        evals = p["STEPS"] + p["GEN_STEPS"]
        if name == "mnist_example.ipynb":        # evaluate(): the preset's euler steps
            evals += load_config("mnist_otcfm").eval.ode_steps
        solve(p["BATCH"], p["STEPS"])
        c.update(gn_silu_fwd=gn_calls * evals, gn_silu_bwd=gn_calls * p["STEPS"])
    elif name == "minibatch_OT_study.ipynb":     # the plans, then OT-CFM's steps
        solve(p["BATCH"], p["PLANS"] + p["STEPS"])
    elif name == "model_comparison_plotting.ipynb":  # OT-CFM and SB-CFM steps; 5 W2
        solve(p["BATCH"], 2 * p["STEPS"]), solve(p["N"], 5)
    elif name == "single_cell_example.ipynb":    # steps; W1 and W2 of 4 timepoints; 4 plans
        solve(p["BATCH"], p["STEPS"]), solve(p["N_CELLS"], 12)
    elif name == "tabular_forest_flow.ipynb":    # W2 of the generated rows against iris's 150
        if p["M"] == 150:
            solve(150)
    counts = dict.fromkeys(kernel_fns(), 0)
    counts.update({k: v for k, v in c.items() if k != "plain"})
    return counts


def notebooks_on_card(smi):
    """Phase 35: every notebook of ``cfm_tpu_torch/notebooks/`` read as JSON,
    its code cells but the ``plot`` ones run in order in one fresh namespace
    (``gen_notebooks.execute``), the ``parameters`` cell set to the CPU
    test's sizes (``gen_notebooks.SMOKE``) with ``DEVICE = "cuda"``, the
    MNIST runs writing under ``build/smoke_runs``. Each notebook's launches
    are counted from 0 and must equal ``notebook_launches``; the Forest-Flow
    notebook must raise scikit-learn's ``ImportError`` where it is not
    installed. Returns the summed counts."""
    import torch
    from cfm_tpu_torch import gen_notebooks as gn

    t_phase = time.perf_counter()
    total = dict.fromkeys(kernel_fns(), 0)
    for name in gn.NOTEBOOKS:
        params = dict(gn.SMOKE[name], DEVICE="cuda", RESULTS=run_dir(f"nb_{name[:-6]}"))
        path = os.path.join(gn.OUT, name)
        if name == "tabular_forest_flow.ipynb" and not has_sklearn():
            try:
                gn.execute(path, params)
            except ImportError as e:
                if "sklearn" not in str(e):
                    raise
                log(f"notebook {name}: ImportError without scikit-learn ({e})")
                continue
            raise AssertionError(f"{name} ran without scikit-learn")
        zero_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gn.execute(path, params)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts, want = read_counts(), notebook_launches(name, params)
        last = buf.getvalue().strip().splitlines()[-1:] or [""]
        log(f"notebook {name} at {gn.SMOKE[name]}: {sec:.2f} s, launches {counts}; its last "
            f"line: {last[0]}")
        if counts != want:
            raise AssertionError(f"notebook {name}: launches {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
    log(f"phase 35 in {time.perf_counter() - t_phase:.1f} s ({smi})")
    return total


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
    # Phase 24 runs here, so that scipy's check of its plans, a minute a
    # solve on the host, overlaps phase 3's untimed checks.
    with scipy_pool() as pool:
        joint, joint_launches, joint_w2, check_joint_plans = single_cell_joint_plans(smi, pool)
        tiled_plain_s = check_auction_tiled()
        check_joint_plans()
    gn_paths = record_gn_shapes(imagenet)
    err_gn = check_gn(gn_paths)
    for extra in (check_gn_diffeq(), check_gn_diffeq(6), check_gn_beyond()):
        err_gn = {k: max(v, extra[k]) for k, v in err_gn.items()}
    err_flash = check_flash_sinkhorn()
    time_attn_block(GEN_BATCH)
    time_attn_block(IMAGENET_BATCH, S=64, C=768, H=12)
    timing = time_attn_block(TRAIN_BATCH)
    timing_bwd = time_attn_block_bwd()
    time_attn_block_bwd(IMAGENET_BATCH, S=64, C=768, H=12)
    timing_attn = time_attention()
    timing_attn_long = time_attention(ATTN_SHAPES[3])
    timing_auction = time_auction()
    timing_tiled = time_auction_tiled(tiled_plain_s)
    timing_gn = time_gn(gn_paths)
    time_gn_beyond(smi)
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
    cifar_per_step = dict(auction=1, attn_block_fwd=5, attn_block_bwd=5,
                          gn_silu_fwd=GN_PER_EVAL["cifar10"], gn_silu_bwd=GN_PER_EVAL["cifar10"])
    launches["cifar10 training"], trainer, ms_per_step = training_path(
        "cifar10_otcfm", "build/no_cifar10", cifar_per_step)
    cifar_ms_per_step = ms_per_step
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
    launches["presets as given"] = presets_as_given(cifar_per_step, smi)
    sde_trainer, sde_launches = mnist_sde(smi)
    launches.update(sde_launches)
    launches["2d_sf2m eval.sde"] = sf2m_sde(smi)
    launches.update(checkpointing(imagenet, smi))
    launches["tsit5 generation"] = tsit5_generation(main_path.dopri5, smi)
    launches["adjoint"] = adjoint_gradients(sde_trainer, smi)
    launches.update(single_cell_synthetic(smi))
    launches["single_cell joint plans"] = joint_launches
    launches["spline cfm"] = spline_and_interpolation(joint, joint_w2, smi)
    grn_models(smi)
    t_variants = time.perf_counter()
    variant_errs = cnf_maximum_likelihood(smi)
    launches["ot study"] = ot_study(smi)
    launches["bridges"] = bridges(smi)
    launches["action matching and icnn"] = action_and_icnn(smi)
    launches["diffeq zoo"] = diffeq_zoo(smi)
    sec = time.perf_counter() - t_variants
    log(f"phases 27-31 in {sec:.1f} s (budget {VARIANT_BUDGET_S} s); CNF card vs CPU worst "
        f"{variant_errs}")
    if sec > VARIANT_BUDGET_S:
        raise AssertionError(f"phases 27-31 took {sec:.1f} s, above {VARIANT_BUDGET_S} s")
    t_dp = time.perf_counter()
    launches["data parallel, one rank"] = data_parallel_one_rank(cifar_per_step,
                                                                 cifar_ms_per_step, smi)
    data_parallel_two_ranks(smi)
    sec = time.perf_counter() - t_dp
    log(f"phases 32-33 in {sec:.1f} s (budget {DP_BUDGET_S} s)")
    if sec > DP_BUDGET_S:
        raise AssertionError(f"phases 32-33 took {sec:.1f} s, above {DP_BUDGET_S} s")
    t_examples = time.perf_counter()
    launches.update(train_2d_runs(smi))
    launches["notebooks"] = notebooks_on_card(smi)
    sec = time.perf_counter() - t_examples
    log(f"phases 34-35 in {sec:.1f} s (budget {EXAMPLES_BUDGET_S} s)")
    if sec > EXAMPLES_BUDGET_S:
        raise AssertionError(f"phases 34-35 took {sec:.1f} s, above {EXAMPLES_BUDGET_S} s")
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
             **timing_attn["attention_fwd"], at_32x32=timing_attn_long["attention_fwd"]),
        dict(name="attention_bwd", route="cuda", source=src + "attention_bwd.cu",
             replaces="cfm_tpu/ops/pallas_attention.py:90", max_abs_err=err_attn["bwd"],
             **timing_attn["attention_bwd"], at_32x32=timing_attn_long["attention_bwd"]),
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
            "bound_ms", "bound_by", "library_ms", "at_32x32")
    for k in kernels:
        k["launches"] = total[k["name"]]
    kernels = [{key: k[key] for key in keys if key in k} for k in kernels]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.path.insert(0, ROOT)
        data_parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
