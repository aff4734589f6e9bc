"""Training traffic: the program's class-conditional exact OT-CFM step,
closed loop, one step after another with no host read between them.

Traffic keys (``workloads/<cell>.json``): ``batch`` (rows a card),
``checked_steps`` (the first steps, which the reference follows),
``warmup_steps`` (further steps before the window), ``block`` (rows the
reference computes at once) and ``trace_steps`` (steps traced in a
``--trace 1`` run), ``limits`` (the numbers compared and their limits).

Every input is drawn on the card from the run's seed: a step's global
batch (uint8 images scaled to [-1, 1], labels, noise x0, the plan's
uniforms) is the same on every rank; each rank draws its own times and
dropout stream. Set-up builds one train step, drives it through its first
``checked_steps`` steps, reads from its state what the reference will be
held to, warms up, and hands that same step to the window. On four cards
the ranks run the data-parallel step (one process a card, NCCL).
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from typing import Dict

import torch

from cfmbench import harness
from cfmbench.harness import Check, derive_seed
from cfmbench.program import build_model
from cfmbench.reference import train as reference
from cfmbench.weights import make_weights


def global_batch(run, k: int):
    """x0, x1, y, u of step ``k``: the global batch, alike on every rank."""
    arch, b = run.cell.config["model"], run.cell.traffic["batch"]
    n = b * run.world
    h, w, c = arch["dim"]
    g = torch.Generator(device=run.device).manual_seed(derive_seed(run.seed, 1, k))
    x1 = torch.randint(0, 256, (n, h, w, c), generator=g, device=run.device,
                       dtype=torch.uint8).float() / 127.5 - 1.0
    y = torch.randint(0, arch.get("num_classes", 1), (n,), generator=g, device=run.device)
    x0 = torch.randn((n, h, w, c), generator=g, device=run.device)
    u = torch.rand(n, generator=g, device=run.device)
    return x0, x1, y, u


def rank_draws(run, k: int, rank: int):
    """t, eps and the dropout seed of ``rank``'s rows at step ``k``."""
    arch, b = run.cell.config["model"], run.cell.traffic["batch"]
    g = torch.Generator(device=run.device).manual_seed(derive_seed(run.seed, 2, k, rank))
    t = torch.rand(b, generator=g, device=run.device)
    eps = torch.randn((b,) + tuple(arch["dim"]), generator=g, device=run.device)
    return t, eps, derive_seed(run.seed, 3, k, rank)


class Program:
    """The program's train step as the window drives it: the model, its
    train state and the step, built once."""

    def __init__(self, run, model):
        from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
        from cfm_tpu_torch.train import (StepDraws, init_train_state,
                                         make_data_parallel_train_step, make_mesh,
                                         make_optimizer, make_train_step)

        cfg = run.cell.config
        o = cfg["optimizer"]
        opt = make_optimizer(lr=o["lr"], warmup_steps=o["warmup_steps"],
                             grad_clip=o["grad_clip"], b1=o["b1"], b2=o["b2"])
        self.run, self.model, self.b1 = run, model, o["b1"]
        self.state = init_train_state(model, opt)
        self.names = [n for n, _ in model.named_parameters()]
        matcher = ExactOptimalTransportConditionalFlowMatcher()
        kw = dict(ema_decay=o["ema_decay"], train_mode=cfg["model"].get("dropout", 0) > 0,
                  class_conditional=True)
        self.draws = StepDraws
        if run.distributed:
            self.dp = make_data_parallel_train_step(matcher, model, opt, make_mesh(run.world),
                                                    **kw)
        else:
            self.single = make_train_step(matcher, model, opt, **kw)

    def step(self, k: int) -> torch.Tensor:
        """Step ``k`` through the program's call; returns its loss (on the card)."""
        run = self.run
        x0, x1, y, u = global_batch(run, k)
        t, eps, dseed = rank_draws(run, k, run.rank)
        gen = torch.Generator(device=run.device).manual_seed(dseed)
        if run.distributed:
            loss = self.dp(self.state, x0, x1, y, y, draws=self.draws(t, eps, dropout=gen),
                           plan_noise=u)["loss"]
        else:
            loss = self.single(self.state, x0, x1, y, y, draws=self.draws(t, eps, u, gen))["loss"]
        # A copy: the data-parallel step's metrics are views of its flat
        # all-reduce buffer, which a kept view would hold (1.18 GB a step).
        return loss.clone()

    def checked_steps(self, steps: int, mark=lambda phase: None) -> reference.Readings:
        """Steps 0 .. ``steps`` - 1, and what the reference is held to: each
        loss, the first gradient as the optimizer got it (its first moment
        over 1 - b1 after one step), and the change of each parameter and of
        its EMA after the last, read before a later step runs. Rank 0 keeps
        the changes (on the host); the ranks hold the same state. ``mark``
        notes the ends of set-up's phases."""
        run, state, cfg = self.run, self.state, self.run.cell.config
        losses = []
        for k in range(steps):
            losses.append(self.step(k))
            if k == 0:
                grad_norms = torch.stack(torch._foreach_norm(state.opt_state.mu)) / (1.0 - self.b1)
                mark("first step")
        mark("steps")
        start = make_weights(cfg["model"], cfg["weights_seed"], run.device)
        keep = run.rank == 0
        with torch.no_grad():
            change = {n: (p - start[n]).cpu() for n, p in zip(self.names, state.params) if keep}
            ema = {n: (e - start[n]).cpu() for n, e in zip(self.names, state.ema_params) if keep}
        return reference.Readings([float(v) for v in losses],
                                  dict(zip(self.names, grad_norms.tolist())), change, ema)


def reference_readings(run, quant=None) -> reference.Readings:
    """The plain reference over the checked steps (``quant``: the control)."""
    cfg, traffic = run.cell.config, run.cell.traffic
    with harness.strict_f32():
        return reference.run(cfg["model"], cfg["optimizer"],
                             make_weights(cfg["model"], cfg["weights_seed"], run.device),
                             lambda k: _step_inputs(run, k), traffic["checked_steps"],
                             traffic["block"], quant)


def drive(run) -> Dict:
    traffic = run.cell.traffic
    model = build_model(run)
    run.mark("model")
    prog = Program(run, model)
    run.apply_fault(model)
    run.mark("train step")
    step = prog.step
    checked = traffic["checked_steps"]
    program = prog.checked_steps(checked, run.mark)
    run.mark("checked steps")
    # Warm-up, timed to size a four-card window.
    k = checked
    for _ in range(traffic["warmup_steps"]):
        step(k)
        k += 1
    run.sync()
    t0 = time.perf_counter()
    for _ in range(2):
        step(k)
        k += 1
    run.sync()
    step_s = (time.perf_counter() - t0) / 2
    planned = run.agree(max(1, math.ceil(run.seconds / step_s))) if run.distributed else None
    run.sync()
    setup_peak = run.peak_bytes()
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    # The window.
    tracer = run.tracer(model, traffic["trace_steps"])
    events, losses = [], []
    window_start = run.window_start()
    deadline = window_start + run.seconds
    i = 0
    while (i < planned) if planned is not None else (time.perf_counter() < deadline or i == 0):
        if tracer is not None:
            tracer.advance(i)
        events.append(run.event())
        with tracer.step(i) if tracer is not None else contextlib.nullcontext():
            losses.append(step(k))
        i += 1
        k += 1
    events.append(run.event())
    if tracer is not None:
        tracer.finish(i)
    run.sync()
    window_s = time.perf_counter() - window_start
    steps = i
    traced = tracer.reduce() if tracer is not None else None
    step_ms = run.gather_max(run.event_times(events))
    if run.rank == 0:
        print(f"window: {steps} steps in {window_s:.3f} s; step ms (slowest rank) median "
              f"{harness.percentile(step_ms, 50):.2f}, p10 {harness.percentile(step_ms, 10):.2f}, "
              f"p90 {harness.percentile(step_ms, 90):.2f}, max {max(step_ms):.2f}; set-up "
              f"{run.setup_s:.2f} s", file=sys.stderr)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    if traced is not None:
        out_busy = run.gather_mean(traced.busy_s), run.gather_mean(traced.window_s)
    peak = max(setup_peak, run.peak_bytes())
    images = steps * traffic["batch"] * run.world
    out = {
        "attempted": steps, "failed": failed, "peak_bytes": run.gather_peak(peak),
        "window_peak_bytes": run.peak_bytes(),
        "e2e": {"train_images_per_s": images / window_s,
                "train_step_ms_p90": harness.percentile(step_ms, 90)},
        "trace": traced, "images_per_s": images / window_s,
    }
    if traced is not None:
        out["busy_s"], out["trace_window_s"] = out_busy
    # Free the program's state before the reference runs.
    del prog, step, model, losses, events
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    run.finish_ranks()
    if run.rank != 0:
        return out
    t0 = time.perf_counter()
    gaps = reference.compare(program, reference_readings(run))
    print(f"reference: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    out["checks"] = [Check(name, gaps[name], limit)
                     for name, limit in traffic["limits"].items()]
    return out


def _step_inputs(run, k: int) -> reference.StepInputs:
    x0, x1, y, u = global_batch(run, k)
    ts, seeds = [], []
    for r in range(run.world):
        t, _, seed = rank_draws(run, k, r)
        ts.append(t)
        seeds.append(seed)
    return reference.StepInputs(x0, x1, y, u, ts, seeds)
