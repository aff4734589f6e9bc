"""2-D flow matching end to end on one card: 8 Gaussians -> moons
(counterpart of ``examples/train_2d.py``).

Trains any matcher with a 3x64 SELU MLP (with ``--sde`` a second MLP as
the score head, [SF]2M), generates 2048 points from the EMA parameters by
the ODE (``--ode-method`` over 101 grid points) or by the SDE of both heads,
and prints W1 and W2 to 2048 fresh moons points and the source's W2 in the
JAX example's line format.

On the card the OT-CFM and SB-CFM couplings solve their batch's assignment
with the dense auction kernel (#5, ``csrc/auction.cu``) once a step, and
the evaluation's three W1/W2 solves at n = 2048 take the tiled auction
kernel (#6, ``csrc/auction_tiled.cu``). With ``--device cpu`` the same
code runs their plain versions (scipy's solver for the assignments).

Usage:
  python -m cfm_tpu_torch.train_2d --matcher otcfm --steps 2000 --batch 256
  python -m cfm_tpu_torch.train_2d --matcher sbcfm --sde   # SF2M-style score head
  python -m cfm_tpu_torch.train_2d --device cpu --steps 200
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.data.toy import eight_gaussians, sample_moons
from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.integrate import FlowSolver, odeint, vector_field_from_model
from cfm_tpu_torch.models.mlp import MLP
from cfm_tpu_torch.paths import (ConditionalFlowMatcher, ExactOptimalTransportConditionalFlowMatcher,
                                 SchrodingerBridgeConditionalFlowMatcher,
                                 TargetConditionalFlowMatcher,
                                 VariancePreservingConditionalFlowMatcher)
from cfm_tpu_torch.train import (StepDraws, TrainState, ema_module, init_train_state,
                                 make_optimizer, make_train_step)

MATCHERS = {
    "icfm": lambda sigma: ConditionalFlowMatcher(sigma=sigma),
    "otcfm": lambda sigma: ExactOptimalTransportConditionalFlowMatcher(sigma=sigma),
    "fm": lambda sigma: TargetConditionalFlowMatcher(sigma=sigma),
    "sbcfm": lambda sigma: SchrodingerBridgeConditionalFlowMatcher(sigma=max(sigma, 0.1)),
    "vpcfm": lambda sigma: VariancePreservingConditionalFlowMatcher(sigma=sigma),
}
ODE_METHODS = ("euler", "midpoint", "rk4", "dopri5")
N_EVAL = 2048      # generated points, and the fresh target points they are held to
EVAL_GRID = 101    # points of the [0, 1] time grid


@dataclasses.dataclass
class Run:
    """The flow head (and with [SF]2M the score head), their train state and step."""

    model: MLP
    score_model: Optional[MLP]
    state: TrainState
    step: Callable
    device: torch.device


def build(matcher, lr: float = 2e-3, seed: int = 0, sde: bool = False,
          device: DeviceLike = None) -> Run:
    """The example's heads and step: ``MLP(dim=2, w=64)`` from ``seed`` (the
    score head from ``seed + 1``, as JAX folds 1 into the flow head's init
    key), Adam at ``lr`` with no warmup, clip 1.0, EMA 0.99."""
    device = resolve_device(device)
    model = MLP(dim=2, w=64, seed=seed, device=device)
    score_model = MLP(dim=2, w=64, seed=seed + 1, device=device) if sde else None
    opt = make_optimizer(lr=lr, warmup_steps=0, grad_clip=1.0)
    state = init_train_state(model, opt, score_model)
    step = make_train_step(matcher, model, opt, ema_decay=0.99, score_model=score_model)
    return Run(model, score_model, state, step, device)


def train(run: Run, steps: int, batch: int, generator: torch.Generator,
          batches: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
          draws: Optional[Sequence[StepDraws]] = None) -> Dict[str, torch.Tensor]:
    """``steps`` steps on 8-Gaussians -> moons minibatches of ``batch``
    points drawn from ``generator``, or on the given per-step ``batches``
    (x0, x1) with the given per-step ``draws``; the loss printed ten times.
    Returns the last step's metrics."""
    every = max(1, steps // 10)
    metrics = {}
    for i in range(steps):
        if batches is None:
            x0 = eight_gaussians(generator, batch, run.device)
            x1 = sample_moons(generator, batch, run.device)
        else:
            x0, x1 = batches[i]
        metrics = run.step(run.state, x0, x1, generator=generator,
                           draws=None if draws is None else draws[i])
        if i % every == 0:
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}")
    return metrics


def ema_heads(run: Run) -> Tuple[MLP, Optional[MLP]]:
    """Copies of the flow and score heads holding the EMA parameters."""
    ema = run.state.ema_params
    n = len(list(run.model.parameters()))
    score = None if run.score_model is None else ema_module(run.score_model, ema[n:])
    return ema_module(run.model, ema), score


def generate(run: Run, x0: torch.Tensor, sigma: float = 0.1, sde: bool = False,
             ode_method: str = "euler", generator: Optional[torch.Generator] = None,
             noise: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, str]:
    """Points generated from ``x0`` by the EMA parameters over EVAL_GRID
    points of [0, 1]: by the ODE with ``ode_method``, or with ``sde`` by the
    SDE of both heads at ``sigma`` (0.1 where it is 0), its normals drawn
    from ``generator`` or given as ``noise``. Returns them and the label of
    the printed line."""
    ts = np.linspace(0.0, 1.0, EVAL_GRID, dtype=np.float32)
    flow, score = ema_heads(run)
    f = vector_field_from_model(flow)
    with torch.inference_mode():
        if sde:
            solver = FlowSolver(drift=f, score=vector_field_from_model(score),
                                sigma=sigma if sigma > 0 else 0.1)
            sol = solver.sdeint(None if noise is not None else generator, x0, ts,
                                return_trajectory=False, noise=noise)
            return sol.final, "SDE"
        sol = odeint(f, x0, ts, method=ode_method, return_trajectory=False)
    return sol.final, f"ODE/{ode_method} (nfe {int(sol.nfe)})"


def evaluate(run: Run, generator: torch.Generator, sigma: float = 0.1, sde: bool = False,
             ode_method: str = "euler") -> Dict:
    """N_EVAL points generated (:func:`generate`) from 8 Gaussians drawn from
    ``generator``, held to N_EVAL fresh moons points drawn after them: W1,
    W2 and the source's W2 (floats), the printed line's label and the
    samples."""
    x0 = eight_gaussians(generator, N_EVAL, run.device)
    target = sample_moons(generator, N_EVAL, run.device)
    gen, label = generate(run, x0, sigma, sde, ode_method, generator)
    return {"w1": float(wasserstein(gen, target, power=1)),
            "w2": float(wasserstein(gen, target, power=2)),
            "w2_src": float(wasserstein(x0, target, power=2)), "label": label, "samples": gen}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("--matcher", default="otcfm", choices=sorted(MATCHERS))
    p.add_argument("--sigma", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sde", action="store_true",
                   help="train a score head too and sample via SDE (SF2M)")
    p.add_argument("--ode-method", default="euler", choices=list(ODE_METHODS))
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    run = build(MATCHERS[args.matcher](args.sigma), args.lr, args.seed, args.sde, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    train(run, args.steps, args.batch, generator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {dt:.1f}s ({args.steps / dt:.1f} steps/s)")

    out = evaluate(run, generator, args.sigma, args.sde, args.ode_method)
    print(f"[{args.matcher}] {out['label']}: 2-moons W1={out['w1']:.3f} W2={out['w2']:.3f} "
          f"(source W2={out['w2_src']:.3f})")
    return out


if __name__ == "__main__":
    main()
