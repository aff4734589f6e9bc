"""Single-cell trajectory interpolation with OT-CFM (counterpart of
``examples/single_cell.py``, TorchCFM's single-cell tutorial).

Interpolates between the timepoints of a single-cell time series (an h5ad
with ``obsm/X_pca`` and ``obs/day``, or an npz of ``pcs`` and
``sample_labels``; with ``--synthetic`` the tree population, 5 timepoints in
2-D) and evaluates each timepoint's marginal with the W1/W2 and moment
suite, a held-out timepoint included:

    python -m cfm_tpu_torch.single_cell --synthetic --steps 1000
    python -m cfm_tpu_torch.single_cell --h5ad eb.h5ad --leaveout 2
    python -m cfm_tpu_torch.single_cell --synthetic --joint-plans --leaveout 2

A step resamples a (batch, T, dim) population, draws each sample's segment
(skipping the left-out timepoint, the segment into it straddling to the
next), OT-couples each pair (exact; on the card the dense auction kernel,
one launch a step at batch 256), regresses the segment's velocity with the
MLP seeing global time t + t_select, and takes Adam and EMA steps. With
``--joint-plans`` the pairs come from plans solved once up front instead
(read from the h5ad's ``uns``, or in synthetic mode exact plans of the whole
marginals: at 4096 points the tiled auction kernel), and no step solves.
The evaluation rolls the EMA model from the first marginal across every
segment by rk4 (50 steps a segment) on min(1000, smallest marginal) points.

Runs on ``cuda`` unless ``--device cpu`` is given; with no card it raises.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cfm_tpu_torch.coupling import OTPlanSampler
from cfm_tpu_torch.data.trajectory import (leaveout_adjusted_targets, load_h5ad_joint_plans,
                                           load_h5ad_timeseries, load_npz_timeseries,
                                           make_joint_plan_sampler, resample_to_trajectory,
                                           sample_segment_pairs, tree_population, whiten)
from cfm_tpu_torch.device import resolve_device
from cfm_tpu_torch.eval.metrics import compute_distribution_distances
from cfm_tpu_torch.integrate import odeint
from cfm_tpu_torch.models.mlp import MLP
from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
from cfm_tpu_torch.train import init_train_state, make_optimizer
from cfm_tpu_torch.utils import ema_update

EMA_DECAY = 0.99
EVAL_POINTS = 1000       # points a timepoint in the evaluation, at most
EVAL_STEPS = 50          # rk4 steps a segment


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--h5ad", default=None)
    p.add_argument("--npz", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n", type=int, default=4096, help="synthetic population size per timepoint")
    p.add_argument("--dim", type=int, default=5, help="PCA dims to keep")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--leaveout", type=int, default=-1)
    p.add_argument("--sigma", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--joint-plans", action="store_true",
                   help="train from PRECOMPUTED per-segment OT plans (adata.uns['pi_{t}_{t+1}'] "
                        "from --h5ad, or exact plans solved once up front in synthetic mode) "
                        "instead of re-solving OT per batch")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p


@dataclasses.dataclass
class TrajectoryDraws:
    """The random numbers of one step, each drawn from the run's generator
    when None: ``t_draw`` (batch,) the raw segment draws; ``plan_u`` (batch,)
    the plan-sampling uniforms of the per-batch OT coupling; ``rows`` (a row
    index draw for each segment, by its start) and ``u`` (batch,) the joint
    plans' draws; ``t`` (batch,) and ``eps`` (batch, dim) the path's."""

    t_draw: Optional[torch.Tensor] = None
    plan_u: Optional[torch.Tensor] = None
    rows: Optional[Dict[int, torch.Tensor]] = None
    u: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None


def _load(args, generator: torch.Generator) -> List:
    """The marginals: the file's, whitened, or the synthetic tree population's."""
    if args.h5ad:
        return whiten(load_h5ad_timeseries(args.h5ad, max_dim=args.dim)[0])[0]
    if args.npz:
        return whiten(load_npz_timeseries(args.npz, max_dim=args.dim)[0])[0]
    X = tree_population(generator, args.n, T=5, dim=2)
    return [X[:, t] for t in range(5)]


class SingleCell:
    """One run of the tutorial: the data, the model, its optimizer and EMA.
    ``plan_seconds`` is the time to solve or read the joint plans and build
    their CDFs (0 without them)."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = resolve_device(args.device)
        self.generator = torch.Generator(device=self.device).manual_seed(args.seed)
        self.marginals = [torch.as_tensor(m, dtype=torch.float32, device=self.device)
                          for m in _load(args, self.generator)]
        self.T, self.dim = len(self.marginals), self.marginals[0].shape[1]
        print(f"{self.T} timepoints, dim {self.dim}, sizes "
              f"{[m.shape[0] for m in self.marginals]}")
        self.plan_sample, self.plan_seconds = None, 0.0
        if args.joint_plans:
            self._joint_plans()
        matcher = ExactOptimalTransportConditionalFlowMatcher(sigma=args.sigma)
        # With precomputed plans the pairs are already coupled.
        self.matcher = matcher.without_coupling() if self.plan_sample is not None else matcher
        self.model = MLP(self.dim, w=64, seed=args.seed, device=self.device)
        self.ema_model = copy.deepcopy(self.model)
        self.optimizer = make_optimizer(lr=1e-3, warmup_steps=0)
        self.state = init_train_state(self.model, self.optimizer)

    def _joint_plans(self) -> None:
        args, T = self.args, self.T
        t0 = time.perf_counter()
        if args.h5ad:
            plans, straddle = load_h5ad_joint_plans(args.h5ad, T, leaveout=args.leaveout > 0)
        else:
            solver, m = OTPlanSampler(method="exact"), self.marginals
            plans = [solver.get_map(m[t], m[t + 1]) for t in range(T - 1)]
            straddle = ([solver.get_map(m[t], m[t + 2]) for t in range(T - 2)]
                        if args.leaveout > 0 else None)
            print("solved", len(plans), "joint plans up front (synthetic mode)")
        self.plans, self.straddle_plans = plans, straddle
        self.plan_sample = make_joint_plan_sampler(self.marginals, plans,
                                                   leaveout_timepoint=args.leaveout,
                                                   straddle_plans=straddle)
        self.plan_seconds = time.perf_counter() - t0

    def batch(self) -> Optional[torch.Tensor]:
        """A resampled (batch, T, dim) population, or None with joint plans."""
        if self.plan_sample is not None:
            return None
        return resample_to_trajectory(self.generator, self.marginals, self.args.batch)

    def step(self, X: Optional[torch.Tensor], draws: Optional[TrajectoryDraws] = None
             ) -> torch.Tensor:
        """One training step on the population batch X; returns the loss, a
        0-d device tensor (no host read)."""
        d, g, leave = draws or TrajectoryDraws(), self.generator, self.args.leaveout
        if self.plan_sample is not None:
            x0, x1, t_sel = self.plan_sample(g, self.args.batch, t_draw=d.t_draw, rows=d.rows,
                                             u=d.u)
        else:
            x0, x1, t_sel = sample_segment_pairs(g, X, leaveout_timepoint=leave, training=True,
                                                 t_draw=d.t_draw)
        t, xt, ut = self.matcher.sample_location_and_conditional_flow(
            g, x0, x1, t=d.t, eps=d.eps, plan_noise=d.plan_u)
        ut, t = leaveout_adjusted_targets(ut, t, t_sel, leave)
        loss = torch.mean(torch.square(self.model(t + t_sel, xt) - ut))
        params = self.state.params
        for p in params:
            p.grad = None
        loss.backward()
        self.optimizer.apply(params, [p.grad for p in params], self.state.opt_state)
        ema_update(self.state.ema_params, params, EMA_DECAY)
        self.state.step += 1
        return loss.detach()

    def fit(self, steps: int) -> None:
        """``steps`` steps, printing the loss ten times (a host read each)."""
        for i in range(steps):
            loss = self.step(self.batch())
            if i % max(1, steps // 10) == 0:
                print(f"step {i:5d}  loss {float(loss):.4f}")

    @torch.no_grad()
    def rollout(self) -> List[torch.Tensor]:
        """The EMA model rolled by rk4 from the first marginal's first
        min(1000, smallest marginal) points through every segment: the
        predicted marginals at timepoints 1 .. T - 1."""
        for e, p in zip(self.state.ema_params, self.ema_model.parameters()):
            p.copy_(e)
        n_eval = min(EVAL_POINTS, min(m.shape[0] for m in self.marginals))

        def f(t, x):
            return self.ema_model(torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device), x)

        x, preds = self.marginals[0][:n_eval], []
        for seg in range(self.T - 1):
            ts = torch.linspace(float(seg), float(seg + 1), EVAL_STEPS + 1)
            x = odeint(f, x, ts, method="rk4", return_trajectory=False).final
            preds.append(x)
        return preds

    def evaluate(self) -> Tuple[List[str], List[float]]:
        """The distribution distances of the rollout's marginals against the
        data's (each timepoint's first points), and the held-out timepoint's
        W2; prints them as the example does."""
        preds = self.rollout()
        trues = [m[:preds[0].shape[0]] for m in self.marginals[1:]]
        names, vals = compute_distribution_distances(preds, trues)
        for n, v in zip(names[-8:], vals[-8:]):
            print(f"  {n}: {v:.4f}")
        if self.args.leaveout > 0:
            w2 = (vals[names.index(f"t{self.args.leaveout}/2-Wasserstein")]
                  if self.T > 2 else None)
            print(f"held-out timepoint {self.args.leaveout} W2: {w2}")
        return names, vals


def run(argv: Optional[Sequence[str]] = None) -> SingleCell:
    """Parse ``argv``, train and evaluate; returns the run, with
    ``train_seconds``, ``eval_seconds``, ``names`` and ``values`` set."""
    args = build_parser().parse_args(argv)
    sc = SingleCell(args)
    t0 = time.perf_counter()
    sc.fit(args.steps)
    if sc.device.type == "cuda":
        torch.cuda.synchronize(sc.device)
    sc.train_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc.names, sc.values = sc.evaluate()
    sc.eval_seconds = time.perf_counter() - t0
    return sc


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
