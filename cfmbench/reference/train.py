"""The plain reference of the class-conditional exact OT-CFM training step.

For each step, from the inputs the harness made (the global batch x0, x1,
labels y, the plan uniforms u; each rank's times t and dropout seed):

- the exact assignment of the squared-Euclidean cost, in float64, by
  scipy's Hungarian solver;
- the plan's pairs drawn with replacement by inverse CDF: row i = floor(u n),
  its partner perm[i]; the labels ride with x1, as y0 = y1;
- x_t = t x1 + (1 - t) x0, u_t = x1 - x0 (sigma 0);
- loss = mean((v(t, x_t, y) - u_t)^2) over the global batch, in float32,
  each rank's rows with that rank's dropout masks, computed in blocks of
  rows with the gradients summed;
- the global-norm clip, Adam (bias-corrected, eps outside the square root)
  at a constant learning rate, and the EMA.

The readings: each step's loss, each parameter's norm of the first step's
clipped gradient, and each parameter's and EMA's change over the steps.
Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cfmbench.reference.unet import Dropout, RefUNet


@dataclasses.dataclass
class StepInputs:
    x0: torch.Tensor       # (G, H, W, C) global batch
    x1: torch.Tensor
    y: torch.Tensor        # (G,) labels
    u: torch.Tensor        # (G,) plan uniforms
    t: List[torch.Tensor]  # per rank (b,)
    dropout_seeds: List[int]


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]           # first step's clipped gradient, per parameter
    change: Dict[str, torch.Tensor]        # p_after - p_before, per parameter
    ema_change: Dict[str, torch.Tensor]    # ema_after - ema_before
    first_grad: Optional[Dict[str, torch.Tensor]] = None  # the reference's, element-wise


def assignment(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """The optimal permutation of the squared-Euclidean cost (float64)."""
    from scipy.optimize import linear_sum_assignment

    a = x0.reshape(x0.shape[0], -1).double()
    b = x1.reshape(x1.shape[0], -1).double()
    cost = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    rows, cols = linear_sum_assignment(cost.cpu().numpy())
    perm = np.empty(len(rows), dtype=np.int64)
    perm[rows] = cols
    return torch.from_numpy(perm).to(x0.device)


def run(arch: Dict, opt: Dict, weights: Dict[str, torch.Tensor],
        inputs: Callable[[int], StepInputs], steps: int, block: int,
        quant: Optional[str] = None) -> Readings:
    """``steps`` reference steps from ``weights`` (consumed: the model's
    parameters start as them), ``block`` rows at a time."""
    device = next(iter(weights.values())).device
    model = RefUNet(arch, quant).to(device)
    model.load_state_dict(weights)
    del weights
    named = list(model.named_parameters())
    params = [p for _, p in named]
    start = [p.detach().clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    ema = [p.detach().clone() for p in params]
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    losses, grad_norms = [], {}
    for k in range(steps):
        inp = inputs(k)
        n = inp.x0.shape[0]
        perm = assignment(inp.x0, inp.x1)
        i = torch.clamp(torch.floor(inp.u.double() * n).long(), 0, n - 1)
        x0, x1, y = inp.x0[i], inp.x1[perm[i]], inp.y[perm[i]]
        ranks = len(inp.t)
        rows = n // ranks
        for p in params:
            p.grad = None
        total = 0.0
        for r in range(ranks):
            for a in range(0, rows, block):
                sl = slice(r * rows + a, r * rows + min(a + block, rows))
                t = inp.t[r][a:a + block]
                tt = t.reshape(-1, 1, 1, 1)
                xt = tt * x1[sl] + (1 - tt) * x0[sl]
                ut = x1[sl] - x0[sl]
                drop = (Dropout(inp.dropout_seeds[r], device, rows, slice(a, a + block),
                                model.rate) if model.rate > 0 else None)
                v = model(t, xt, y[sl], dropout=drop)
                loss = torch.square(v - ut).sum() / (n * ut[0].numel())
                loss.backward()
                total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = [p.grad for p in params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            factor = 1.0 if float(norm) < opt["grad_clip"] else opt["grad_clip"] / float(norm)
            grads = [g * factor for g in grads]
            if k == 0:
                grad_norms = {name: float(torch.linalg.vector_norm(g))
                              for (name, _), g in zip(named, grads)}
                first = {name: g.clone() for (name, _), g in zip(named, grads)}
            c1, c2 = 1.0 - b1 ** (k + 1), 1.0 - b2 ** (k + 1)
            for p, g, m, s, e in zip(params, grads, mu, nu, ema):
                m.mul_(b1).add_(g, alpha=1 - b1)
                s.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * (m / c1) / (torch.sqrt(s / c2) + eps))
                e.mul_(opt["ema_decay"]).add_(p, alpha=1 - opt["ema_decay"])
    with torch.no_grad():
        change = {name: p - s for (name, p), s in zip(named, start)}
        ema_change = {name: e - s for (name, _), e, s in zip(named, ema, start)}
    return Readings(losses, grad_norms, change, ema_change, first)


def compare(program: Readings, reference: Readings) -> Dict[str, float]:
    """The numbers compared, each a gap relative to the reference.

    ``loss_gap``: the largest |loss_p - loss_r| / |loss_r| over the steps.
    ``grad_gap``, ``change_gap``, ``ema_gap``: over the parameters, the
    largest |norm_p - norm_r| / max(norm_r, median norm_r). The change and
    the EMA's change leave out the entries whose reference first gradient
    is under a thousandth of the median parameter's root-mean-square
    gradient entry (a key's bias under softmax, a bias before a GroupNorm):
    Adam moves those by rounding alone. A parameter left with no entry is
    left out.
    """
    losses = max(abs(p - r) / abs(r) for p, r in zip(program.losses, reference.losses))
    first = reference.first_grad
    rms = {k: float(torch.sqrt(torch.mean(torch.square(g)))) for k, g in first.items()}
    floor = 1e-3 * float(np.median(list(rms.values())))

    def gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
        med = float(np.median(list(ref.values())))
        return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref)

    def masked(delta: Dict[str, torch.Tensor]) -> Dict[str, float]:
        out = {}
        for k, g in first.items():
            keep = g.abs() >= floor
            if bool(keep.any()):
                out[k] = float(torch.linalg.vector_norm(delta[k].to(g.device)[keep]))
        return out

    return {"loss_gap": losses,
            "grad_gap": gap(program.grad_norms, reference.grad_norms),
            "change_gap": gap(masked(program.change), masked(reference.change)),
            "ema_gap": gap(masked(program.ema_change), masked(reference.ema_change))}
