"""Forest-Flow: flow matching with gradient-boosted trees as the vector field
(counterpart of ``examples/tabular_forest_flow.py``).

Learns the I-CFM conditional vector field u_t = x1 - x0 at discretized time
levels with a tree ensemble instead of a neural net, then generates by
Euler integration of the per-level regressors, on the whitened iris data.
The trees are scikit-learn's ``HistGradientBoostingRegressor``, imported
inside :func:`main` as in the JAX example; scikit-learn also supplies the
iris data. The trees are host-side by nature. The port's part is the CFM
path construction (``ConditionalFlowMatcher(sigma=0).sample_xt`` on the
device) and the W2 evaluation (``coupling.wasserstein``: on the card the
dense auction kernel, #5, at the 150 rows).

Where scikit-learn is not installed, :func:`main` raises ``ImportError``
before it touches the device; nothing falls back.

Usage:
  python -m cfm_tpu_torch.tabular_forest_flow [--n_t 20] [--dup 30] [--steps 100]
  python -m cfm_tpu_torch.tabular_forest_flow --device cpu
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.paths import ConditionalFlowMatcher

N_GEN = 500  # generated rows


def level_training_sets(x0: np.ndarray, x1: np.ndarray, n_t: int, device: DeviceLike
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The per-level training sets: at each of the ``n_t`` levels t_k of
    [0, 1), x_t of the I-CFM path at sigma 0 between the noise ``x0`` and the
    data ``x1`` (float32 rows) and the target u = x1 - x0, as numpy arrays."""
    fm = ConditionalFlowMatcher(sigma=0.0)
    a, b = torch.from_numpy(x0).to(device), torch.from_numpy(x1).to(device)
    ut = x1 - x0
    sets = []
    for t in np.linspace(0.0, 1.0, n_t, endpoint=False):
        tb = torch.full((x1.shape[0],), float(t), device=device)
        xt = fm.sample_xt(a, b, tb, torch.zeros_like(a)).cpu().numpy()
        sets.append((xt, ut))
    return sets


def euler_generate(models: Sequence[Sequence], x: np.ndarray, n_t: int, steps: int) -> np.ndarray:
    """Euler over the piecewise-constant-in-time forest field: ``models[k][j]``
    predicts coordinate j of the field at level k."""
    d = x.shape[1]
    dt = 1.0 / steps
    for s in range(steps):
        t = s * dt
        k = min(int(t * n_t), n_t - 1)
        v = np.stack([models[k][j].predict(x) for j in range(d)], axis=1)
        x = x + dt * v.astype(np.float32)
    return x


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--n_t", type=int, default=20, help="time discretization levels")
    p.add_argument("--dup", type=int, default=30,
                   help="noise duplications per data point (Forest-Flow K)")
    p.add_argument("--steps", type=int, default=100, help="Euler steps at generation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    args = p.parse_args(argv)

    from sklearn.datasets import load_iris
    from sklearn.ensemble import HistGradientBoostingRegressor

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    X = load_iris().data.astype(np.float32)
    mu, sd = X.mean(0), X.std(0) + 1e-8
    X = (X - mu) / sd
    n, d = X.shape

    # Per level: every data point paired with `dup` noise draws.
    x1 = np.repeat(X, args.dup, axis=0)
    x0 = rng.standard_normal(x1.shape).astype(np.float32)
    models = []  # one regressor per (time level, output dim)
    for k, (xt, ut) in enumerate(level_training_sets(x0, x1, args.n_t, device)):
        models.append([HistGradientBoostingRegressor(max_iter=50, random_state=args.seed)
                       .fit(xt, ut[:, j]) for j in range(d)])
        if k % 5 == 0:
            print(f"fitted level {k}/{args.n_t}")

    x = euler_generate(models, rng.standard_normal((N_GEN, d)).astype(np.float32), args.n_t,
                       args.steps)
    w2 = float(wasserstein(torch.from_numpy(x[: len(X)]).to(device),
                           torch.from_numpy(X[: len(x)]).to(device), power=2))
    noise = rng.standard_normal((len(X), d)).astype(np.float32)
    base = float(wasserstein(torch.from_numpy(noise).to(device), torch.from_numpy(X).to(device),
                             power=2))
    print(f"iris (whitened): generated-vs-data W2 = {w2:.3f} (noise baseline {base:.3f})")
    assert w2 < base, "forest flow failed to move toward the data"
    return {"w2": w2, "base": base}


if __name__ == "__main__":
    main()
