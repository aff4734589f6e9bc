"""Distribution distances: W1/W2, the MMD family, moment statistics
(counterpart of ``cfm_tpu/eval/metrics.py``).

The Wasserstein distances are the port's :func:`coupling.wasserstein`: the
exact assignment for equal sizes (on the card the solver
``ops/assignment.resolve_solver`` picks by n, as JAX's does: the dense
auction kernel to 512, the tiled one at multiples of 256 to 4096, else the
plain scatter auction), the entropic cost for unequal sizes. Medians are
``torch.quantile(x, 0.5)``, which averages the two middle values of an even
count as ``jnp.median`` does (``torch.median`` returns the lower one).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.ops.cost import sq_euclidean_cost

Batch = Union[torch.Tensor, List[torch.Tensor]]


def linear_mmd2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Linear-time MMD^2 with a linear kernel."""
    delta = x - y
    return torch.mean(torch.sum(delta[:-1] * delta[1:], dim=1))


def poly_mmd2(x: torch.Tensor, y: torch.Tensor, d: int = 2, alpha: float = 1.0,
              c: float = 2.0) -> torch.Tensor:
    """Linear-time MMD^2 with a polynomial kernel."""
    def k(a, b):
        return torch.mean((alpha * torch.sum(a[:-1] * b[1:], dim=1) + c) ** d)

    return k(x, x) + k(y, y) - k(x, y) - k(y, x)


def mix_rbf_mmd2(x: torch.Tensor, y: torch.Tensor,
                 sigma_list: Sequence[float] = (0.01, 0.1, 1, 10, 100),
                 biased: bool = True) -> torch.Tensor:
    """MMD^2 with a mixture-of-RBF kernel over the squared-distance matrices
    (the biased V-statistic, or the unbiased U-statistic)."""
    m, n = x.shape[0], y.shape[0]

    def mix(d2):
        out = torch.zeros_like(d2)
        for sigma in sigma_list:
            out = out + torch.exp(-d2 / (2 * sigma ** 2))
        return out

    k_xx, k_xy, k_yy = (mix(sq_euclidean_cost(a, b)) for a, b in ((x, x), (x, y), (y, y)))
    if biased:
        return torch.mean(k_xx) + torch.mean(k_yy) - 2 * torch.mean(k_xy)
    return ((torch.sum(k_xx) - torch.trace(k_xx)) / (m * (m - 1))
            + (torch.sum(k_yy) - torch.trace(k_yy)) / (n * (n - 1)) - 2 * torch.mean(k_xy))


def compute_distances(pred: torch.Tensor, true: torch.Tensor) -> Tuple[float, float, float]:
    """(MSE, L2, L1) between two vectors, read to the host."""
    mse = float(torch.mean(torch.square(pred - true)))
    return mse, math.sqrt(mse), float(torch.mean(torch.abs(pred - true)))


NAMES = [
    "1-Wasserstein",
    "2-Wasserstein",
    "Linear_MMD",
    "Poly_MMD",
    "RBF_MMD",
    "Mean_MSE",
    "Mean_L2",
    "Mean_L1",
    "Median_MSE",
    "Median_L2",
    "Median_L1",
]


def _median(x: torch.Tensor) -> torch.Tensor:
    return torch.quantile(x, 0.5, dim=0)


def compute_distribution_distances(pred: Batch, true: Batch) -> Tuple[List[str], List[float]]:
    """Per-timepoint and averaged distances: (names, values).

    ``pred`` and ``true`` are (batch, times, dim) tensors or lists of
    (batch_t, dim) tensors (jagged timepoints). With more than one timepoint
    the per-timepoint entries ``t{i}/<name>`` come first, then the mean row
    under the bare names. The MMDs, paired-sample estimators, are left out
    for lists and for tensors of unequal batch sizes; a timepoint of unequal
    sizes takes the entropic W1/W2.
    """
    pred_is_jagged = isinstance(pred, list)
    is_jagged = isinstance(true, list)
    unequal = not (pred_is_jagged or is_jagged) and pred.shape[0] != true.shape[0]
    skip_mmd = pred_is_jagged or is_jagged or unequal
    filtered_names = [n for n in NAMES if not skip_mmd or not n.endswith("MMD")]
    ts = len(pred) if pred_is_jagged else pred.shape[1]
    dists: List[Tuple[float, ...]] = []
    names: List[str] = []
    to_return: List[float] = []
    for t in range(ts):
        a = pred[t] if pred_is_jagged else pred[:, t, :]
        b = true[t] if is_jagged else true[:, t, :]
        method = None if a.shape[0] == b.shape[0] else "sinkhorn"
        w1 = float(wasserstein(a, b, method=method, power=1))
        w2 = float(wasserstein(a, b, method=method, power=2))
        mean_d = compute_distances(torch.mean(a, dim=0), torch.mean(b, dim=0))
        med_d = compute_distances(_median(a), _median(b))
        if skip_mmd:
            row = (w1, w2, *mean_d, *med_d)
        else:
            row = (w1, w2, float(linear_mmd2(a, b)), float(poly_mmd2(a, b)),
                   float(mix_rbf_mmd2(a, b)), *mean_d, *med_d)
        dists.append(row)
        if ts > 1:
            names.extend([f"t{t + 1}/{n}" for n in filtered_names])
            to_return.extend(row)
    to_return.extend(np.array(dists).mean(axis=0).tolist())
    names.extend(filtered_names)
    return names, to_return
