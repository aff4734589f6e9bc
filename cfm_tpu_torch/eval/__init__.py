"""Evaluation (counterpart of ``cfm_tpu/eval``): distribution distances, the
FID protocol pieces, the trajectory and graph metrics."""

from cfm_tpu_torch.eval.metrics import (compute_distances, compute_distribution_distances,
                                        linear_mmd2, mix_rbf_mmd2, poly_mmd2)

__all__ = [
    "compute_distances",
    "compute_distribution_distances",
    "linear_mmd2",
    "mix_rbf_mmd2",
    "poly_mmd2",
]
