"""Kernels and their plain PyTorch versions (counterpart of ``cfm_tpu/ops``).

Each module that holds a hand-written kernel keeps its plain version beside
it: a CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. Kernels are built at first launch (``_build``), never at import.

The package re-exports the JAX package's names. As there, ``sinkhorn`` is
then the function: import the module as ``cfm_tpu_torch.ops.sinkhorn`` by
``importlib.import_module`` or ``from cfm_tpu_torch.ops.sinkhorn import ...``.
"""

from cfm_tpu_torch.ops.assignment import auction_assignment, hungarian_assignment, solve_assignment
from cfm_tpu_torch.ops.cost import euclidean_cost, sq_euclidean_cost
from cfm_tpu_torch.ops.sinkhorn import (partial_wasserstein, sinkhorn, sinkhorn2,
                                        sinkhorn_unbalanced)

__all__ = [
    "auction_assignment",
    "hungarian_assignment",
    "solve_assignment",
    "sq_euclidean_cost",
    "euclidean_cost",
    "sinkhorn",
    "sinkhorn2",
    "sinkhorn_unbalanced",
    "partial_wasserstein",
]
