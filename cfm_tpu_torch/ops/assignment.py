"""Exact linear-assignment solvers (counterpart of ``cfm_tpu/ops/assignment.py``).

For uniform marginals over equal-sized batches the optimal transport plan is
a permutation, so an assignment solve is the exact OT solve.

- :func:`auction_assignment`: the scatter-based epsilon-scaled auction in
  plain PyTorch (JAX runs it as XLA, not as a kernel). It reads one flag
  back to the host per round.
- :func:`hungarian_assignment`: ``scipy.optimize.linear_sum_assignment`` on
  the host, the port's counterpart of the JAX package's native JV solver.
- :func:`solve_assignment`: dispatch. "auto" resolves by the cost's device:
  the CPU takes "hungarian"; CUDA takes "pallas" (the dense auction kernel,
  ``ops/auction.py``) for 0 < n <= 512, "pallas_tiled" (the row-tiled
  auction kernel) for 1024 <= n <= 4096 with n a multiple of 256 (of 128 at
  4096), and "auction" otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from cfm_tpu_torch.ops.auction import (_complete_assignment, pallas_auction_assignment,
                                       pallas_auction_assignment_tiled)


_EPS_DECAY = 4.0


def auction_assignment(cost: torch.Tensor, *, num_phases: int = 12) -> torch.Tensor:
    """Min-cost perfect assignment of a square cost: perm (n,) int64, with
    person i assigned to object ``perm[i]``. Within ``n * eps_final`` of the
    optimum, ``eps_final = range / 2 / 4**(num_phases - 1)``; at most
    ``200 n + 20000`` rounds."""
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError("auction_assignment requires a square cost matrix")
    dev = cost.device
    if n == 1:
        return torch.zeros(1, dtype=torch.long, device=dev)
    benefit = -cost.float()
    cost_range = torch.clamp(benefit.max() - benefit.min(), min=1e-12)
    eps = cost_range / 2.0
    eps_final = eps / (_EPS_DECAY ** (num_phases - 1))
    max_rounds = 200 * n + 20000
    obj_ids = torch.arange(n, device=dev)
    person_to_obj = torch.full((n,), -1, dtype=torch.long, device=dev)
    obj_to_person = person_to_obj.clone()
    prices = torch.zeros(n, device=dev)
    neg_inf = float("-inf")
    rounds = 0
    while rounds < max_rounds and bool((person_to_obj < 0).any()):
        unassigned = person_to_obj < 0
        values = benefit - prices[None, :]
        best_v, best_j = values.max(dim=1)  # first index among the maxima
        is_best = obj_ids[None, :] == best_j[:, None]
        second_v = torch.where(is_best, neg_inf, values).amax(dim=1)
        bids = prices[best_j] + (best_v - second_v) + eps
        bid_matrix = torch.where(unassigned[:, None] & is_best, bids[:, None], neg_inf)
        win_bid, winner = bid_matrix.max(dim=0)
        has_bid = win_bid > neg_inf
        prices = torch.where(has_bid, win_bid, prices)
        # Previous owners of re-auctioned objects become unassigned; slot n
        # of the padded vectors absorbs the no-op writes.
        pad = torch.cat([person_to_obj, person_to_obj.new_full((1,), -1)])
        pad[torch.where(has_bid & (obj_to_person >= 0), obj_to_person, n)] = -1
        pad[torch.where(has_bid, winner, n)] = obj_ids
        person_to_obj = pad[:n]
        obj_to_person = torch.where(has_bid, winner, obj_to_person)
        advance = (person_to_obj >= 0).all() & (eps > eps_final)
        person_to_obj = torch.where(advance, -1, person_to_obj)
        obj_to_person = torch.where(advance, -1, obj_to_person)
        eps = torch.where(advance, eps / _EPS_DECAY, eps)
        rounds += 1
    return _complete_assignment(person_to_obj, obj_to_person)


def hungarian_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Exact assignment by scipy's solver on the host (a device sync on CUDA)."""
    from scipy.optimize import linear_sum_assignment

    _, col = linear_sum_assignment(cost.detach().double().cpu().numpy())
    return torch.as_tensor(col.astype(np.int64), device=cost.device)


def resolve_solver(method: str = "auto", n: int = 0, device=None) -> str:
    """Resolve "auto" by device and n, with the JAX package's rules."""
    if method != "auto":
        return method
    if torch.device(device if device is not None else "cpu").type == "cpu":
        return "hungarian"
    if 0 < n <= 512:
        return "pallas"
    if n <= 4096 and n % (128 if n >= 4096 else 256) == 0:
        return "pallas_tiled"
    return "auction"


def solve_assignment(cost: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Dispatch: "auto" | "pallas" | "pallas_tiled" | "auction" | "hungarian"."""
    method = resolve_solver(method, n=cost.shape[0], device=cost.device)
    if method == "pallas":
        return pallas_auction_assignment(cost)
    if method == "pallas_tiled":
        return pallas_auction_assignment_tiled(cost)
    if method == "auction":
        return auction_assignment(cost)
    if method == "hungarian":
        return hungarian_assignment(cost)
    raise ValueError(f"Unknown assignment method: {method}")


def assignment_cost(cost: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Total cost of an assignment: sum over i of cost[i, perm[i]]."""
    return cost.gather(1, perm.long()[:, None]).sum()
