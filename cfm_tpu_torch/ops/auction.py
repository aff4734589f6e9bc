"""The epsilon-scaled auctions (counterpart of ``cfm_tpu/ops/pallas_auction.py``).

The dense auction (TPU kernel #5, n <= 512):

- :func:`auction_assignment_onehot` is the plain PyTorch version: a
  transcription of the TPU kernel's ``_round_body`` loop as
  ``auction_assignment_onehot_xla`` writes it (dense one-hot state, the same
  epsilon schedule, round cap and first-column / first-row tie rules). It is
  the CPU path and the oracle the CUDA kernel is held against; it reads a
  flag back to the host every round, so it is slow on the card.
- :func:`pallas_auction_assignment` is the wrapper. A CPU tensor goes to the
  plain version; a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/auction.cu``) or raises. It never falls back.

The row-tiled auction (TPU kernel #6, n = 1024..4096, the 2-D evaluation's
exact W1/W2 at n = 2048):

- :func:`auction_assignment_tiled_reference` is its plain version, a
  transcription of ``_make_tiled_kernel``: compact price and owner state,
  bids reduced row tile by row tile, the earlier tile winning ties. It
  gives the same permutation and round count as the dense auction.
- :func:`pallas_auction_assignment_tiled` is the wrapper, with the Hopper
  kernel ``csrc/auction_tiled.cu`` on CUDA tensors.

:func:`_sanitize_perm` completes a partial matching into a permutation,
outside the kernels as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cfm_tpu_torch.ops import _build

_NEG = -3.0e38


def _eps_schedule(benefit: torch.Tensor, num_phases: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """eps0 = range / 2 and eps_final = eps0 / 4**(phases-1), as f32 device
    tensors (no host read)."""
    rng = torch.clamp(benefit.max() - benefit.min(), min=1e-12)
    eps0 = rng / 2.0
    return eps0, eps0 / (4.0 ** (num_phases - 1))


def _round_body(benefit, A, prices, eps):
    """One bidding round on the dense one-hot state A (n, n), prices (1, n)."""
    n = benefit.shape[0]
    ids = torch.arange(n, device=benefit.device)
    col_ids, row_ids = ids[None, :], ids[:, None]
    unassigned = A.sum(dim=1, keepdim=True) < 0.5
    values = benefit - prices
    best_v = values.amax(dim=1, keepdim=True)
    first_col = torch.where(values >= best_v, col_ids, n).amin(dim=1, keepdim=True)
    first_best = col_ids == first_col
    second_v = torch.where(first_best, _NEG, values).amax(dim=1, keepdim=True)
    best_price = prices[0, first_col[:, 0]][:, None]
    bid = best_price + (best_v - second_v) + eps
    B = torch.where(first_best & unassigned, bid, _NEG)
    win_bid = B.amax(dim=0, keepdim=True)
    has_bid = win_bid > _NEG
    is_winner = (B >= win_bid) & (B > _NEG)
    first_row = torch.where(is_winner, row_ids, n).amin(dim=0, keepdim=True)
    first_winner = (row_ids == first_row) & is_winner
    A = torch.where(has_bid, first_winner.float(), A)
    prices = torch.where(has_bid, win_bid, prices)
    return A, prices


def auction_assignment_onehot(cost: torch.Tensor, num_phases: int = 12
                              ) -> Tuple[torch.Tensor, int]:
    """Plain version of the kernel: (perm (n,) int64, rounds)."""
    n = cost.shape[0]
    benefit = -cost.float()
    eps, eps_final = _eps_schedule(benefit, num_phases)
    A = torch.zeros((n, n), device=cost.device)
    prices = torch.zeros((1, n), device=cost.device)
    rounds, cap = 0, 200 * n + 20000
    while rounds < cap:
        A, prices = _round_body(benefit, A, prices, eps)
        rounds += 1
        all_assigned = A.sum() >= n - 0.5
        advance = all_assigned & (eps > eps_final)
        A = torch.where(advance, torch.zeros_like(A), A)
        eps = torch.where(advance, eps / 4.0, eps)
        if bool(all_assigned & ~advance):
            break
    col_ids = torch.arange(n, device=cost.device)[None, :]
    perm = torch.where(A > 0.5, col_ids, n).amin(dim=1)
    return _sanitize_perm(perm, n), rounds


def _complete_assignment(person_to_obj: torch.Tensor, obj_to_person: torch.Tensor) -> torch.Tensor:
    """Pair the k-th unassigned person with the k-th unowned object; the
    identity on a complete matching."""
    n = person_to_obj.shape[0]
    obj_ids = torch.arange(n, device=person_to_obj.device)
    unassigned = person_to_obj < 0
    unowned = obj_to_person < 0
    person_rank = torch.cumsum(unassigned.long(), 0) - 1
    obj_rank = torch.cumsum(unowned.long(), 0) - 1
    fill = torch.zeros(n + 1, dtype=torch.long, device=person_to_obj.device)
    fill[torch.where(unowned, obj_rank, n)] = obj_ids  # slot n absorbs the rest
    return torch.where(unassigned, fill[torch.clamp(person_rank, 0, n - 1)],
                       person_to_obj.long())


def _sanitize_perm(perm: torch.Tensor, n: int) -> torch.Tensor:
    """Rows left unowned (the ``n`` sentinel) or claiming a column another
    row claims first become unassigned, then the matching is completed."""
    perm = perm.long()
    rows = torch.arange(n, device=perm.device)
    invalid = (perm < 0) | (perm >= n)
    safe = torch.where(invalid, n, perm)
    first_owner = torch.full((n + 1,), n, dtype=torch.long, device=perm.device)
    first_owner = first_owner.scatter_reduce(0, safe, rows, "amin")
    invalid = invalid | (first_owner[torch.clamp(perm, 0, n - 1)] != rows)
    owned = torch.zeros(n + 1, dtype=torch.bool, device=perm.device)
    owned[torch.where(invalid, n, perm)] = True
    return _complete_assignment(torch.where(invalid, -1, perm),
                                torch.where(owned[:n], 0, -1))


def pallas_auction_assignment(cost: torch.Tensor, num_phases: int = 12) -> torch.Tensor:
    """Exact assignment of the square cost (n, n), n <= 512: perm (n,) int64.

    On a CUDA tensor this launches the Hopper kernel (and adds one to
    ``pallas_auction_assignment.launches``; the kernel's round count is left
    on the device in ``pallas_auction_assignment.last_rounds``); on a CPU
    tensor it runs :func:`auction_assignment_onehot`.
    """
    if cost.dim() != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"cost must be square (n, n), got {tuple(cost.shape)}")
    n = cost.shape[0]
    if cost.device.type == "cpu":
        return auction_assignment_onehot(cost, num_phases)[0]
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    if not 0 < n <= 512:
        raise ValueError(f"the dense auction kernel takes 0 < n <= 512, got n={n}")
    benefit = (-cost.float()).contiguous()
    eps0, eps_final = _eps_schedule(benefit, num_phases)
    perm = torch.empty(n, dtype=torch.int32, device=cost.device)
    rounds = torch.empty(1, dtype=torch.int32, device=cost.device)
    lib = _lib()
    with torch.cuda.device(cost.device):
        err = lib.auction_solve(benefit.data_ptr(), eps0.data_ptr(), eps_final.data_ptr(),
                                perm.data_ptr(), rounds.data_ptr(), n,
                                torch.cuda.current_stream(cost.device).cuda_stream)
    if err:
        raise RuntimeError(f"auction launch failed: CUDA error {err}")
    pallas_auction_assignment.launches += 1
    pallas_auction_assignment.last_rounds = rounds
    return _sanitize_perm(perm, n)


pallas_auction_assignment.launches = 0
pallas_auction_assignment.last_rounds = None


def _tile(n: int) -> int:
    """The TPU kernel's row tile: 128 at n >= 4096, else 256."""
    return 128 if n >= 4096 else 256


def auction_assignment_tiled_reference(cost: torch.Tensor, num_phases: int = 12,
                                       tile: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """Plain version of the row-tiled kernel: (perm (n,) int64, rounds).

    Each round, the rows that own no column bid (an owned row's bids are the
    TPU kernel's ``_NEG``, so only the unassigned rows are computed); each
    tile of ``tile`` rows keeps per column its best bid and the first row
    that made it, and across tiles the earlier one wins ties. The round
    count and the unassigned rows are read on the host every round.
    """
    n = cost.shape[0]
    tile = tile or _tile(n)
    if n % tile:
        raise ValueError(f"n={n} must be a multiple of the row tile {tile}")
    dev = cost.device
    benefit = -cost.float()
    eps, eps_final = _eps_schedule(benefit, num_phases)
    price = torch.zeros(n, device=dev)
    owner = torch.full((n,), -1, dtype=torch.long, device=dev)
    ids = torch.arange(n, device=dev)
    nt = n // tile
    rounds, owned, cap = 0, 0, 200 * n + 20000
    while owned < n and rounds < cap:
        assigned = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        assigned[torch.where(owner >= 0, owner, n)] = True
        rows = torch.nonzero(~assigned[:n])[:, 0]          # ascending
        values = benefit[rows] - price
        v1 = values.amax(dim=1, keepdim=True)
        jbest = torch.where(values >= v1, ids, n).amin(dim=1, keepdim=True)
        v2 = torch.where(ids == jbest, _NEG, values).amax(dim=1)
        jbest = jbest[:, 0]
        bid = price[jbest] + (v1[:, 0] - v2) + eps
        # Per (tile, column): the best bid, then the first row among its bidders.
        slot = (rows // tile) * n + jbest
        tile_best = torch.full((nt * n,), _NEG, device=dev).scatter_reduce(0, slot, bid, "amax")
        is_win = (bid >= tile_best[slot]) & (bid > _NEG)
        tile_row = torch.full((nt * n,), n, dtype=torch.long, device=dev).scatter_reduce(
            0, torch.where(is_win, slot, 0), torch.where(is_win, rows, n), "amin")
        tile_best, tile_row = tile_best.view(nt, n), tile_row.view(nt, n)
        # Across tiles the earlier tile wins ties: the first tile at the max.
        win_bid = tile_best.amax(dim=0)
        tiles = torch.arange(nt, device=dev)[:, None]
        first = torch.where((tile_best >= win_bid) & (tile_best > _NEG), tiles, nt).amin(dim=0)
        has = win_bid > _NEG
        win_row = tile_row.gather(0, torch.clamp(first, max=nt - 1)[None])[0]
        owner = torch.where(has, win_row, owner)
        price = torch.where(has, win_bid, price)
        rounds += 1
        owned = int((owner >= 0).sum())
        if owned >= n and bool(eps > eps_final):
            owner = torch.full_like(owner, -1)
            owned = 0
            eps = eps / 4.0
    perm = torch.full((n + 1,), n, dtype=torch.long, device=dev)
    perm[torch.where(owner >= 0, owner, n)] = ids
    return _sanitize_perm(perm[:n], n), rounds


def pallas_auction_assignment_tiled(cost: torch.Tensor, num_phases: int = 12) -> torch.Tensor:
    """Exact assignment of the square cost (n, n), n a multiple of the row
    tile (256, or 128 at n >= 4096): perm (n,) int64.

    On a CUDA tensor this launches the Hopper kernel (adding one to
    ``pallas_auction_assignment_tiled.launches``; the round count and the
    row scans are left on the device in ``.last_rounds`` and
    ``.last_row_scans``); on a CPU tensor it runs
    :func:`auction_assignment_tiled_reference`.
    """
    if cost.dim() != 2 or cost.shape[0] != cost.shape[1]:
        raise ValueError(f"cost must be square (n, n), got {tuple(cost.shape)}")
    n = cost.shape[0]
    if n == 0 or n % _tile(n):
        raise ValueError(f"the tiled auction takes n a positive multiple of {_tile(n)}, got n={n}")
    if cost.device.type == "cpu":
        return auction_assignment_tiled_reference(cost, num_phases)[0]
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    benefit = (-cost.float()).contiguous()
    eps0, eps_final = _eps_schedule(benefit, num_phases)
    perm = torch.empty(n, dtype=torch.int32, device=cost.device)
    rounds = torch.empty(1, dtype=torch.int32, device=cost.device)
    scans = torch.empty(1, dtype=torch.int64, device=cost.device)
    lib = _lib("auction_tiled")
    with torch.cuda.device(cost.device):
        err = lib.auction_tiled_solve(benefit.data_ptr(), eps0.data_ptr(), eps_final.data_ptr(),
                                      perm.data_ptr(), rounds.data_ptr(), scans.data_ptr(), n,
                                      torch.cuda.current_stream(cost.device).cuda_stream)
    if err:
        raise RuntimeError(f"tiled auction launch failed: CUDA error {err}")
    pallas_auction_assignment_tiled.launches += 1
    pallas_auction_assignment_tiled.last_rounds = rounds
    pallas_auction_assignment_tiled.last_row_scans = scans
    return _sanitize_perm(perm, n)


pallas_auction_assignment_tiled.launches = 0
pallas_auction_assignment_tiled.last_rounds = None
pallas_auction_assignment_tiled.last_row_scans = None

_ARGTYPES = {"auction": ("auction_solve", 5),            # pointers before n
             "auction_tiled": ("auction_tiled_solve", 6)}


def _lib(name: str = "auction") -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        fn, n_ptrs = _ARGTYPES[name]
        p, i = ctypes.c_void_p, ctypes.c_int
        getattr(lib, fn).argtypes = [p] * n_ptrs + [i, p]
        getattr(lib, fn).restype = i
        lib._typed = True
    return lib
