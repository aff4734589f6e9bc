"""Trajectory (multi-timepoint) data and batch preprocessing (counterpart of
``cfm_tpu/data/trajectory.py``).

A trajectory batch is X (bs, T, D): one row per sampled cell, one slice per
timepoint. :func:`sample_segment_pairs` draws per sample an adjacent
timepoint pair, skipping a left-out timepoint during training (the segment
into it straddles to the next one); :func:`make_joint_plan_sampler` draws the
pairs from precomputed joint OT plans instead. The synthetic tree, circle and
cycle populations, the h5ad and npz single-cell loaders, resampling of
jagged marginals to a batch and whitening complete the module.

Every function that draws takes an explicit ``torch.Generator``, or the
draws themselves (the raw integer draws ``t_draw``, the row indices
``rows``, the uniforms ``u``, ``branch_u``, ``theta_u`` and the standard
normals ``noise``), so a test can hand both packages the same numbers.
``h5py`` is imported inside the two h5ad loaders, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Marginals = Sequence[Union[np.ndarray, torch.Tensor]]


def _shifted_t_select(t_draw: torch.Tensor, leaveout_timepoint: int) -> torch.Tensor:
    """Draws in [0, T - 2) -> segment starts that skip the left-out timepoint."""
    return torch.where(t_draw >= leaveout_timepoint, t_draw + 1, t_draw)


def sample_segment_pairs(generator: Optional[torch.Generator], X: torch.Tensor,
                         leaveout_timepoint: int = -1, training: bool = True,
                         t_draw: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random adjacent-timepoint pairs from X (bs, T, ...):
    (x0, x1, t_select), x0 = X[i, t_select[i]] and x1 = X[i, t_select[i] + 1],
    except that in training with 0 < leaveout < T the draw has T - 2 options,
    no segment starts at the left-out timepoint, and the one that ends there
    jumps over it. With leaveout = T - 1 the last segment is never drawn.
    ``t_draw`` (bs,) are the raw integer draws, in [0, T - 2) or [0, T - 1)."""
    bs, T = X.shape[0], X.shape[1]
    leave = training and 0 < leaveout_timepoint < T
    if t_draw is None:
        t_draw = torch.randint(0, T - 2 if leave else T - 1, (bs,), generator=generator,
                               device=X.device)
    t_draw = t_draw.to(X.device)
    if leave:
        t_sel = _shifted_t_select(t_draw, leaveout_timepoint)
        t_next = t_sel + 1
        t_next = torch.where(t_next == leaveout_timepoint, t_next + 1, t_next)
    else:
        t_sel, t_next = t_draw, t_draw + 1
    idx = torch.arange(bs, device=X.device)
    return X[idx, t_sel], X[idx, t_next], t_sel


def leaveout_adjusted_targets(ut: torch.Tensor, t: torch.Tensor, t_select: torch.Tensor,
                              leaveout_timepoint: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For pairs straddling the left-out timepoint the target velocity halves
    (the segment spans two time units) and the local t doubles."""
    straddles = t_select + 1 == leaveout_timepoint
    ut = torch.where(straddles.reshape(-1, *([1] * (ut.dim() - 1))), ut / 2.0, ut)
    return ut, torch.where(straddles, t * 2.0, t)


# --------------------------------------------------------------------------
# Synthetic single-cell populations
# --------------------------------------------------------------------------


def _device(generator: Optional[torch.Generator], given: Optional[torch.Tensor]) -> torch.device:
    """The generator's device, else that of the draws given in its place."""
    if generator is not None:
        return generator.device
    return given.device if given is not None else torch.device("cpu")


def tree_population(generator: Optional[torch.Generator], n: int, T: int = 5, dim: int = 2,
                    branch_u: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Branching "TREE" population (n, T, dim) on the generator's device:
    points drift right along one of two branches chosen by ``branch_u`` (n,)
    < 0.5, plus 0.1 times the standard normals ``noise`` (n, T, dim)."""
    dev = _device(generator, branch_u)
    if branch_u is None:
        branch_u = torch.rand(n, generator=generator, device=dev)
    if noise is None:
        noise = torch.randn((n, T, dim), generator=generator, device=dev)
    branch = torch.where(branch_u.to(dev) < 0.5, 1.0, -1.0)
    ts = torch.linspace(0.0, 1.0, T, device=dev)
    base = torch.zeros((n, T, dim), device=dev)
    base[:, :, 0] += ts[None, :]
    base[:, :, 1] += branch[:, None] * ts[None, :] ** 2
    return base + 0.1 * noise.to(dev)


def _on_circle(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def circle_population(generator: Optional[torch.Generator], n: int, T: int = 5, dim: int = 2,
                      theta_u: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Points rotating a quarter turn around the unit circle over T
    timepoints (n, T, 2); start angles 2 pi ``theta_u`` (n,), plus 0.05
    times ``noise`` (n, T, 2). ``dim`` is ignored, as in JAX."""
    dev = _device(generator, theta_u)
    if theta_u is None:
        theta_u = torch.rand(n, generator=generator, device=dev)
    if noise is None:
        noise = torch.randn((n, T, 2), generator=generator, device=dev)
    theta0 = theta_u.to(dev) * (2 * math.pi)
    ts = torch.linspace(0.0, math.pi / 2, T, device=dev)
    return _on_circle(theta0[:, None] + ts[None, :]) + 0.05 * noise.to(dev)


def cycle_population(generator: Optional[torch.Generator], n: int, T: int = 5,
                     noise: float = 0.05, theta_u: Optional[torch.Tensor] = None,
                     normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A population cycling between two states (n, T, 2): half a turn a
    timepoint, so the marginals at t and t + 2 coincide; start angles
    2 pi ``theta_u``, plus ``noise`` times the standard normals ``normals``."""
    dev = _device(generator, theta_u)
    if theta_u is None:
        theta_u = torch.rand(n, generator=generator, device=dev)
    if normals is None:
        normals = torch.randn((n, T, 2), generator=generator, device=dev)
    phase0 = theta_u.to(dev) * (2 * math.pi)
    ts = torch.arange(T, device=dev) * math.pi
    return _on_circle(phase0[:, None] + ts[None, :]) + noise * normals.to(dev)


# --------------------------------------------------------------------------
# On-disk single-cell loaders (host numpy, as in JAX)
# --------------------------------------------------------------------------


def load_h5ad_timeseries(path: str, obsm_key: str = "X_pca", time_key: str = "day",
                         max_dim: Optional[int] = None) -> Tuple[List[np.ndarray], np.ndarray]:
    """Read an .h5ad (HDF5) single-cell file without scanpy: the embedding
    ``obsm/<obsm_key>`` split by ``obs/<time_key>`` (plain or categorical).
    Returns (per-timepoint arrays, sorted unique times)."""
    import h5py

    with h5py.File(path, "r") as f:
        emb = np.asarray(f["obsm"][obsm_key])
        obs = f["obs"][time_key]
        if isinstance(obs, h5py.Group):  # categorical storage
            times = np.asarray(obs["categories"])[np.asarray(obs["codes"])].astype(float)
        else:
            times = np.asarray(obs).astype(float)
    if max_dim:
        emb = emb[:, :max_dim]
    uniq = np.sort(np.unique(times))
    return [emb[times == t] for t in uniq], uniq


def load_npz_timeseries(path: str, x_key: str = "pcs", time_key: str = "sample_labels",
                        max_dim: Optional[int] = None) -> Tuple[List[np.ndarray], np.ndarray]:
    """The npz loader: ``x_key`` rows split by the ``time_key`` labels."""
    d = np.load(path, allow_pickle=True)
    emb = np.asarray(d[x_key])
    times = np.asarray(d[time_key]).astype(float)
    if max_dim:
        emb = emb[:, :max_dim]
    uniq = np.sort(np.unique(times))
    return [emb[times == t] for t in uniq], uniq


def resample_to_trajectory(generator: Optional[torch.Generator], marginals: Marginals,
                           batch_size: int, indices: Optional[Sequence[torch.Tensor]] = None
                           ) -> torch.Tensor:
    """Stack jagged marginals into a (bs, T, D) batch, each timepoint
    resampled uniformly with replacement; ``indices`` are the per-timepoint
    row draws. The batch is on the generator's device (the indices' without
    one)."""
    dev = _device(generator, indices[0] if indices is not None else None)
    cols = []
    for ti, m in enumerate(marginals):
        m = torch.as_tensor(m, device=dev)
        idx = (torch.randint(0, m.shape[0], (batch_size,), generator=generator, device=dev)
               if indices is None else indices[ti].to(dev))
        cols.append(m[idx])
    return torch.stack(cols, dim=1)


def whiten(marginals: Sequence[np.ndarray]) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Global mean/std whitening across all timepoints."""
    full = np.concatenate(marginals, axis=0)
    mu = full.mean(0)
    std = full.std(0) + 1e-8
    return [(m - mu) / std for m in marginals], mu, std


def load_h5ad_joint_plans(path: str, n_timepoints: int, leaveout: bool = False
                          ) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]]]:
    """Precomputed joint OT plans from an .h5ad ``uns`` group:
    ``pi_{t}_{t+1}`` for each adjacent pair and, with ``leaveout``, the
    straddling ``pi_{t+1}``."""
    import h5py

    with h5py.File(path, "r") as f:
        uns = f["uns"]
        plans = [np.asarray(uns[f"pi_{t}_{t+1}"]) for t in range(n_timepoints - 1)]
        straddle = ([np.asarray(uns[f"pi_{t+1}"]) for t in range(n_timepoints - 2)]
                    if leaveout else None)
    return plans, straddle


def _host_f64(a: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().double().cpu().numpy()
    return np.asarray(a, np.float64)


class JointPlanSampler:
    """Pairs drawn from precomputed joint OT plans (see
    :func:`make_joint_plan_sampler`). ``segments`` maps a segment's start
    timepoint to (x0 data, x1 data, row CDFs)."""

    def __init__(self, segments: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                 T: int, dim: int, leaveout_timepoint: int, device: torch.device):
        self.segments, self.T, self.dim = segments, T, dim
        self.leaveout_timepoint, self.device = leaveout_timepoint, device

    def __call__(self, generator: Optional[torch.Generator], batch_size: int,
                 t_draw: Optional[torch.Tensor] = None,
                 rows: Optional[Dict[int, torch.Tensor]] = None,
                 u: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x0, x1, t_select) for ``batch_size`` samples. ``t_draw`` are the
        raw segment draws, ``rows`` the row index draws of each segment (by
        its start), ``u`` the uniforms of the column draw; drawn from
        ``generator`` in that order when not given."""
        dev, T, leave = self.device, self.T, self.leaveout_timepoint
        held = 0 < leave < T
        if t_draw is None:
            t_draw = torch.randint(0, T - 2 if held else T - 1, (batch_size,),
                                   generator=generator, device=dev)
        t_draw = t_draw.to(dev)
        t_sel = _shifted_t_select(t_draw, leave) if held else t_draw
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=dev)
        u = u.to(dev)
        x0 = torch.zeros((batch_size, self.dim), device=dev)
        x1 = torch.zeros((batch_size, self.dim), device=dev)
        for t, (x0_data, x1_data, cdf) in self.segments.items():
            i = (torch.randint(0, x0_data.shape[0], (batch_size,), generator=generator, device=dev)
                 if rows is None else rows[t].to(dev))
            c = cdf[i]
            # The inverse-CDF column draw; u scaled by the row's total handles
            # unnormalised plans.
            j = torch.searchsorted(c, (u * c[:, -1])[:, None], right=True)[:, 0]
            j = torch.clamp(j, 0, c.shape[1] - 1)
            m = (t_sel == t)[:, None]
            x0 = torch.where(m, x0_data[i], x0)
            x1 = torch.where(m, x1_data[j], x1)
        return x0, x1, t_sel


def make_joint_plan_sampler(marginals: Marginals, plans: Sequence, leaveout_timepoint: int = -1,
                            straddle_plans: Optional[Sequence] = None) -> JointPlanSampler:
    """A pair sampler over PRECOMPUTED joint OT plans (numpy arrays or
    tensors), jagged timepoint sizes allowed. Each plan's row CDFs are made
    once, summed in float64 on the host and stored as float32 on the first
    marginal's device (the CPU for numpy); a batch draws its
    segments, a uniform row per sample of each segment and the column by
    inverse CDF, then selects by segment. With ``leaveout_timepoint``, the
    segment into it straddles to the next timepoint through
    ``straddle_plans``, and no segment starts at it; holding out the last
    timepoint drops the last segment."""
    T = len(marginals)
    dev = marginals[0].device if isinstance(marginals[0], torch.Tensor) else torch.device("cpu")
    data = [torch.as_tensor(m, dtype=torch.float32, device=dev) for m in marginals]
    segments = {}
    for t in range(T - 1):
        if t + 1 == leaveout_timepoint and leaveout_timepoint == T - 1:
            continue  # last-timepoint holdout: no straddle target exists
        if t + 1 == leaveout_timepoint and 0 < leaveout_timepoint < T - 1:
            if straddle_plans is None:
                raise ValueError("leaveout_timepoint set but no straddle_plans given")
            pi, tgt = _host_f64(straddle_plans[t]), t + 2
        elif t == leaveout_timepoint and 0 < leaveout_timepoint < T - 1:
            continue  # segments never start at the left-out timepoint
        else:
            pi, tgt = _host_f64(plans[t]), t + 1
        if pi.shape != (data[t].shape[0], data[tgt].shape[0]):
            raise ValueError(f"plan {t} has shape {pi.shape}, expected "
                             f"({data[t].shape[0]}, {data[tgt].shape[0]})")
        cdf = torch.from_numpy(np.cumsum(pi, axis=1).astype(np.float32)).to(dev)
        segments[t] = (data[t], data[tgt], cdf)
    return JointPlanSampler(segments, T, data[0].shape[1], leaveout_timepoint, dev)
