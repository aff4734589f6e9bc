"""Plots and sample grids (counterpart of ``cfm_tpu/eval/plotting.py``).

The sample grid (:func:`image_grid`, :func:`plot_samples`) is written as a
PNG by hand (``zlib`` and ``struct``), with no matplotlib or PIL: one pixel
per image pixel, 8-bit grey for one channel, RGB for three, no margins or
axes. The trajectory, flow and graph plots draw with matplotlib, imported
inside each function as in JAX; where it is not installed they raise
``ImportError``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Optional, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _finish(plt, fig, save_path: Optional[str]):
    """Save to ``save_path`` and close (returning the path), or return the figure."""
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return save_path
    return fig


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> str:
    """Write a uint8 (H, W), (H, W, 1) or (H, W, 3) array as a PNG."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"a PNG needs (H, W), (H, W, 1) or (H, W, 3) pixels, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(_chunk(b"IEND", b""))
    return path


def image_grid(images: Union[np.ndarray, torch.Tensor], nrow: int = 8,
               save_path: Optional[str] = None) -> Union[str, np.ndarray]:
    """Tile NHWC images (uint8, or floats in [-1, 1]) into rows of ``nrow``.

    Floats become uint8 as in JAX's ``image_grid``: ``x * 127.5 + 127.5``,
    clipped, truncated. Writes the grid to ``save_path`` as a PNG and returns
    the path, or returns the (rows * H, nrow * W, C) uint8 grid."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    imgs = np.asarray(images)
    if imgs.dtype != np.uint8:
        imgs = np.clip(imgs * 127.5 + 127.5, 0, 255).astype(np.uint8)
    n, h, w, c = imgs.shape
    ncol = (n + nrow - 1) // nrow
    grid = np.zeros((ncol * h, nrow * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    if save_path:
        return write_png(save_path, grid)
    return grid


def plot_samples(images: ArrayLike, nrow: int = 10, save_path: Optional[str] = None):
    """The first 100 generated images as a 10-wide grid (:func:`image_grid`)."""
    return image_grid(_np(images)[:100], nrow=nrow, save_path=save_path)


def plot_trajectories(traj: ArrayLike, n: int = 2000, save_path: Optional[str] = None):
    """2-D flow trajectories (steps, points, 2): black start points, olive
    paths, blue end points."""
    plt = _plt()
    traj = _np(traj)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(traj[0, :n, 0], traj[0, :n, 1], s=10, alpha=0.8, c="black", label="x0")
    ax.plot(traj[:, :n, 0], traj[:, :n, 1], alpha=0.1, c="olive", lw=0.8)
    ax.scatter(traj[-1, :n, 0], traj[-1, :n, 1], s=4, alpha=1.0, c="blue", label="x1")
    ax.legend()
    ax.set_xticks([])
    ax.set_yticks([])
    return _finish(plt, fig, save_path)


def plot_scatter_and_flow(x: ArrayLike, vector_field: Optional[Callable] = None,
                          grid_n: int = 20, save_path: Optional[str] = None, t: float = 0.5):
    """A 2-D data scatter and, with ``vector_field(t, points)``, its stream
    plot over a grid_n x grid_n grid (the points a float32 CPU tensor)."""
    plt = _plt()
    x = _np(x)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(x[:, 0], x[:, 1], s=4, alpha=0.5, c="tab:blue")
    if vector_field is not None:
        lo, hi = x.min() - 1, x.max() + 1
        xs = np.linspace(lo, hi, grid_n)
        X, Y = np.meshgrid(xs, xs)
        pts = torch.from_numpy(np.stack([X.ravel(), Y.ravel()], -1).astype(np.float32))
        v = _np(vector_field(t, pts)).reshape(grid_n, grid_n, 2)
        ax.streamplot(X, Y, v[..., 0], v[..., 1], color="gray", density=1.0, linewidth=0.7)
    ax.set_xticks([])
    ax.set_yticks([])
    return _finish(plt, fig, save_path)


def store_trajectories(traj: ArrayLike, path: str) -> str:
    """Save rollout trajectories as .npy."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, _np(traj))
    return path


def _timepoint_scatter(ax, obs) -> int:
    """A population coloured by timepoint: a list of (n_t, 2) arrays
    (jagged) or a (bs, T, 2) array. Returns T."""
    if isinstance(obs, (list, tuple)):
        data = [_np(o) for o in obs]
        ts = len(data)
        pts = np.concatenate(data, axis=0)
        cs = np.concatenate([np.full(len(o), t) for t, o in enumerate(data)])
    else:
        arr = _np(obs)
        bs, ts, _ = arr.shape
        pts = arr.reshape(-1, arr.shape[-1])
        cs = np.tile(np.arange(ts), bs)
    ax.scatter(pts[:, 0], pts[:, 1], s=3, c=cs, cmap="viridis", alpha=0.5)
    return ts


def plot_trajectory(obs, traj: ArrayLike, n: int = 200, save_path: Optional[str] = None):
    """The timepoint-coloured population and a rollout (steps, points, 2)
    over it: black flow dots, purple final markers, 20 red example paths."""
    plt = _plt()
    traj = _np(traj)
    fig, ax = plt.subplots(figsize=(6, 6))
    _timepoint_scatter(ax, obs)
    ax.scatter(traj[:, :n, 0], traj[:, :n, 1], s=0.3, alpha=0.2, c="black")
    ax.scatter(traj[-1, :n, 0], traj[-1, :n, 1], s=6, alpha=1.0, c="purple", marker="x")
    for i in range(min(20, traj.shape[1])):
        ax.plot(traj[:, i, 0], traj[:, i, 1], c="red", alpha=0.5)
    return _finish(plt, fig, save_path)


def plot_paths(obs, vector_field: Callable, n: int = 200, save_path: Optional[str] = None):
    """:func:`plot_trajectory` of ``vector_field`` integrated by Euler from
    the first marginal over global time [0, T - 1], max(20 T, 100) steps."""
    from cfm_tpu_torch.integrate import odeint

    start = (_np(obs[0]) if isinstance(obs, (list, tuple)) else _np(obs)[:, 0])[:n]
    ts_count = len(obs) if isinstance(obs, (list, tuple)) else _np(obs).shape[1]
    span = np.linspace(0.0, float(ts_count - 1), max(20 * ts_count, 100), dtype=np.float32)
    sol = odeint(vector_field, torch.from_numpy(np.asarray(start, np.float32)), span,
                 method="euler", return_trajectory=True)
    return plot_trajectory(obs, sol.ys, n=n, save_path=save_path)


def plot_graph_dist(graph_mean: ArrayLike, graph_thresh: ArrayLike, graph_std: ArrayLike,
                    ground_truth: ArrayLike, save_path: Optional[str] = None):
    """A posterior-graph panel: ground truth, the posterior mean, the
    thresholded graph and the per-edge std as (d, d) heat maps."""
    plt = _plt()
    panels = [("Ground Truth", ground_truth), ("Graph means", graph_mean),
              ("Graph post-threshold", graph_thresh), ("Graph std", graph_std)]
    fig, axs = plt.subplots(1, 4, figsize=(13, 4.5))
    for ax, (title, g) in zip(axs, panels):
        ax.set_title(title)
        pcm = ax.matshow(_np(g), cmap="viridis")
        fig.colorbar(pcm, ax=ax)
    return _finish(plt, fig, save_path)
