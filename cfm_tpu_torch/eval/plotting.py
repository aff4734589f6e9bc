"""Sample grids (counterpart of ``image_grid`` in ``cfm_tpu/eval/plotting.py``).

The grid is written as a PNG by hand (``zlib`` and ``struct``), with no
matplotlib or PIL: one pixel per image pixel, 8-bit grey for one channel,
RGB for three, no margins or axes.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Union

import numpy as np
import torch


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
