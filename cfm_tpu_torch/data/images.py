"""Image data: CIFAR-10 / MNIST loading, normalisation, flips, batching
(counterpart of ``cfm_tpu/data/images.py``).

The sets load as NHWC uint8 numpy arrays; the trainer moves the whole set to
the card once and normalises and flips each batch there. ``synthetic=True``
gives the JAX package's deterministic fake sets, byte for byte (the same
numpy generator and draws).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

_CIFAR_DIRS = ("cifar-10-batches-py", "cifar10/cifar-10-batches-py")


def _find(root: str, candidates) -> Optional[str]:
    for c in candidates:
        p = os.path.join(root, c)
        if os.path.exists(p):
            return p
    return None


def load_cifar10(data_dir: str = "data", train: bool = True, synthetic: bool = False,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 as (N, 32, 32, 3) uint8 and (N,) int32 labels."""
    if synthetic:
        rng = np.random.default_rng(seed)
        n = 2048
        return (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                rng.integers(0, 10, (n,), dtype=np.int32))
    base = _find(data_dir, _CIFAR_DIRS)
    if base is None:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {data_dir!r} (expected cifar-10-batches-py); "
            "pass synthetic=True for a fake set")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
        ys.append(np.asarray(d[b"labels"], np.int32))
    return np.ascontiguousarray(np.concatenate(xs).transpose(0, 2, 3, 1)), np.concatenate(ys)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">i", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "i" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist(data_dir: str = "data", train: bool = True, synthetic: bool = False,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST as (N, 28, 28, 1) uint8 and (N,) int32 labels."""
    if synthetic:
        rng = np.random.default_rng(seed)
        n = 2048
        return (rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8),
                rng.integers(0, 10, (n,), dtype=np.int32))
    prefix = "train" if train else "t10k"
    img = lab = None
    for root, _, names in os.walk(data_dir):
        for name in names:
            if name.startswith(f"{prefix}-images"):
                img = os.path.join(root, name)
            if name.startswith(f"{prefix}-labels"):
                lab = os.path.join(root, name)
    if img is None or lab is None:
        raise FileNotFoundError(f"MNIST idx files not found under {data_dir!r}; pass synthetic=True")
    return np.ascontiguousarray(_read_idx(img)[..., None]), _read_idx(lab).astype(np.int32)


def normalize_images(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return x_uint8.float() / 127.5 - 1.0


def random_hflip(generator: Optional[torch.Generator], x: torch.Tensor,
                 flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample horizontal flip with p = 0.5; ``flip`` (N,) bool are the
    draws, made from ``generator`` on x's device when not given."""
    if flip is None:
        flip = torch.rand(x.shape[0], generator=generator, device=x.device) < 0.5
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def infinite_batches(data: np.ndarray, labels: Optional[np.ndarray], batch_size: int,
                     seed: int = 0) -> Iterator:
    """Host-side infinite shuffled uint8 batches, drop-last."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n} — the "
                         "drop-last batching below would loop forever yielding nothing")
    while True:
        perm = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            idx = perm[start:start + batch_size]
            yield data[idx] if labels is None else (data[idx], labels[idx])
