"""Device resolution and the float32 precision policy.

The port runs on the card. ``resolve_device()`` returns ``cuda`` and raises
when there is none; the CPU is used only when the caller asks for it with
``device="cpu"``, as the tests do. Nothing falls back to the CPU silently.

Precision: on the CPU every float32 op is true float32. On the card a float32
matmul is true float32 by default, but a float32 convolution goes through
cuDNN in TF32 (about three decimal digits). Runs that hold float32 results
against a reference wrap themselves in :func:`strict_f32`, which turns TF32
off for both and restores the previous setting on exit.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without a card); anything
    else as given, with a CUDA device's index filled in."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls, then restore."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
