"""The FID protocol pieces shared by generation and evaluation.

Counterpart of ``cfm_tpu/eval/protocol.py``.
"""

from __future__ import annotations

import torch


def quantize_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Generated [-1, 1] images -> uint8: ``x * 127.5 + 128``, clipped to
    [0, 255], then truncated (the reference's FID formula)."""
    return torch.clamp(x * 127.5 + 128.0, 0.0, 255.0).to(torch.uint8)
