"""Multi-head self-attention on the kernel layout (N, 3, H, S, D) -> (N, H, S, D).

Counterpart of ``fused_attention_t`` in ``cfm_tpu/ops/pallas_attention.py``.
The JAX package sends a shape to its Pallas kernel only when ``_gate``
admits it (S % 128 == 0, D % 64 == 0, within a footprint budget) and
computes every other shape with the plain composition ported here as
:func:`attn_reference_t`. The AttentionBlock reaches this module only where
the fused-block gate fails: at the CIFAR-10 recipe that is ``mid_attn`` at
4x4 (S = 16), which the plain composition serves on either package.

The kernel itself is not ported yet. For a CUDA tensor of a shape the gate
would admit, :func:`attention_t` raises ``NotImplementedError`` rather than
run the plain composition in the kernel's place.
"""

from __future__ import annotations

import torch

_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def _vmem_bytes(H: int, S: int, D: int, itemsize: int) -> int:
    return itemsize * 7 * H * S * D + 4 * (3 * S * S + 4 * S * D)


def gate(H: int, S: int, D: int, dtype: torch.dtype) -> bool:
    """The JAX ``_gate`` without its backend clause: shapes the Pallas
    attention kernel takes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    aligned = S % 128 == 0 and D % 64 == 0
    return aligned and _vmem_bytes(H, S, D, itemsize) <= _VMEM_BUDGET_BYTES


def attn_reference_t(qkv_t: torch.Tensor, scale: float) -> torch.Tensor:
    """Logits and softmax in float32, weights rounded to the input dtype, then
    the value product accumulated in float32 and rounded."""
    q, k, v = qkv_t[:, 0], qkv_t[:, 1], qkv_t[:, 2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(qkv_t.dtype)
    return (w.float() @ v.float()).to(qkv_t.dtype)


def attention_t(qkv_t: torch.Tensor, scale: float) -> torch.Tensor:
    """(N, 3, H, S, D) -> (N, H, S, D)."""
    _, _, H, S, D = qkv_t.shape
    if qkv_t.device.type == "cuda" and gate(H, S, D, qkv_t.dtype):
        raise NotImplementedError(
            f"attention at H={H}, S={S}, D={D} takes the Pallas kernel "
            "cfm_tpu/ops/pallas_attention.py:fused_attention_t in the JAX "
            "package, which is not ported to CUDA yet")
    return attn_reference_t(qkv_t, scale)
