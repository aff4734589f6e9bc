"""Small shared helpers (counterpart of ``cfm_tpu/utils.py``)."""

from __future__ import annotations

from typing import List, Union

import torch

Scalar = Union[float, int]


def pad_t_like_x(t: Union[torch.Tensor, Scalar], x: torch.Tensor) -> Union[torch.Tensor, Scalar]:
    """Reshape ``t`` (bs,) to broadcast against ``x`` (bs, *dim); Python
    scalars pass through unchanged."""
    if isinstance(t, (float, int)):
        return t
    t = torch.as_tensor(t, device=x.device)
    return t.reshape(-1, *([1] * (x.dim() - 1)))


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor], new_params: List[torch.Tensor],
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * new, for each pair of tensors.

    Unlike JAX's pure version this updates the f32 EMA tensors in place (one
    copy of the parameters instead of two), with PyTorch's multi-tensor
    arithmetic; the products and the sum are the same.
    """
    ema_params, new_params = list(ema_params), list(new_params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, new_params, alpha=1.0 - decay)


def flatten_batch(x: torch.Tensor) -> torch.Tensor:
    """(bs, *dim) -> (bs, prod(dim)); a 1-D input becomes (bs, 1)."""
    if x.dim() > 2:
        return x.reshape(x.shape[0], -1)
    if x.dim() == 1:
        return x[:, None]
    return x


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.mean(dim=tuple(range(1, x.dim())))
