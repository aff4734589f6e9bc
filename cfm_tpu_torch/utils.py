"""Small shared helpers (counterpart of ``cfm_tpu/utils.py``)."""

from __future__ import annotations

from typing import Iterable, List, Tuple, Union

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


def count_params(params: Union[torch.nn.Module, Iterable[torch.Tensor]]) -> int:
    """The number of scalar parameters of a module or a list of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(p.numel() for p in params)


def param_summary(named: Union[torch.nn.Module, Iterable[Tuple[str, torch.Tensor]]],
                  max_depth: int = 1) -> str:
    """A table of parameter counts grouped by the first ``max_depth``
    components of each parameter's dotted module path (a module's
    ``named_parameters()``), sorted by name and ending with the total."""
    if isinstance(named, torch.nn.Module):
        named = named.named_parameters()
    groups: dict = {}
    for name, p in named:
        key = ".".join(name.split(".")[:max_depth]) or "(root)"
        groups[key] = groups.get(key, 0) + p.numel()
    width = max(map(len, groups)) if groups else 6
    lines = [f"{name:<{width}}  {cnt:>12,}" for name, cnt in sorted(groups.items())]
    lines.append(f"{'TOTAL':<{width}}  {sum(groups.values()):>12,}")
    return "\n".join(lines)


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
