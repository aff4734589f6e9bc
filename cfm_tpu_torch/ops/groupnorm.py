"""GroupNorm with float32 statistics and an optional fused SiLU.

Counterpart of ``_gn_silu_reference`` in ``cfm_tpu/ops/pallas_groupnorm.py``,
which is what the JAX UNet's ``GroupNorm32`` calls (its Pallas GroupNorm
kernels are not routed in the model). Plain PyTorch here too.
"""

from __future__ import annotations

import torch


def gn_silu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float = 1e-5,
                      apply_silu: bool = False) -> torch.Tensor:
    """x: (N, H, W, C) any float dtype; scale/bias: (C,). Two-pass statistics,
    affine and SiLU in float32, then cast back to ``x.dtype``."""
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(n, h * w, c)
    s1 = xf.mean(dim=1)                                          # (n, c)
    mean_c = s1.reshape(n, num_groups, cg).mean(dim=-1).repeat_interleave(cg, dim=-1)
    centered = xf - mean_c[:, None, :]
    s2 = centered.square().mean(dim=1)
    var = s2.reshape(n, num_groups, cg).mean(dim=-1)
    rstd_c = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1)
    out = (centered * rstd_c[:, None, :]).reshape(n, h, w, c)
    out = out * scale.float() + bias.float()
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)
