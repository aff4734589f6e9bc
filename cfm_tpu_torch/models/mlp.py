"""The 2-D tutorial's vector field (counterpart of ``cfm_tpu/models/mlp.py``
``MLP``): three SELU hidden layers of width ``w`` and a linear output.

``model(t, x)`` with a batched time vector t (bs,) or a scalar, appended to
the features as the last input column when ``time_varying``. The layers are
initialised as flax initialises ``nn.Dense``: a lecun-normal kernel (a normal
truncated at two standard deviations, scaled to variance 1/fan_in) and a
zero bias, drawn from a CPU generator seeded with ``seed``; PyTorch's own
``Linear`` initialisation differs, and the 2-D runs' quality depends on it.

``VelocityNet``, ``GradModel``, ``ICNN`` and the rest of the JAX module wait
for ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from cfm_tpu_torch.device import DeviceLike

# flax's variance_scaling "truncated_normal": the std of a unit normal
# truncated to [-2, 2], which the draw is divided by.
_TRUNC_STD = 0.87962566103423978


def _join_tx(t: Union[torch.Tensor, float], x: torch.Tensor) -> torch.Tensor:
    """Append per-sample time to the features: (bs, d) -> (bs, d + 1)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
    return torch.cat([x, t.expand(x.shape[0])[:, None]], dim=-1)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal()`` on a torch (out, in) weight: a standard
    normal truncated to [-2, 2] by inverse-CDF sampling, times
    sqrt(1 / fan_in) / 0.8796."""
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    weight.copy_((z.clamp(-2.0, 2.0) * std).to(weight.dtype))


class MLP(nn.Module):
    """3-hidden-layer SELU MLP; ``Dense_0`` .. ``Dense_3`` as in flax."""

    def __init__(self, dim: int, out_dim: Optional[int] = None, w: int = 64,
                 time_varying: bool = True, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.dim, self.out_dim, self.w, self.time_varying = dim, out_dim, w, time_varying
        widths = [dim + (1 if time_varying else 0), w, w, w, out_dim or dim]
        for k in range(4):
            setattr(self, f"Dense_{k}", nn.Linear(widths[k], widths[k + 1], device=device))
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for k in range(4):
            layer = getattr(self, f"Dense_{k}")
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def forward(self, t: Union[torch.Tensor, float], x: torch.Tensor) -> torch.Tensor:
        h = _join_tx(t, x) if self.time_varying else x
        for k in range(3):
            h = torch.selu(getattr(self, f"Dense_{k}")(h))
        return self.Dense_3(h)
