"""Small vector-field networks for 2-D and tabular flow matching
(counterpart of ``cfm_tpu/models/mlp.py``): the tutorial's ``MLP``, the
configurable ``VelocityNet`` (optionally with flax-semantics batch norm),
``TimeInvariantVelocityNet``, ``SimpleDenseNet``, the scalar action
``_ActionNet`` and its gradient field ``GradModel``, and the input-convex
``ICNN`` with its ``transport`` map.

``model(t, x)`` with a batched time vector t (bs,) or a scalar, appended to
the features as the last input column where the JAX module appends it. The
layers are initialised as flax initialises ``nn.Dense``: a lecun-normal
kernel (a normal truncated at two standard deviations, scaled to variance
1/fan_in) and a zero bias, drawn from a CPU generator seeded with ``seed``;
PyTorch's own ``Linear`` initialisation differs, and the 2-D runs' quality
depends on it. Submodules carry the flax scope names (``Dense_0``,
``BatchNorm_0``, ``wz_0``, ...), so ``models/convert.py`` maps flax
variables by path.

``GradModel`` and ``ICNN.transport`` differentiate a scalar per sample; the
gradient keeps its graph (``create_graph``) whenever autograd is enabled
at the call, so a loss can differentiate through it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from cfm_tpu_torch.device import DeviceLike

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "selu": torch.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu: the tanh form
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
}

# flax's variance_scaling "truncated_normal": the std of a unit normal
# truncated to [-2, 2], which the draw is divided by.
_TRUNC_STD = 0.87962566103423978


def _join_tx(t: Union[torch.Tensor, float], x: torch.Tensor) -> torch.Tensor:
    """Append per-sample time to the features: (bs, d) -> (bs, d + 1)."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
    return torch.cat([x, t.expand(x.shape[0])[:, None]], dim=-1)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal()`` on a torch (out, in[, kh, kw]) weight: a
    standard normal truncated to [-2, 2] by inverse-CDF sampling, times
    sqrt(1 / fan_in) / 0.8796, fan_in = in * kh * kw."""
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    std = math.sqrt(1.0 / (weight[0].numel())) / _TRUNC_STD
    weight.copy_((z.clamp(-2.0, 2.0) * std).to(weight.dtype))


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Every parameter of ``module`` as flax initialises it, in module
    order: ``weight`` of a ``Linear``, a conv (``diffeq._Conv``) or a
    transposed conv lecun-normal; biases zero; norm scales one; the ICNN's
    ``wz_*`` normal(0.05); batch-norm statistics reset to mean 0, var 1."""
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "weight" and getattr(m, "flax_kind", "dense") == "norm":
                p.fill_(1.0)
            elif name == "weight":
                lecun_normal_(p, generator)
            elif name.startswith("wz_"):
                p.copy_(0.05 * torch.randn(p.shape, generator=generator, dtype=torch.float32))
            else:
                p.zero_()
        if getattr(m, "flax_kind", None) == "norm" and hasattr(m, "mean"):
            m.mean.zero_()
            m.var.fill_(1.0)


def _dense(n_in: int, n_out: int, device: DeviceLike, bias: bool = True) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=bias, device=device)


def _scalar_grad(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The gradient in x of sum(fn(x)): each sample's scalar differentiated
    in its own input (the modules here couple no samples). The graph is
    kept when autograd is enabled at the call."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xx = x if (create and x.requires_grad) else x.detach().requires_grad_(True)
        out = fn(xx)
        (g,) = torch.autograd.grad(out.sum(), xx, create_graph=create)
    return g


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis: in training, the batch's
    mean and its biased variance E[x^2] - E[x]^2 (clipped at 0, flax's fast
    variance) normalise, and the running statistics move by ``momentum``
    (0.99) toward them; otherwise the running statistics normalise.
    ``weight``/``bias`` are flax's ``scale``/``bias``, the buffers ``mean``
    and ``var`` its ``batch_stats``."""

    flax_kind = "norm"

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5,
                 device: DeviceLike = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
                self.var.copy_(m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        y = x - mean
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (y * mul + self.bias).to(x.dtype)


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


class VelocityNet(nn.Module):
    """The configurable t-concat MLP: in dim + 1 -> ``hidden_dims`` ->
    dim, each hidden layer ``Dense`` [-> ``BatchNorm``] -> activation."""

    def __init__(self, dim: int, hidden_dims: Sequence[int] = (64, 64, 64),
                 activation: str = "selu", batch_norm: bool = False, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dim, self.hidden_dims = dim, tuple(hidden_dims)
        self.activation, self.batch_norm = activation, batch_norm
        self.act = _ACTIVATIONS[activation]
        widths = (dim + 1,) + self.hidden_dims + (dim,)
        for k in range(len(widths) - 1):
            setattr(self, f"Dense_{k}", _dense(widths[k], widths[k + 1], device))
            if batch_norm and k < len(self.hidden_dims):
                setattr(self, f"BatchNorm_{k}", BatchNorm(widths[k + 1], device=device))
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, t: Union[torch.Tensor, float], x: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = _join_tx(t, x)
        for k in range(len(self.hidden_dims)):
            h = getattr(self, f"Dense_{k}")(h)
            if self.batch_norm:
                h = getattr(self, f"BatchNorm_{k}")(h, train=train)
            h = self.act(h)
        return getattr(self, f"Dense_{len(self.hidden_dims)}")(h)


class TimeInvariantVelocityNet(nn.Module):
    """A velocity net that ignores t: dim -> ``hidden_dims`` -> dim."""

    def __init__(self, dim: int, hidden_dims: Sequence[int] = (64, 64, 64),
                 activation: str = "selu", seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.dim, self.hidden_dims, self.activation = dim, tuple(hidden_dims), activation
        self.act = _ACTIVATIONS[activation]
        widths = (dim,) + self.hidden_dims + (dim,)
        for k in range(len(widths) - 1):
            setattr(self, f"Dense_{k}", _dense(widths[k], widths[k + 1], device))
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, t, x: torch.Tensor) -> torch.Tensor:
        del t
        h = x
        for k in range(len(self.hidden_dims)):
            h = self.act(getattr(self, f"Dense_{k}")(h))
        return getattr(self, f"Dense_{len(self.hidden_dims)}")(h)


class SimpleDenseNet(nn.Module):
    """A plain feature MLP over the flattened input, for classification heads."""

    def __init__(self, input_size: int = 784, hidden_dims: Sequence[int] = (256, 256, 256),
                 output_size: int = 10, activation: str = "relu", seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.hidden_dims, self.act = tuple(hidden_dims), _ACTIVATIONS[activation]
        widths = (input_size,) + self.hidden_dims + (output_size,)
        for k in range(len(widths) - 1):
            setattr(self, f"Dense_{k}", _dense(widths[k], widths[k + 1], device))
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
        for k in range(len(self.hidden_dims)):
            h = self.act(getattr(self, f"Dense_{k}")(h))
        return getattr(self, f"Dense_{len(self.hidden_dims)}")(h)


class _ActionNet(nn.Module):
    """The scalar action s(t, x), (bs, 1): three SELU layers of width w over
    [x, t]. ``dim`` is x's width (flax infers it)."""

    def __init__(self, dim: int, w: int = 64, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.dim, self.w = dim, w
        widths = (dim + 1, w, w, w, 1)
        for k in range(4):
            setattr(self, f"Dense_{k}", _dense(widths[k], widths[k + 1], device))
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, t: Union[torch.Tensor, float], x: torch.Tensor) -> torch.Tensor:
        h = _join_tx(t, x)
        for k in range(3):
            h = torch.selu(getattr(self, f"Dense_{k}")(h))
        return self.Dense_3(h)


class GradModel(nn.Module):
    """A vector field as the gradient in x of a scalar action:
    v(t, x) = d s(t, x) / dx, each sample's own."""

    def __init__(self, dim: int, w: int = 64, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.w = w
        self.action = _ActionNet(dim, w, seed=seed, device=device)

    def forward(self, t: Union[torch.Tensor, float], x: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1).expand(x.shape[0])
        return _scalar_grad(lambda xx: self.action(t, xx), x)


class ICNN(nn.Module):
    """An input-convex network f(x), (bs, 1): z_1 = softplus(Dense_0 x),
    z_{k+1} = softplus(z_k softplus(wz_k) + Dense_k x), out
    z softplus(wz_out) + |x|^2 / 2. The ``wz`` weights are (in, out) as in
    flax and pass through softplus at apply time, so f is convex by
    construction."""

    def __init__(self, dim: int, hidden_dims: Sequence[int] = (64, 64, 64, 64), seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.dim, self.hidden_dims = dim, tuple(hidden_dims)
        hd = self.hidden_dims
        self.Dense_0 = _dense(dim, hd[0], device)
        for k, width in enumerate(hd[1:]):
            setattr(self, f"wz_{k}", nn.Parameter(torch.empty(hd[k], width, device=device)))
            setattr(self, f"Dense_{k + 1}", _dense(dim, width, device))
        self.wz_out = nn.Parameter(torch.empty(hd[-1], 1, device=device))
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = F.softplus(self.Dense_0(x))
        for k in range(len(self.hidden_dims) - 1):
            wz = getattr(self, f"wz_{k}")
            z = F.softplus(z @ F.softplus(wz) + getattr(self, f"Dense_{k + 1}")(x))
        quad = 0.5 * torch.sum(torch.square(x), dim=-1, keepdim=True)
        return z @ F.softplus(self.wz_out) + quad

    def transport(self, x: torch.Tensor) -> torch.Tensor:
        """The OT map as the gradient of the convex potential, T(x) = grad f(x)."""
        return _scalar_grad(self, x)
