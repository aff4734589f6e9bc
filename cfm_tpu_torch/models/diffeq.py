"""Time-conditioned layers for CNF / FFJORD drift nets (counterpart of
``cfm_tpu/models/diffeq.py``).

The linear family (``IgnoreLinear`` ... ``BlendLinear``, ``ODEnet``,
``GatedLinear``) over (bs, d); the conv family (seven conv layer types,
``HyperConv2d``, ``GatedConv``, ``GatedConvTranspose``, ``ConvODEnet``) in
NHWC like the rest of the port; the containers; ``BasicResBlock`` and
``ResNetDiffEq``; ``squeeze2d``/``unsqueeze2d``, ``SqueezeLayer`` and
``AutoencoderDiffEqNet``. Every time-conditioned module is called
``module(t, x)`` with t a scalar or a (bs,) vector.

flax infers a layer's input width at its first call; a torch layer takes it
at construction (``in_dim`` / ``in_channels``, the first argument where the
JAX module has none). Submodules carry the flax scope names (``Dense_0``,
``Conv_0``, ``ConcatConv2d_1``, ``layers_0``, ...) so ``models/convert.py``
maps flax variables by path, and every module draws flax's initialisation
(lecun-normal kernels, zero biases, unit norm scales) from ``seed``.

Convolutions keep flax's semantics: "SAME" padding is ceil(in / stride)
outputs with the total padding split low = total // 2 (so k = 4, s = 2 on
an odd size pads one more at the end); ``ConvTranspose`` applies its kernel
unflipped (``transpose_kernel=False``) to the input dilated by the stride,
padded by (k + s - 2) split as ``lax.conv_transpose`` splits it, for
in * stride outputs.

The GroupNorms of ``BasicResBlock`` and ``ResNetDiffEq`` (min(16, C) groups,
eps 1e-4, float32, no SiLU) go through ``ops.groupnorm.fused_group_norm_silu``:
the hand-written kernels #8 forward and #9 backward on the card, the plain
versions on the CPU, under ``torch.func``'s per-sample traces too.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from cfm_tpu_torch.device import DeviceLike
from cfm_tpu_torch.models.mlp import _dense, flax_init_
from cfm_tpu_torch.ops.groupnorm import fused_group_norm_silu

TimeLike = Union[torch.Tensor, float]

_NONLINEARITIES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "softplus": F.softplus,
    "elu": F.elu,
    "swish": F.silu,
    "square": torch.square,
    "identity": lambda x: x,
}


def _t_vec(t: TimeLike, x: torch.Tensor) -> torch.Tensor:
    """Scalar or batch time as a (bs,) vector of x's dtype."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
    return t.expand(x.shape[0]) if t.shape[0] == 1 else t


def _t_col(t: TimeLike, x: torch.Tensor) -> torch.Tensor:
    """Broadcast scalar or batch time to a (bs, 1) column."""
    return _t_vec(t, x)[:, None]


def _init(module: nn.Module, seed: int) -> None:
    flax_init_(module, torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# The linear family.
# ---------------------------------------------------------------------------


class IgnoreLinear(nn.Module):
    """A plain linear layer; t is ignored."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, out_dim, device)
        _init(self, seed)

    def forward(self, t, x):
        return self.Dense_0(x)


class ConcatLinear(nn.Module):
    """Linear over [x, t]."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim + 1, out_dim, device)
        _init(self, seed)

    def forward(self, t, x):
        return self.Dense_0(torch.cat([x, _t_col(t, x)], dim=-1))


class ConcatLinear_v2(nn.Module):
    """Linear(x) + a bias linear in t."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, out_dim, device)
        self.Dense_1 = _dense(1, out_dim, device, bias=False)
        _init(self, seed)

    def forward(self, t, x):
        return self.Dense_0(x) + self.Dense_1(_t_col(t, x))


class SquashLinear(nn.Module):
    """Linear(x) * sigmoid(gate(t))."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, out_dim, device)
        self.Dense_1 = _dense(1, out_dim, device)
        _init(self, seed)

    def forward(self, t, x):
        return self.Dense_0(x) * torch.sigmoid(self.Dense_1(_t_col(t, x)))


class ConcatSquashLinear(nn.Module):
    """Linear(x) * sigmoid(gate(t)) + bias(t), the FFJORD default."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, out_dim, device)
        self.Dense_1 = _dense(1, out_dim, device)
        self.Dense_2 = _dense(1, out_dim, device, bias=False)
        _init(self, seed)

    def forward(self, t, x):
        tc = _t_col(t, x)
        return self.Dense_0(x) * torch.sigmoid(self.Dense_1(tc)) + self.Dense_2(tc)


class HyperLinear(nn.Module):
    """Weights and bias generated from t by a hypernetwork
    (1 -> ``hyper_hidden`` -> tanh -> d * out + out)."""

    def __init__(self, in_dim: int, out_dim: int, hyper_hidden: int = 32, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.Dense_0 = _dense(1, hyper_hidden, device)
        self.Dense_1 = _dense(hyper_hidden, in_dim * out_dim + out_dim, device)
        _init(self, seed)

    def forward(self, t, x):
        d, o = self.in_dim, self.out_dim
        wb = self.Dense_1(torch.tanh(self.Dense_0(_t_col(t, x))))
        w = wb[:, :d * o].reshape(-1, d, o)
        return torch.einsum("nd,ndo->no", x, w) + wb[:, d * o:]


class BlendLinear(nn.Module):
    """(1 - t) W0 x + t W1 x, written y0 + t (y1 - y0)."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, out_dim, device)
        self.Dense_1 = _dense(in_dim, out_dim, device)
        _init(self, seed)

    def forward(self, t, x):
        y0, y1 = self.Dense_0(x), self.Dense_1(x)
        return y0 + _t_col(t, x) * (y1 - y0)


_LAYER_TYPES = {
    "ignore": IgnoreLinear,
    "concat": ConcatLinear,
    "concat_v2": ConcatLinear_v2,
    "squash": SquashLinear,
    "concatsquash": ConcatSquashLinear,
    "hyper": HyperLinear,
    "blend": BlendLinear,
}


class ODEnet(nn.Module):
    """A stack of time-conditioned linear layers with a nonlinearity
    between: in_dim -> ``hidden_dims`` -> out_dim, the standard CNF drift."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 layer_type: str = "concatsquash", nonlinearity: str = "tanh", seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cls = _LAYER_TYPES[layer_type]
        self.act = _NONLINEARITIES[nonlinearity]
        widths = (in_dim,) + tuple(hidden_dims) + (out_dim,)
        self.names = [f"{cls.__name__}_{i}" for i in range(len(widths) - 1)]
        for i, name in enumerate(self.names):
            setattr(self, name, cls(widths[i], widths[i + 1], device=device))
        _init(self, seed)

    def forward(self, t, x):
        h = x
        for name in self.names[:-1]:
            h = self.act(getattr(self, name)(t, h))
        return getattr(self, self.names[-1])(t, h)


class GatedLinear(nn.Module):
    """f(x) * sigmoid(g(x)), time-free."""

    def __init__(self, in_dim: int, out_dim: int, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, out_dim, device)
        self.Dense_1 = _dense(in_dim, out_dim, device)
        _init(self, seed)

    def forward(self, x):
        return self.Dense_0(x) * torch.sigmoid(self.Dense_1(x))


# ---------------------------------------------------------------------------
# The conv family, NHWC.
# ---------------------------------------------------------------------------


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/lax "SAME" padding of one spatial axis: ceil(size / s) outputs,
    the total split low = total // 2, high = the rest."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s "SAME" padding of the dilated input:
    k + s - 2 in all, low k - 1 where s > k - 1, else ceil(half)."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


class _Conv(nn.Module):
    """flax ``nn.Conv`` with "SAME" padding (and ``feature_group_count``) on
    NHWC. ``weight`` (out, in / groups, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, ksize=3, stride=1, groups: int = 1,
                 use_bias: bool = True, device: DeviceLike = None):
        super().__init__()
        self.k, self.s, self.groups = _pair(ksize), _pair(stride), groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, *self.k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (ph0, ph1), (pw0, pw1) = (same_padding(x.shape[1 + i], self.k[i], self.s[i])
                                  for i in range(2))
        h = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
        y = F.conv2d(h, self.weight, self.bias, stride=self.s, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class _ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with "SAME" padding on NHWC: the kernel,
    unflipped, correlated with the input dilated by the stride and padded by
    :func:`transpose_padding`, for in * stride outputs. ``weight`` is that
    correlation's (out, in, kh, kw) kernel."""

    def __init__(self, in_ch: int, out_ch: int, ksize=3, stride=1, use_bias: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        self.k, self.s = _pair(ksize), _pair(stride)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [transpose_padding(self.k[i], self.s[i]) for i in range(2)]
        h = x.permute(0, 3, 1, 2)
        if all(lo == hi for lo, hi in pads):
            # The transpose of a correlation with the flipped kernel is the
            # correlation of the dilated input: one library call.
            w = self.weight.flip(2, 3).transpose(0, 1)
            y = F.conv_transpose2d(h, w, self.bias, stride=self.s,
                                   padding=tuple(k - 1 - lo for k, (lo, _) in zip(self.k, pads)))
        else:
            n, c, hh, ww = h.shape
            dil = h.new_zeros(n, c, (hh - 1) * self.s[0] + 1, (ww - 1) * self.s[1] + 1)
            dil[:, :, ::self.s[0], ::self.s[1]] = h
            (ph0, ph1), (pw0, pw1) = pads
            y = F.conv2d(F.pad(dil, (pw0, pw1, ph0, ph1)), self.weight, self.bias)
        return y.permute(0, 2, 3, 1)


def _conv(in_ch: int, out_ch: int, ksize, stride, transpose: bool, groups: int = 1,
          use_bias: bool = True, device: DeviceLike = None) -> nn.Module:
    if transpose:
        return _ConvTranspose(in_ch, out_ch, ksize, stride, use_bias, device)
    return _Conv(in_ch, out_ch, ksize, stride, groups, use_bias, device)


def _conv_name(transpose: bool) -> str:
    return "ConvTranspose_0" if transpose else "Conv_0"


def _t_plane(t: TimeLike, x: torch.Tensor) -> torch.Tensor:
    """Time broadcast to an (n, h, w, 1) feature plane."""
    return _t_vec(t, x)[:, None, None, None].expand(*x.shape[:3], 1)


def _t_chan(dense: nn.Linear, t: TimeLike, x: torch.Tensor) -> torch.Tensor:
    """Dense(t) broadcast over space: (n, 1, 1, out)."""
    return dense(_t_col(t, x))[:, None, None, :]


class _ConvLayer(nn.Module):
    """The shared constructor of the seven conv layer types: the conv over
    ``in_channels + extra`` channels, under flax's name."""

    extra = 0

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3, stride: int = 1,
                 transpose: bool = False, use_bias: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.conv_name = _conv_name(transpose)
        setattr(self, self.conv_name, _conv(in_channels + self.extra, out_channels, ksize, stride,
                                            transpose, use_bias=use_bias, device=device))
        self.build(out_channels, device)
        _init(self, seed)

    def build(self, out_channels: int, device: DeviceLike) -> None:
        pass

    def conv(self, x):
        return getattr(self, self.conv_name)(x)


class IgnoreConv2d(_ConvLayer):
    def forward(self, t, x):
        return self.conv(x)


class ConcatConv2d(_ConvLayer):
    """Conv over [t-plane, x] channels."""

    extra = 1

    def forward(self, t, x):
        return self.conv(torch.cat([_t_plane(t, x), x], dim=-1))


class ConcatConv2d_v2(_ConvLayer):
    """Conv(x) + a per-channel bias linear in t."""

    def build(self, out_channels, device):
        self.Dense_0 = _dense(1, out_channels, device, bias=False)

    def forward(self, t, x):
        return self.conv(x) + _t_chan(self.Dense_0, t, x)


class SquashConv2d(_ConvLayer):
    """Conv([t, x]) * sigmoid(gate(t))."""

    extra = 1

    def build(self, out_channels, device):
        self.Dense_0 = _dense(1, out_channels, device)

    def forward(self, t, x):
        y = self.conv(torch.cat([_t_plane(t, x), x], dim=-1))
        return y * torch.sigmoid(_t_chan(self.Dense_0, t, x))


class ConcatSquashConv2d(_ConvLayer):
    """Conv(x) * sigmoid(gate(t)) + bias(t)."""

    def build(self, out_channels, device):
        self.gate = _dense(1, out_channels, device)
        self.bias = _dense(1, out_channels, device, bias=False)

    def forward(self, t, x):
        return (self.conv(x) * torch.sigmoid(_t_chan(self.gate, t, x))
                + _t_chan(self.bias, t, x))


class ConcatCoordConv2d(_ConvLayer):
    """Conv over [x, t-plane, row-plane, col-plane]."""

    extra = 3

    def forward(self, t, x):
        n, h, w, _ = x.shape
        hh = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None, None].expand(n, h, w, 1)
        ww = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :, None].expand(n, h, w, 1)
        return self.conv(torch.cat([x, _t_plane(t, x), hh, ww], dim=-1))


class BlendConv2d(nn.Module):
    """y0 + t (y1 - y0) over two convs, ``conv0`` and ``conv1``."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3, stride: int = 1,
                 transpose: bool = False, use_bias: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.conv0 = _conv(in_channels, out_channels, ksize, stride, transpose,
                           use_bias=use_bias, device=device)
        self.conv1 = _conv(in_channels, out_channels, ksize, stride, transpose,
                           use_bias=use_bias, device=device)
        _init(self, seed)

    def forward(self, t, x):
        y0, y1 = self.conv0(x), self.conv1(x)
        return y0 + _t_vec(t, x)[:, None, None, None] * (y1 - y0)


class HyperConv2d(nn.Module):
    """A conv whose kernel and bias are generated from t by one Dense. The
    batch's first t is the scalar (the kernel is shared by the batch)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        self.in_channels, self.out_channels, self.ksize = in_channels, out_channels, ksize
        n_w = ksize * ksize * in_channels * out_channels
        self.Dense_0 = _dense(1, n_w + out_channels, device)
        _init(self, seed)

    def forward(self, t, x):
        k, ci, co = self.ksize, self.in_channels, self.out_channels
        n_w = k * k * ci * co
        t0 = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)[:1]
        wb = self.Dense_0(t0[:, None])[0]
        w = wb[:n_w].reshape(k, k, ci, co).permute(3, 2, 0, 1)  # HWIO -> OIHW
        (ph0, ph1), (pw0, pw1) = (same_padding(x.shape[1 + i], k, 1) for i in range(2))
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1)), w)
        return y.permute(0, 2, 3, 1) + wb[n_w:]


class GatedConv(nn.Module):
    """f(x) * sigmoid(g(x)), conv form (convs ``f`` and ``g``)."""

    transpose = False

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3, stride: int = 1,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__()
        self.f = _conv(in_channels, out_channels, ksize, stride, self.transpose, device=device)
        self.g = _conv(in_channels, out_channels, ksize, stride, self.transpose, device=device)
        _init(self, seed)

    def forward(self, x):
        return self.f(x) * torch.sigmoid(self.g(x))


class GatedConvTranspose(GatedConv):
    """The transposed-conv gated pair."""

    transpose = True


_CONV_LAYER_TYPES = {
    "ignore": IgnoreConv2d,
    "concat": ConcatConv2d,
    "concat_v2": ConcatConv2d_v2,
    "squash": SquashConv2d,
    "concatsquash": ConcatSquashConv2d,
    "concatcoord": ConcatCoordConv2d,
    "blend": BlendConv2d,
}


def _strided(cls, c_in: int, c_out: int, s: int, device: DeviceLike) -> nn.Module:
    """A conv layer by FFJORD's stride convention: 1, 2 (k = 4 down) or -2
    (k = 4 transposed up)."""
    if s == 1:
        return cls(c_in, c_out, device=device)
    if s == 2:
        return cls(c_in, c_out, ksize=4, stride=2, device=device)
    if s == -2:
        return cls(c_in, c_out, ksize=4, stride=2, transpose=True, device=device)
    raise ValueError(f"Unsupported stride: {s}")


class ConvODEnet(nn.Module):
    """A conv stack of time-conditioned layers, the image CNF drift: NHWC,
    ``strides`` (len(hidden) + 1 entries of 1, 2, -2) as FFJORD's, and
    ``num_squeeze`` space-to-depth steps before the stack and depth-to-space
    after it (the stack sees in_channels * 4^num_squeeze channels, and its
    ``out_channels`` leave as out_channels / 4^num_squeeze)."""

    def __init__(self, in_channels: int, hidden_channels: Sequence[int], out_channels: int,
                 layer_type: str = "concatsquash", nonlinearity: str = "softplus",
                 strides: Optional[Sequence[int]] = None, num_squeeze: int = 0, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cls = _CONV_LAYER_TYPES[layer_type]
        self.act = _NONLINEARITIES[nonlinearity]
        self.num_squeeze = num_squeeze
        widths = tuple(hidden_channels) + (out_channels,)
        strides = tuple(strides or (1,) * len(widths))
        if len(strides) != len(widths):
            raise ValueError("need len(hidden) + 1 strides")
        c = in_channels * 4 ** num_squeeze
        self.names = []
        for i, (ch, s) in enumerate(zip(widths, strides)):
            self.names.append(f"{cls.__name__}_{i}")
            setattr(self, self.names[-1], _strided(cls, c, ch, s, device))
            c = ch
        _init(self, seed)

    def forward(self, t, x):
        h = x
        for _ in range(self.num_squeeze):
            h = squeeze2d(h, 2)
        for i, name in enumerate(self.names):
            h = getattr(self, name)(t, h)
            if i < len(self.names) - 1:
                h = self.act(h)
        for _ in range(self.num_squeeze):
            h = unsqueeze2d(h, 2)
        return h


# ---------------------------------------------------------------------------
# Containers and wrappers.
# ---------------------------------------------------------------------------


class DiffEqWrapper(nn.Module):
    """Adapts a time-free ``x -> y`` module to ``(t, x) -> y`` by dropping t."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, t, x):
        return self.module(x)


def diffeq_wrap(layer: nn.Module) -> nn.Module:
    """Wraps a time-free layer in :class:`DiffEqWrapper`."""
    return DiffEqWrapper(layer)


class SequentialDiffEq(nn.Module):
    """A chain of (t, x) layers sharing the same t (``layers_0``, ...)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.n = len(layers)
        for i, layer in enumerate(layers):
            setattr(self, f"layers_{i}", layer)

    def forward(self, t, x):
        for i in range(self.n):
            x = getattr(self, f"layers_{i}")(t, x)
        return x


class MixtureODELayer(nn.Module):
    """dy = sum_i w_i(t) f_i(t, y): experts ``experts_0``, ... mixed by
    ``mixture_weights``, a Dense of t; each sample weighted by its own t."""

    def __init__(self, experts: Sequence[nn.Module], seed: int = 0, device: DeviceLike = None):
        super().__init__()
        if len(experts) <= 1:
            raise ValueError("a mixture needs more than one expert")
        self.n = len(experts)
        for i, e in enumerate(experts):
            setattr(self, f"experts_{i}", e)
        self.mixture_weights = _dense(1, self.n, device)
        flax_init_(self.mixture_weights, torch.Generator().manual_seed(seed))

    def forward(self, t, x):
        dys = torch.stack([getattr(self, f"experts_{i}")(t, x) for i in range(self.n)])
        w = self.mixture_weights(_t_col(t, x)).T                 # (E, bs)
        w = w.reshape(w.shape + (1,) * (dys.dim() - 2))
        return torch.sum(dys * w, dim=0)


class ReshapeDiffEq(nn.Module):
    """Views a flat (bs, prod(shape)) state as ``input_shape`` for an inner
    (t, x) net, then flattens its output back."""

    def __init__(self, input_shape: Sequence[int], net: nn.Module):
        super().__init__()
        self.input_shape, self.net = tuple(input_shape), net

    def forward(self, t, x):
        bs = x.shape[0]
        return self.net(t, x.reshape(bs, *self.input_shape)).reshape(bs, -1)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` in float32 over NHWC, through the port's
    GroupNorm kernels (``fused_group_norm_silu`` without the SiLU)."""

    flax_kind = "norm"

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-4,
                 device: DeviceLike = None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        return fused_group_norm_silu(x.float().contiguous(), self.weight, self.bias,
                                     self.num_groups, self.eps, apply_silu=False)


class BasicResBlock(nn.Module):
    """Pre-activation residual block: GN -> relu -> conv -> GN -> relu ->
    conv, plus x. min(16, dim) groups, eps 1e-4, float32 statistics."""

    def __init__(self, dim: int, conv_layer: str = "concatcoord", seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        cls = _CONV_LAYER_TYPES[conv_layer]
        groups = min(16, dim)
        self.conv_names = [f"{cls.__name__}_{i}" for i in range(2)]
        self.GroupNorm_0 = GroupNorm(dim, groups, device=device)
        self.GroupNorm_1 = GroupNorm(dim, groups, device=device)
        for name in self.conv_names:
            setattr(self, name, cls(dim, dim, use_bias=False, device=device))
        _init(self, seed)

    def forward(self, t, x):
        c0, c1 = (getattr(self, n) for n in self.conv_names)
        h = c0(t, torch.relu(self.GroupNorm_0(x)))
        h = c1(t, torch.relu(self.GroupNorm_1(h)))
        return h + x


class ResNetDiffEq(nn.Module):
    """A residual CNF drift: lift to ``intermediate_dim``, ``n_resblocks``
    blocks, GN + relu, a 1x1 projection back to ``dim`` channels."""

    def __init__(self, dim: int, intermediate_dim: int, n_resblocks: int,
                 conv_layer: str = "concatcoord", seed: int = 0, device: DeviceLike = None):
        super().__init__()
        cls = _CONV_LAYER_TYPES[conv_layer]
        self.n_resblocks = n_resblocks
        self.conv_names = [f"{cls.__name__}_{i}" for i in range(2)]
        setattr(self, self.conv_names[0], cls(dim, intermediate_dim, use_bias=False,
                                              device=device))
        for i in range(n_resblocks):
            setattr(self, f"BasicResBlock_{i}", BasicResBlock(intermediate_dim, conv_layer,
                                                              device=device))
        self.GroupNorm_0 = GroupNorm(intermediate_dim, min(16, intermediate_dim), device=device)
        setattr(self, self.conv_names[1], cls(intermediate_dim, dim, ksize=1, use_bias=False,
                                              device=device))
        _init(self, seed)

    def forward(self, t, x):
        h = getattr(self, self.conv_names[0])(t, x)
        for i in range(self.n_resblocks):
            h = getattr(self, f"BasicResBlock_{i}")(t, h)
        return getattr(self, self.conv_names[1])(t, torch.relu(self.GroupNorm_0(h)))


# ---------------------------------------------------------------------------
# Squeeze (space-to-depth), NHWC: volume-preserving, the log-density passes.
# ---------------------------------------------------------------------------


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(n, H r, W r, c) -> (n, H, W, c r^2), channels in NHWC's (r, r, c)
    order (``F.pixel_unshuffle`` gives NCHW's (c, r, r))."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, c * r * r)


def unsqueeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(n, H, W, c r^2) -> (n, H r, W r, c), the inverse of :func:`squeeze2d`."""
    n, h, w, c = x.shape
    r = factor
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


class SqueezeLayer(nn.Module):
    """The invertible squeeze with the log-density passed through (|det J| = 1)."""

    def __init__(self, downscale_factor: int = 2):
        super().__init__()
        self.downscale_factor = downscale_factor

    def forward(self, x, logpx=None, reverse: bool = False):
        y = (unsqueeze2d if reverse else squeeze2d)(x, self.downscale_factor)
        return y if logpx is None else (y, logpx)


class AutoencoderDiffEqNet(nn.Module):
    """An encoder/decoder drift returning (h, dx), the bottleneck activation
    and the drift, for FFJORD's autoencoder trace estimator: the first
    len(hidden) // 2 + 1 layers encode (a nonlinearity after each), the rest
    decode (between them, none after the last). ``conv=False``: the linear
    family over (bs, in_dim); ``conv=True``: the NHWC conv family with
    FFJORD's strides, ``in_dim`` the input channels."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
                 conv: bool = False, layer_type: str = "concat", nonlinearity: str = "softplus",
                 strides: Optional[Sequence[int]] = None, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        if layer_type not in ("ignore", "squash", "concat", "concatcoord", "blend"):
            raise ValueError(f"unsupported layer_type {layer_type!r}")
        self.act = _NONLINEARITIES[nonlinearity]
        widths = tuple(hidden_dims) + (out_dim,)
        self.n_enc = len(hidden_dims) // 2 + 1
        strides = tuple(strides or (1,) * len(widths))
        if len(strides) != len(widths):
            raise ValueError("need len(hidden) + 1 strides")
        cls = (_CONV_LAYER_TYPES[layer_type] if conv else
               _LAYER_TYPES["concat" if layer_type == "concatcoord" else layer_type])
        self.names, c = [], in_dim
        for i, (w, s) in enumerate(zip(widths, strides)):
            self.names.append(f"{cls.__name__}_{i}")
            layer = _strided(cls, c, w, s, device) if conv else cls(c, w, device=device)
            setattr(self, self.names[-1], layer)
            c = w
        _init(self, seed)

    def forward(self, t, x):
        h = x
        for name in self.names[:self.n_enc]:
            h = self.act(getattr(self, name)(t, h))
        dx = h
        for j in range(self.n_enc, len(self.names)):
            dx = getattr(self, self.names[j])(t, dx)
            if j < len(self.names) - 1:
                dx = self.act(dx)
        return h, dx
