"""The plain reference UNet: guided-diffusion's UNet in float32 PyTorch.

Written from guided-diffusion's description (openai/guided-diffusion,
``unet.py``) with the layout conventions the benchmark's configurations
state, and independent of the program under test: it imports nothing of it.
Activations are NHWC at the boundary (N, H, W, C) and NCHW inside the
convolutions. Parameters carry the flax scope names and shapes that the
harness's weight maker uses (``Conv_0.weight`` OIHW, ``Dense_0.weight``
(out, in), an attention block's ``qkv_weight`` (C, 3 H D) with its columns
in [q|k|v][head][dim] order and ``proj_weight`` (H D, C)), so one dict of
weights loads into both sides.

Conventions held here (each part of the configuration as it is run):

- convolutions pad like XLA's SAME: symmetric at stride 1, (0, 1) for a
  stride-2 3x3 convolution on an even size;
- GroupNorm over min(32, C) groups shrunk to a divisor of C, eps 1e-5;
- the timestep embedding is [cos | sin] of t * 10000^(-i / half);
- a ResBlock with scale-shift norm computes
  silu(GN(h) * (1 + scale) + shift), otherwise silu(GN(h + emb));
- up and down ResBlocks resize by nearest-neighbour repeat and 2x2 mean;
- dropout keeps an element where its uint8 draw is below
  thr = clamp(round((1 - rate) * 256), 1, 255) and scales it by 256 / thr;
  the draws are ``torch.randint(0, 256, shape, dtype=uint8)`` from the
  step's generator, one tensor per ResBlock in the order the blocks run,
  over the whole batch of the generator's rows (``Dropout.rows`` picks the
  rows a pass computes, so a batch can be computed in blocks).

``quant`` set to ``"fp8"`` turns the model into the benchmark's control:
every operand of a convolution, a linear layer and the two attention
products is rounded to float8 e4m3 with one scale per tensor (its largest
magnitude over 448), the nearest precision below the configurations'
bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


def quantize(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``x`` rounded to the control's precision and back to float32; the
    gradient passes the rounding unchanged (the products' backward then
    reads the rounded operands)."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quantisation {quant!r}")
    with torch.no_grad():
        scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
        rounded = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (rounded - x).detach()


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: the odd cell on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def groups_for(channels: int, most: int = 32) -> int:
    g = min(most, channels)
    while channels % g:
        g -= 1
    return g


class Dropout:
    """The masks of one forward pass: the generator seeded for this pass's
    rows, the rows of the whole batch that it draws for, and the slice of
    them that this pass computes."""

    def __init__(self, seed: int, device: torch.device, batch: int, rows: slice, rate: float):
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.batch, self.rows = batch, rows
        self.thr = min(255, max(1, int(round((1.0 - rate) * 256.0))))

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        bits = torch.randint(0, 256, (self.batch,) + tuple(h.shape[1:]), dtype=torch.uint8,
                             generator=self.generator, device=self.generator.device)
        keep = bits[self.rows].to(h.device) < self.thr
        return torch.where(keep, h * (256.0 / self.thr), torch.zeros_like(h))


class RefConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, zero: bool = False):
        super().__init__()
        self.stride, self.zero = stride, zero
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
        k = self.weight.shape[-1]
        xt = x.permute(0, 3, 1, 2)
        ph = same_pads(xt.shape[2], k, self.stride)
        pw = same_pads(xt.shape[3], k, self.stride)
        xt = F.pad(xt, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(quantize(xt, quant), quantize(self.weight, quant), self.bias,
                     stride=self.stride)
        return y.permute(0, 2, 3, 1)


class RefDense(nn.Module):
    def __init__(self, fin: int, fout: int, zero: bool = False):
        super().__init__()
        self.zero = zero
        self.weight = nn.Parameter(torch.zeros(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
        return F.linear(quantize(x, quant), quantize(self.weight, quant), self.bias)


class RefGroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.groups = groups_for(channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        g = x.reshape(n, -1, self.groups, c // self.groups)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = torch.square(g - mean).mean(dim=(1, 3), keepdim=True)
        y = ((g - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape) * self.weight + self.bias
        return F.silu(y) if silu else y


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _downsample(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class RefResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int, scale_shift: bool, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.scale_shift, self.up, self.down = scale_shift, up, down
        self.GroupNorm32_0 = RefGroupNorm(cin)
        self.Conv_0 = RefConv(cin, cout)
        self.Dense_0 = RefDense(emb_dim, (2 if scale_shift else 1) * cout)
        self.GroupNorm32_1 = RefGroupNorm(cout)
        self.Conv_1 = RefConv(cout, cout, zero=True)
        if cin != cout:
            self.Conv_2 = RefConv(cin, cout, k=1)

    def forward(self, x, emb, quant, dropout: Optional[Dropout]):
        h = self.GroupNorm32_0(x, silu=True)
        if self.up:
            h, x = _upsample(h), _upsample(x)
        elif self.down:
            h, x = _downsample(h), _downsample(x)
        h = self.Conv_0(h, quant)
        e = self.Dense_0(F.silu(emb), quant)[:, None, None, :]
        if self.scale_shift:
            scale, shift = e.chunk(2, dim=-1)
            h = F.silu(self.GroupNorm32_1(h) * (1 + scale) + shift)
        else:
            h = self.GroupNorm32_1(h + e, silu=True)
        if dropout is not None:
            h = dropout(h)
        h = self.Conv_1(h, quant)
        skip = self.Conv_2(x, quant) if hasattr(self, "Conv_2") else x
        return skip + h


class RefAttention(nn.Module):
    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, channels // heads
        self.GroupNorm32_0 = RefGroupNorm(channels)
        self.qkv_weight = nn.Parameter(torch.zeros(channels, 3 * channels))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * channels))
        self.proj_weight = nn.Parameter(torch.zeros(channels, channels))
        self.proj_bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, quant):
        n, hh, ww, c = x.shape
        s, heads, d = hh * ww, self.heads, self.head_dim
        tokens = self.GroupNorm32_0(x).reshape(n, s, c)
        qkv = quantize(tokens, quant) @ quantize(self.qkv_weight, quant) + self.qkv_bias
        q, k, v = qkv.reshape(n, s, 3, heads, d).permute(2, 0, 3, 1, 4)  # each (N, H, S, D)
        logits = quantize(q, quant) @ quantize(k, quant).transpose(-1, -2) / math.sqrt(d)
        att = torch.softmax(logits, dim=-1)
        out = (quantize(att, quant) @ quantize(v, quant)).permute(0, 2, 1, 3).reshape(n, s, c)
        out = quantize(out, quant) @ quantize(self.proj_weight, quant) + self.proj_bias
        return x + out.reshape(n, hh, ww, c)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class RefUNet(nn.Module):
    """guided-diffusion's UNet from the configuration's ``model`` entry:
    ``dim`` (H, W, C), ``num_channels``, ``num_res_blocks``, ``channel_mult``,
    ``attention_resolutions`` (feature-map sizes, comma separated),
    ``num_heads`` / ``num_head_channels``, ``use_scale_shift_norm``,
    ``resblock_updown``, ``class_cond`` / ``num_classes``, ``dropout``,
    ``learn_sigma``."""

    def __init__(self, arch: Dict, quant: Optional[str] = None):
        super().__init__()
        self.quant = quant
        size, cin = arch["dim"][0], arch["dim"][2]
        mc = arch["num_channels"]
        mult = list(arch["channel_mult"])
        nrb = arch["num_res_blocks"]
        attn_ds = {size // int(r) for r in str(arch["attention_resolutions"]).split(",")}
        head_ch = arch.get("num_head_channels", -1)
        num_heads = arch.get("num_heads", 1)
        scale_shift = arch.get("use_scale_shift_norm", False)
        updown = arch.get("resblock_updown", False)
        self.rate = float(arch.get("dropout", 0.0))
        self.model_channels, emb = mc, 4 * mc

        def heads(ch):
            return num_heads if head_ch == -1 else ch // head_ch

        def res(name, a, b, **kw):
            self.add_module(name, RefResBlock(a, b, emb, scale_shift, **kw))
            return name

        def attn(name, ch):
            self.add_module(name, RefAttention(ch, heads(ch)))
            return name

        self.Dense_0, self.Dense_1 = RefDense(mc, emb), RefDense(emb, emb)
        if arch.get("class_cond", False):
            self.Embed_0 = nn.Embedding(arch["num_classes"], emb)
        ch = mult[0] * mc
        self.Conv_0 = RefConv(cin, ch)
        self.inputs: List[List[str]] = []
        skips, ds = [ch], 1
        for level, m in enumerate(mult):
            for i in range(nrb):
                block = [res(f"down{level}_res{i}", ch, m * mc)]
                ch = m * mc
                if ds in attn_ds:
                    block.append(attn(f"down{level}_attn{i}", ch))
                self.inputs.append(block)
                skips.append(ch)
            if level != len(mult) - 1:
                if updown:
                    self.inputs.append([res(f"down{level}_downres", ch, ch, down=True)])
                else:
                    self.add_module(f"down{level}_down", _ConvDown(ch))
                    self.inputs.append([f"down{level}_down"])
                skips.append(ch)
                ds *= 2
        self.middle = [res("mid_res0", ch, ch), attn("mid_attn", ch), res("mid_res1", ch, ch)]
        self.outputs: List[List[str]] = []
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(nrb + 1):
                block = [res(f"up{level}_res{i}", ch + skips.pop(), m * mc)]
                ch = m * mc
                if ds in attn_ds:
                    block.append(attn(f"up{level}_attn{i}", ch))
                if level and i == nrb:
                    if updown:
                        block.append(res(f"up{level}_upres", ch, ch, up=True))
                    else:
                        self.add_module(f"up{level}_up", _ConvUp(ch))
                        block.append(f"up{level}_up")
                    ds //= 2
                self.outputs.append(block)
        self.GroupNorm32_0 = RefGroupNorm(ch)
        out_ch = cin * (2 if arch.get("learn_sigma", False) else 1)
        self.Conv_1 = RefConv(ch, out_ch, zero=True)

    def _layer(self, name, h, emb, dropout):
        m = getattr(self, name)
        if isinstance(m, RefResBlock):
            return m(h, emb, self.quant, dropout)
        return m(h, self.quant)

    def forward(self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                dropout: Optional[Dropout] = None) -> torch.Tensor:
        """t (N,), x (N, H, W, C), y (N,) class labels -> (N, H, W, C_out)."""
        q = self.quant
        emb = self.Dense_1(F.silu(self.Dense_0(timestep_embedding(t, self.model_channels), q)), q)
        if hasattr(self, "Embed_0"):
            emb = emb + self.Embed_0(y)
        h = self.Conv_0(x.float(), q)
        hs = [h]
        for block in self.inputs:
            for name in block:
                h = self._layer(name, h, emb, dropout)
            hs.append(h)
        for name in self.middle:
            h = self._layer(name, h, emb, dropout)
        for block in self.outputs:
            h = torch.cat([h, hs.pop()], dim=-1)
            for name in block:
                h = self._layer(name, h, emb, dropout)
        return self.Conv_1(self.GroupNorm32_0(h, silu=True), q)


class _ConvDown(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.Conv_0 = RefConv(ch, ch, stride=2)

    def forward(self, x, quant):
        return self.Conv_0(x, quant)


class _ConvUp(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.Conv_0 = RefConv(ch, ch)

    def forward(self, x, quant):
        return self.Conv_0(_upsample(x), quant)


def parameter_specs(arch: Dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every parameter, in the model's order,
    built on the meta device. Kinds: "kernel" (fan-in-scaled normal),
    "zero_kernel" (the layers guided-diffusion initialises to zero),
    "bias", "norm_scale", "embedding"."""
    with torch.device("meta"):
        model = RefUNet(arch)
    kinds = {}
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, RefConv):
            kinds[prefix + "weight"] = ("zero_kernel" if m.zero else "kernel",
                                        m.weight[0].numel())
            kinds[prefix + "bias"] = ("bias", 1)
        elif isinstance(m, RefDense):
            kinds[prefix + "weight"] = ("kernel", m.weight.shape[1])
            kinds[prefix + "bias"] = ("bias", 1)
        elif isinstance(m, RefGroupNorm):
            kinds[prefix + "weight"] = ("norm_scale", 1)
            kinds[prefix + "bias"] = ("bias", 1)
        elif isinstance(m, RefAttention):
            kinds[prefix + "qkv_weight"] = ("kernel", m.qkv_weight.shape[0])
            kinds[prefix + "qkv_bias"] = ("bias", 1)
            kinds[prefix + "proj_weight"] = ("zero_kernel", m.proj_weight.shape[0])
            kinds[prefix + "proj_bias"] = ("bias", 1)
        elif isinstance(m, nn.Embedding):
            kinds[prefix + "weight"] = ("embedding", 1)
    return [(n, tuple(p.shape), *kinds[n]) for n, p in model.named_parameters()]

