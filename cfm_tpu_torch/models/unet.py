"""Guided-diffusion UNet family in PyTorch, NHWC at its boundary.

Counterpart of ``cfm_tpu/models/unet.py`` (``UNetModel``,
``UNetModelWrapper``, ``SuperResModel``, ``EncoderUNetModel``,
``AttentionPool2d`` and their layers). Same function, same dtype policy:

- Activations are NHWC ``(N, H, W, C)`` like the JAX package. A convolution
  views its NHWC input as an NCHW tensor in ``torch.channels_last`` memory
  format (a free permute), which is the layout cuDNN is fastest in, and
  permutes its output back.
- ``dtype`` is the compute dtype, parameters stay float32 (flax's
  ``dtype``/``param_dtype``): convolutions and the ResBlock ``Dense`` cast
  their inputs and parameters to it; the time-embedding ``Dense`` pair runs
  in float32; GroupNorm computes in float32 and returns its input's dtype;
  the final GroupNorm runs on the input dtype and the final zero conv in
  float32.
- Convolutions pad like XLA's ``SAME``: symmetric at stride 1, but (0, 1) on
  each spatial axis for the stride-2 ``Downsample`` conv on even sizes.
- Submodules carry the flax scope names (``down1_attn0``, ``mid_res0``,
  ``Conv_0``, ``Dense_1``, ...), so ``models/convert.py`` maps a flax
  parameter tree onto ``state_dict`` keys mechanically.
- Attention blocks whose shape passes :func:`use_fused_block` go through
  :func:`~cfm_tpu_torch.ops.attn_block.fused_attention_block` (kernels #1
  and #2 on CUDA). The others project q, k and v themselves and call
  :func:`~cfm_tpu_torch.ops.attention.attention_t`, which takes kernels #3
  and #4 where its gate passes (the 16x16 blocks at ImageNet-64 widths), as
  in the JAX package. The 32x32 blocks at ImageNet-64 widths (S = 1024,
  over the gate's budget) take the plain composition in the JAX package and
  on the CPU, and #3 and #4 in their streaming form in bf16 on CUDA;
  ``mid_attn`` at 4x4 takes the plain composition everywhere.
- Every ``GroupNorm32`` goes through the fused GroupNorm(+SiLU) wrapper:
  46 calls per evaluation at the CIFAR-10 recipe, 27 at the MNIST preset,
  87 at ImageNet-64 widths in bf16 (the GroupNorms inside fused attention
  blocks are part of that kernel).
- ``train=True`` turns on ``FastDropout`` before each ResBlock's last conv,
  with its uint8 masks drawn from the ``generator`` the caller passes (a CPU
  generator on a CUDA model draws on the CPU and copies the masks over, which
  is how a test gives two devices the same masks). Gradients through the
  attention kernels take their backward kernels (#2, #4).
- ``use_checkpoint`` wraps each ResBlock and AttentionBlock of a
  :class:`UNetModel` in ``torch.utils.checkpoint.checkpoint`` (non-reentrant)
  when a gradient is wanted: the backward recomputes the block, relaunching
  its forward kernels (#1, #3, #8). ``checkpoint_policy`` None saves nothing;
  "dots" saves the outputs of convolutions and matmuls (``aten.convolution``,
  ``mm``, ``addmm``, ``bmm``, ``baddbmm``), as JAX's ``checkpoint_dots``
  saves ``conv_general_dilated`` and ``dot_general``; "dots_no_batch" saves
  only the matmuls without batch dimensions (``mm``, ``addmm``). A block's
  recompute draws its dropout masks again from the generator's state at the
  block's start and then puts the generator back, so the masks, the
  gradients and the generator's state after the step are an unwrapped
  step's. No module is wrapped: the parameter names do not change.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.ops.attention import attention_t
from cfm_tpu_torch.ops.attn_block import fused_attention_block, use_fused_block
from cfm_tpu_torch.ops.groupnorm import fused_group_norm_silu


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos half then sin half: (N,) -> (N, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def gn_groups(channels: int, num_groups: int = 32) -> int:
    """The largest group count <= ``num_groups`` that divides ``channels``."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA ``SAME`` padding of one axis: the odd cell goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, optionally followed by SiLU, through
    :func:`~cfm_tpu_torch.ops.groupnorm.fused_group_norm_silu` (kernels #8
    and #9 on CUDA, their plain versions on the CPU). The JAX ``GroupNorm32``
    computes the same function with its plain reference."""

    def __init__(self, channels: int, fuse_silu: bool = False):
        super().__init__()
        self.groups = gn_groups(channels)
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:  # (N, C) features: groups of channels, as flax's GroupNorm takes them
            return self(x[:, None, None, :])[:, 0, 0, :]
        return fused_group_norm_silu(x, self.weight, self.bias, self.groups, 1e-5, self.fuse_silu)


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``SAME`` padding on NHWC input; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False):
        super().__init__()
        self.stride, self.dtype, self.zero_init = stride, dtype, zero_init
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        xt = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        ph = _same_pads(xt.shape[2], k, self.stride)
        pw = _same_pads(xt.shape[3], k, self.stride)
        padding = (ph[0], pw[0])
        if ph[0] != ph[1] or pw[0] != pw[1]:
            xt = F.pad(xt, (pw[0], pw[1], ph[0], ph[1]))
            padding = (0, 0)
        y = F.conv2d(xt, self.weight.to(self.dtype), self.bias.to(self.dtype),
                     stride=self.stride, padding=padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense`` computing in ``dtype``; weight (out, in) as in torch."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, zero_init: bool = False):
        super().__init__()
        self.dtype, self.zero_init = dtype, zero_init
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour resize to exactly twice the size: a repeat."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, stride=2).permute(0, 2, 3, 1)


class Upsample(nn.Module):
    """2x nearest-neighbour upsample, then a 3x3 conv if ``use_conv``."""

    def __init__(self, use_conv: bool, channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        if use_conv:
            self.Conv_0 = Conv(channels, out_channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _upsample_nearest(x)
        return self.Conv_0(x) if hasattr(self, "Conv_0") else x


class Downsample(nn.Module):
    """Stride-2 3x3 conv if ``use_conv``, else 2x2 average pooling."""

    def __init__(self, use_conv: bool, channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        if use_conv:
            self.Conv_0 = Conv(channels, out_channels, 3, stride=2, dtype=dtype)
        elif out_channels != channels:
            raise ValueError("average-pool downsampling keeps the channel count")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(x) if hasattr(self, "Conv_0") else _avg_pool(x)


class FastDropout(nn.Module):
    """Dropout from 8-bit draws, with the JAX package's semantics: the keep
    probability is quantised to thr/256, thr = round((1 - rate) * 256)
    clamped to [1, 255]; an element is kept where its uint8 draw is < thr and
    scaled by 256/thr cast to x's dtype (so rounded in bf16). Rate 0 is the
    identity, rate >= 1 gives zeros."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    @staticmethod
    def threshold(rate: float) -> int:
        return min(255, max(1, int(round((1.0 - rate) * 256.0))))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("FastDropout in train mode needs a torch.Generator for its masks")
        thr = self.threshold(self.rate)
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, generator=generator,
                             device=generator.device).to(x.device)
        scale = float(torch.tensor(256.0 / thr, dtype=x.dtype))  # the constant in x's dtype
        return torch.where(bits < thr, x * scale, torch.zeros_like(x))


class ResBlock(nn.Module):
    """Residual block conditioned on the timestep embedding."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.dropout = FastDropout(dropout)
        self.GroupNorm32_0 = GroupNorm32(channels, fuse_silu=True)
        self.Conv_0 = Conv(channels, out_channels, 3, dtype=dtype)
        self.Dense_0 = Dense(emb_dim, (2 if use_scale_shift_norm else 1) * out_channels, dtype)
        self.GroupNorm32_1 = GroupNorm32(out_channels, fuse_silu=not use_scale_shift_norm)
        self.Conv_1 = Conv(out_channels, out_channels, 3, dtype=dtype, zero_init=True)
        if out_channels != channels:
            self.Conv_2 = Conv(channels, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.GroupNorm32_0(x)
        if self.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.down:
            h, x = _avg_pool(h), _avg_pool(x)
        h = self.Conv_0(h)
        emb_out = self.Dense_0(F.silu(emb))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = F.silu(self.GroupNorm32_1(h) * (1 + scale) + shift)
        else:
            h = self.GroupNorm32_1(h + emb_out)
        h = self.Conv_1(self.dropout(h, train, generator))
        skip = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return skip + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over the H*W tokens, with a residual.

    Parameters are stored flattened as the block kernel takes them:
    ``qkv_weight`` (C, 3*H*D) and ``qkv_bias`` (3*H*D,) with columns in
    [k][h][d] order, ``proj_weight`` (H*D, C) in [h][d] row order.
    """

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_head_channels == -1:
            heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"channels {channels} not divisible by "
                                 f"num_head_channels {num_head_channels}")
            heads = channels // num_head_channels
        self.heads, self.head_dim, self.dtype = heads, channels // heads, dtype
        hd = heads * self.head_dim
        self.GroupNorm32_0 = GroupNorm32(channels)
        self.qkv_weight = nn.Parameter(torch.zeros(channels, 3 * hd))
        self.qkv_bias = nn.Parameter(torch.zeros(3 * hd))
        self.proj_weight = nn.Parameter(torch.zeros(hd, channels))
        self.proj_bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, hh, ww, c = x.shape
        s, heads, d = hh * ww, self.heads, self.head_dim
        gn = self.GroupNorm32_0
        if use_fused_block(s, c, heads, x.dtype):
            y = fused_attention_block(
                x.reshape(n, s, c), gn.weight.reshape(1, c), gn.bias.reshape(1, c),
                self.qkv_weight, self.qkv_bias.reshape(1, -1),
                self.proj_weight, self.proj_bias.reshape(1, c), heads, gn.groups)
            return y.reshape(n, hh, ww, c)
        dt = self.dtype
        tokens = gn(x).reshape(n, s, c)
        qkv = tokens.to(dt) @ self.qkv_weight.to(dt) + self.qkv_bias.to(dt)
        qkv_t = qkv.reshape(n, s, 3, heads, d).permute(0, 2, 3, 1, 4)  # (N, 3, H, S, D)
        out_t = attention_t(qkv_t, 1.0 / math.sqrt(d))                   # (N, H, S, D)
        out = out_t.permute(0, 2, 1, 3).reshape(n, s, heads * d)
        out = out @ self.proj_weight.to(dt) + self.proj_bias.to(dt)
        return x + out.reshape(n, hh, ww, c)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers on every layer of ``module``, drawn from
    ``generator`` (a CPU generator): N(0, 1/fan_in) kernels, zero biases,
    zero-initialised output convs, heads and attention out-projections,
    N(0, 1) class embeddings, N(0, 1/C) positional embeddings."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            if m.zero_init:
                m.weight.zero_()
            else:
                normal_(m.weight, m.weight[0].numel() ** -0.5)
            m.bias.zero_()
        elif isinstance(m, GroupNorm32):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, AttentionBlock):
            normal_(m.qkv_weight, m.qkv_weight.shape[0] ** -0.5)
            for p in (m.qkv_bias, m.proj_weight, m.proj_bias):
                p.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0)
        elif isinstance(m, AttentionPool2d):
            normal_(m.positional_embedding, m.positional_embedding.shape[1] ** -0.5)


class AttentionPool2d(nn.Module):
    """Attention-weighted global pooling (the JAX ``AttentionPool2d``): the mean
    token prepended to the H*W tokens, a learned positional embedding of
    ``spatial_size + 1`` rows, one multi-head attention in the input's dtype
    with its own softmax (no kernel), and the mean token's output projection.
    x: (N, H, W, embed_dim) with H * W = ``spatial_size`` -> (N, output_dim)."""

    def __init__(self, spatial_size: int, embed_dim: int, num_heads: int = 1,
                 output_dim: Optional[int] = None, seed: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spatial_size + 1, embed_dim))
        self.Dense_0 = Dense(embed_dim, 3 * embed_dim)
        self.Dense_1 = Dense(embed_dim, output_dim or embed_dim)
        flax_init_(self, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        tokens = x.reshape(n, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding
        s, heads = tokens.shape[1], self.num_heads
        q, k, v = self.Dense_0(tokens).reshape(n, s, 3, heads, c // heads).unbind(2)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(c // heads)
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("nhqk,nkhd->nqhd", att, v).reshape(n, s, c)
        return self.Dense_1(out)[:, 0]


_aten = torch.ops.aten
# The ops whose outputs a checkpointed block keeps under each policy.
CHECKPOINT_POLICIES = {
    None: frozenset(),
    "dots": frozenset({_aten.convolution.default, _aten.mm.default, _aten.addmm.default,
                       _aten.bmm.default, _aten.baddbmm.default}),
    "dots_no_batch": frozenset({_aten.mm.default, _aten.addmm.default}),
}


class _GeneratorReplay:
    """The dropout generator across a checkpointed block: its state at the
    block's start is kept, set again for the recompute, and the state the
    recompute found is put back after it."""

    def __init__(self, generator: torch.Generator):
        self.generator, self.start = generator, None

    @contextlib.contextmanager
    def forward(self):
        self.start = self.generator.get_state()
        yield

    @contextlib.contextmanager
    def recompute(self):
        now = self.generator.get_state()
        self.generator.set_state(self.start)
        try:
            yield
        finally:
            self.generator.set_state(now)


@contextlib.contextmanager
def _entered(contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _checkpointed(block, h: torch.Tensor, policy: Optional[str],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(h)`` under non-reentrant activation checkpointing with
    ``policy``; ``generator``, where the block draws dropout masks from it,
    is replayed for the recompute."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)

    saved = CHECKPOINT_POLICIES[policy]

    def save(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn():
        fwd, rec = [], []
        if generator is not None:
            replay = _GeneratorReplay(generator)
            fwd.append(replay.forward())
            rec.append(replay.recompute())
        if saved:
            caching, cached = create_selective_checkpoint_contexts(save)
            fwd.append(caching)
            rec.append(cached)
        return _entered(fwd), _entered(rec)

    return checkpoint(block, h, use_reentrant=False, preserve_rng_state=False,
                      context_fn=context_fn)


class _Trunk(nn.Module):
    """What :class:`UNetModel` and :class:`EncoderUNetModel` share, under the
    flax scope names: the time embedding, the stem conv, the input blocks and
    the middle, and flax's initialisers."""

    def __init__(self, model_channels: int, dropout: float, num_head_channels: int,
                 use_scale_shift_norm: bool, dtype: torch.dtype, use_checkpoint: bool = False,
                 checkpoint_policy: Optional[str] = None):
        super().__init__()
        if checkpoint_policy not in CHECKPOINT_POLICIES:
            raise ValueError(f"Unknown checkpoint_policy {checkpoint_policy!r}; one of "
                             f"{list(CHECKPOINT_POLICIES)}")
        self.model_channels, self.dtype = model_channels, dtype
        self.use_checkpoint, self.checkpoint_policy = use_checkpoint, checkpoint_policy
        self.emb_dim = 4 * model_channels
        self._res_kw = dict(use_scale_shift_norm=use_scale_shift_norm, dtype=dtype, dropout=dropout)
        self._num_head_channels = num_head_channels
        self.Dense_0 = Dense(model_channels, self.emb_dim)
        self.Dense_1 = Dense(self.emb_dim, self.emb_dim)

    def _res(self, name: str, c_in: int, c_out: int, **kw) -> str:
        self.add_module(name, ResBlock(c_in, c_out, self.emb_dim, **self._res_kw, **kw))
        return name

    def _attn(self, name: str, c: int, heads: int) -> str:
        self.add_module(name, AttentionBlock(c, heads, self._num_head_channels, self.dtype))
        return name

    def _add_trunk(self, in_channels: int, channel_mult: Sequence[float], num_res_blocks: int,
                   attention_resolutions: Sequence[int], num_heads: int, conv_resample: bool,
                   resblock_updown: bool) -> Tuple[List[int], int]:
        """Adds the stem conv, the input blocks and the middle. Returns the
        channels of the stem's and of each input block's output, and the
        downsample factor reached."""
        ch = int(channel_mult[0] * self.model_channels)
        self.Conv_0 = Conv(in_channels, ch, 3, dtype=self.dtype)
        self._input_blocks: List[List[str]] = []
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                c_out = int(mult * self.model_channels)
                block = [self._res(f"down{level}_res{i}", ch, c_out)]
                ch = c_out
                if ds in attention_resolutions:
                    block.append(self._attn(f"down{level}_attn{i}", ch, num_heads))
                self._input_blocks.append(block)
                chans.append(ch)
            if level != len(channel_mult) - 1:
                if resblock_updown:
                    name = self._res(f"down{level}_downres", ch, ch, down=True)
                else:
                    name = f"down{level}_down"
                    self.add_module(name, Downsample(conv_resample, ch, ch, self.dtype))
                self._input_blocks.append([name])
                chans.append(ch)
                ds *= 2
        self._middle = [self._res("mid_res0", ch, ch), self._attn("mid_attn", ch, num_heads),
                        self._res("mid_res1", ch, ch)]
        return chans, ds

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def _embed(self, t, x: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        emb = timestep_embedding(t, self.model_channels)
        return self.Dense_1(F.silu(self.Dense_0(emb)))

    def _run(self, name: str, h: torch.Tensor, emb: torch.Tensor, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """One block of the trunk; a ResBlock or an AttentionBlock under
        activation checkpointing when ``use_checkpoint`` and a gradient is
        wanted."""
        m = getattr(self, name)
        if isinstance(m, ResBlock):
            def block(x):
                return m(x, emb, train, generator)
        elif isinstance(m, AttentionBlock):
            block = m
        else:
            return m(h)
        if not (self.use_checkpoint and torch.is_grad_enabled()):
            return block(h)
        draws = isinstance(m, ResBlock) and train and 0.0 < m.dropout.rate < 1.0
        return _checkpointed(block, h, self.checkpoint_policy, generator if draws else None)

    def _down_and_middle(self, x: torch.Tensor, emb: torch.Tensor, train: bool,
                         generator: Optional[torch.Generator]
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The middle's output, and the stem's and each input block's."""
        h = self.Conv_0(x.to(self.dtype))
        hs = [h]
        for block in self._input_blocks:
            for name in block:
                h = self._run(name, h, emb, train, generator)
            hs.append(h)
        for name in self._middle:
            h = self._run(name, h, emb, train, generator)
        return h, hs


class UNetModel(_Trunk):
    """The UNet with attention and timestep embedding, NHWC in and out.

    ``attention_resolutions`` holds downsample factors, as in the JAX
    package. ``seed`` makes the initial parameters (flax's initialisers:
    N(0, 1/fan_in) kernels, zero biases, zero-initialised output convs and
    attention out-projections). ``use_checkpoint`` and ``checkpoint_policy``
    are activation checkpointing (the module docstring); both are plain
    attributes, read at every call.
    """

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, channel_mult: Sequence[float] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_classes: Optional[int] = None,
                 use_checkpoint: bool = False, num_heads: int = 1, num_head_channels: int = -1,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False, dtype: torch.dtype = torch.float32,
                 checkpoint_policy: Optional[str] = None, seed: int = 0):
        super().__init__(model_channels, dropout, num_head_channels, use_scale_shift_norm, dtype,
                         use_checkpoint, checkpoint_policy)
        self.num_classes = num_classes
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        if num_classes is not None:
            self.Embed_0 = nn.Embedding(num_classes, self.emb_dim)
        # Each input block's output is pushed as a skip; each output block
        # first concatenates the last skip on the channel axis.
        skip_ch, ds = self._add_trunk(in_channels, channel_mult, num_res_blocks,
                                      attention_resolutions, num_heads, conv_resample,
                                      resblock_updown)
        ch = skip_ch[-1]
        self._output_blocks: List[List[str]] = []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                c_out = int(mult * model_channels)
                block = [self._res(f"up{level}_res{i}", ch + skip_ch.pop(), c_out)]
                ch = c_out
                if ds in attention_resolutions:
                    block.append(self._attn(f"up{level}_attn{i}", ch, heads_up))
                if level and i == num_res_blocks:
                    if resblock_updown:
                        block.append(self._res(f"up{level}_upres", ch, ch, up=True))
                    else:
                        name = f"up{level}_up"
                        self.add_module(name, Upsample(conv_resample, ch, ch, dtype))
                        block.append(name)
                    ds //= 2
                self._output_blocks.append(block)

        self.GroupNorm32_0 = GroupNorm32(ch, fuse_silu=True)
        self.Conv_1 = Conv(ch, out_channels, 3, dtype=torch.float32, zero_init=True)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def forward(self, t, x: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """t: scalar or (N,); x: (N, H, W, in_channels) -> (N, H, W, out_channels).

        ``train=True`` applies dropout, with masks drawn from ``generator``
        in the order the ResBlocks run.
        """
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("must specify y iff the model is class-conditional")
        emb = self._embed(t, x)
        if self.num_classes is not None:
            emb = emb + self.Embed_0(y)
        in_dtype = x.dtype
        h, hs = self._down_and_middle(x, emb, train, generator)
        for block in self._output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            for name in block:
                h = self._run(name, h, emb, train, generator)
        h = self.GroupNorm32_0(h.to(in_dtype))
        return self.Conv_1(h)


class SuperResModel(nn.Module):
    """A UNet conditioned on a low-resolution image (the JAX ``SuperResModel``):
    ``low_res`` (N, h, w, C') is resized bilinearly up to x's size and
    concatenated to x on the channel axis, so ``base`` takes x's channels plus
    C'. The resize keeps ``jax.image.resize``'s half-pixel centres with the
    edge weights renormalised, which is ``F.interpolate(..., align_corners=False,
    antialias=False)`` when it upsamples; a ``low_res`` larger than x (where
    JAX would antialias) is refused."""

    def __init__(self, base: UNetModel):
        super().__init__()
        self.base = base

    def forward(self, t, x: torch.Tensor, low_res: torch.Tensor, y: Optional[torch.Tensor] = None,
                *, train: bool = False, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        n, h, w, _ = x.shape
        if low_res.shape[1] > h or low_res.shape[2] > w:
            raise ValueError(f"low_res {tuple(low_res.shape)} is larger than x {tuple(x.shape)}")
        up = F.interpolate(low_res.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                           align_corners=False, antialias=False).permute(0, 2, 3, 1)
        return self.base(t, torch.cat([x, up], dim=-1), y, train=train, generator=generator)


_POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


class EncoderUNetModel(_Trunk):
    """The UNet's down path and middle with a pooled head (the JAX
    ``EncoderUNetModel``): (N, H, W, in_channels) -> (N, out_channels) float32.

    ``pool``:

    - "adaptive": GroupNorm + SiLU, the global mean, a zero-initialised
      linear head;
    - "attention": GroupNorm + SiLU, then :class:`AttentionPool2d` with
      C / ``num_head_channels`` heads; ``num_head_channels`` must be set, and
      ``image_size`` (divisible by the total downsampling) sizes the pool's
      positional embedding, which flax makes from the first input;
    - "spatial" / "spatial_v2": the spatial means of the stem's, every input
      block's and the middle's outputs, concatenated (their channel counts
      summed: the reference's ``_feature_size``), then ``Dense(2048)``, ReLU
      ("spatial") or GroupNorm + SiLU ("spatial_v2"), and the output
      ``Dense``; no GroupNorm on the trunk.
    """

    def __init__(self, in_channels: int, model_channels: int, out_channels: int,
                 num_res_blocks: int, attention_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, channel_mult: Sequence[float] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 pool: str = "adaptive", dtype: torch.dtype = torch.float32,
                 image_size: Optional[int] = None, seed: int = 0):
        if pool not in _POOLS:
            raise ValueError(f"Unknown pool: {pool}")
        super().__init__(model_channels, dropout, num_head_channels, use_scale_shift_norm, dtype)
        self.pool = pool
        chans, _ = self._add_trunk(in_channels, channel_mult, num_res_blocks,
                                   attention_resolutions, num_heads, conv_resample,
                                   resblock_updown)
        ch = chans[-1]
        if pool.startswith("spatial"):
            self.Dense_2 = Dense(sum(chans) + ch, 2048)
            if pool == "spatial_v2":
                self.GroupNorm32_0 = GroupNorm32(2048, fuse_silu=True)
            self.Dense_3 = Dense(2048, out_channels)
        else:
            self.GroupNorm32_0 = GroupNorm32(ch, fuse_silu=True)
            if pool == "adaptive":
                self.Dense_2 = Dense(ch, out_channels, zero_init=True)
            else:
                if num_head_channels == -1:
                    raise ValueError("pool='attention' requires num_head_channels")
                down = 2 ** (len(channel_mult) - 1)
                if image_size is None or image_size % down:
                    raise ValueError(f"pool='attention' needs an image_size divisible by {down}, "
                                     f"got {image_size}")
                side = image_size // down
                self.AttentionPool2d_0 = AttentionPool2d(side * side, ch, ch // num_head_channels,
                                                         out_channels)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def forward(self, t, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, hs = self._down_and_middle(x, self._embed(t, x), train, generator)
        if self.pool.startswith("spatial"):
            hdn = self.Dense_2(torch.cat([f.float().mean(dim=(1, 2)) for f in hs + [h]], dim=-1))
            hdn = self.GroupNorm32_0(hdn) if self.pool == "spatial_v2" else F.relu(hdn)
            return self.Dense_3(hdn)
        h = self.GroupNorm32_0(h).float()
        if self.pool == "adaptive":
            return self.Dense_2(h.mean(dim=(1, 2)))
        return self.AttentionPool2d_0(h)


_DEFAULT_CHANNEL_MULT = {
    512: (0.5, 1, 1, 2, 2, 4, 4),
    256: (1, 1, 2, 2, 4, 4),
    128: (1, 1, 2, 3, 4),
    64: (1, 2, 3, 4),
    32: (1, 2, 2, 2),
    28: (1, 2, 2),
}

NUM_CLASSES = 1000


def UNetModelWrapper(
    dim: Tuple[int, int, int],
    num_channels: int,
    num_res_blocks: int,
    channel_mult: Optional[Sequence[float]] = None,
    learn_sigma: bool = False,
    class_cond: bool = False,
    num_classes: int = NUM_CLASSES,
    use_checkpoint: bool = False,
    attention_resolutions: str = "16",
    num_heads: int = 1,
    num_head_channels: int = -1,
    num_heads_upsample: int = -1,
    use_scale_shift_norm: bool = False,
    dropout: float = 0.0,
    resblock_updown: bool = False,
    dtype: torch.dtype = torch.float32,
    checkpoint_policy: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> UNetModel:
    """Build a :class:`UNetModel` from image-level settings, on ``device``
    (``cuda`` unless ``device="cpu"`` is asked for).

    ``dim`` is ``(H, W, C)``; a ``(C, H, W)`` tuple with C in (1, 3) is
    recognised. ``attention_resolutions`` is a comma-separated string of
    feature-map sizes (``"16"`` on 32x32 images = downsample factor 2).
    """
    device = resolve_device(device)
    if len(dim) != 3:
        raise ValueError(f"dim must be (H, W, C), got {dim}")
    if dim[0] in (1, 3) and dim[-1] not in (1, 3):
        dim = (dim[1], dim[2], dim[0])
    image_size, in_channels = dim[0], dim[2]
    if channel_mult is None:
        try:
            channel_mult = _DEFAULT_CHANNEL_MULT[image_size]
        except KeyError:
            raise ValueError(f"unsupported image size: {image_size}") from None
    attention_ds = tuple(image_size // int(r) for r in str(attention_resolutions).split(","))
    model = UNetModel(
        in_channels=in_channels,
        model_channels=num_channels,
        out_channels=in_channels * (2 if learn_sigma else 1),
        num_res_blocks=num_res_blocks,
        attention_resolutions=attention_ds,
        dropout=dropout,
        channel_mult=tuple(channel_mult),
        num_classes=num_classes if class_cond else None,
        use_checkpoint=use_checkpoint,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        dtype=dtype,
        checkpoint_policy=checkpoint_policy,
        seed=seed,
    )
    return model.to(device).eval()
