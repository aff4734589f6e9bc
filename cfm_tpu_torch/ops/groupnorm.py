"""GroupNorm with float32 statistics and an optional fused SiLU, forward and
backward (counterpart of ``cfm_tpu/ops/pallas_groupnorm.py``).

- :func:`gn_silu_reference` is the plain forward, ``_gn_silu_reference``'s
  arithmetic: two-pass recentred statistics in float32 (the mean of
  (x - mean)^2, never E[x^2] - E[x]^2), affine and SiLU in float32, one
  rounding to ``x.dtype``. :func:`gn_silu_fwd_reference` also returns the
  per-channel mean and inverse standard deviation, as the TPU kernel
  ``_gn_silu_fwd_kernel`` does. :func:`gn_silu_bwd_reference` is a batched
  transcription of ``_gn_silu_bwd_kernel`` (not autograd of the plain
  forward). They are the CPU path and the oracles the CUDA kernels are held
  against.
- :func:`fused_group_norm_silu` is the wrapper, named after the JAX function.
  A CPU tensor goes to the plain versions; a CUDA tensor launches the
  hand-written Hopper kernels (``csrc/groupnorm.cu``) or raises. It is a
  ``torch.autograd.Function`` that saves x and the statistics and whose
  backward is :func:`fused_group_norm_silu_bwd`; both compose with
  ``torch.func`` (vmap folds the mapped axis into N, one launch for the
  batch; jvp; a differentiable backward), so a per-sample trace of a drift
  with GroupNorms runs the kernels.
- :func:`strip_plan` plans the kernels' blocks (``csrc/gn_strip.cuh``,
  shared with the attention block's GroupNorm stages, and
  ``csrc/gn_strip_bwd.cuh`` with ``backward=True``): the strip width, the
  cluster that splits a strip's rows and the items a block takes. A shape
  no strip on chip can take (a strip too large for a cluster's shared
  memory, channels that are not whole 16-byte rows, groups wider than 256
  channels) gets :func:`split_plan`, the route of ``csrc/gn_split.cuh``:
  row chunks whose statistics are combined through device memory. Every
  float32 or bf16 (N, H, W, C) whose C divides by ``num_groups`` has a plan.

The JAX UNet calls the plain reference (on the TPU, XLA fuses the GroupNorm
chain into its neighbours); the port's ``GroupNorm32`` routes every call
here, since eager PyTorch fuses nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple, Union

import torch

from cfm_tpu_torch.ops import _build

_GRID_ITEMS = 65535  # the items of one launch under vmap's fold (a grid's rows)

# The kernels' plan (csrc/gn_strip.cuh, csrc/gn_strip_bwd.cuh). A strip is
# whole groups, a multiple of 16 bytes wide, rows of about STRIP_BYTES; a
# cluster of up to MAX_CLUSTER blocks splits a strip whose rows exceed
# SHARE_BYTES (the backward's rows hold x and g, twice the bytes, against
# SHARE_BYTES_BWD, and only where 8 blocks cannot hold a strip of the
# narrowest width does its cluster grow to MAX_CLUSTER_BWD); at small HW a
# block takes up to MAX_ITEMS items while the grid keeps MIN_BLOCKS blocks
# (two an SM of an H100's 132), and a backward block until the grid is at
# most MIN_BLOCKS, one wave.
STRIP_BYTES = 128
SHARE_BYTES, SHARE_BYTES_BWD = 64 * 1024, 96 * 1024
SMEM_BYTES = 227 * 1024  # a block's shared memory on the card
MAX_CLUSTER, MAX_CLUSTER_BWD, MAX_ITEMS, MAX_BOX_ROWS, MIN_BLOCKS = 8, 16, 8, 256, 264
_THREADS, _MAX_BOXES = 256, 32


class StripPlan(NamedTuple):
    width: int     # channels of a strip
    cluster: int   # blocks of a cluster, splitting one strip's rows
    items: int     # items of a block (1 where cluster > 1)
    rows: int      # rows of a block's share
    box_rows: int  # rows of one TMA box
    boxes: int     # boxes of a share


class SplitPlan(NamedTuple):
    tile: int      # channels of a block: C, or 256 of a wider C
    lanes: int     # row lanes of a block, 256 // tile
    chunks: int    # row chunks of an item, each one block's sums in device memory
    rows: int      # rows of a chunk


# The split route's statistics pass takes about SPLIT_BLOCKS blocks (eight an
# SM of an H100's 132) where the rows allow, each lane at least
# SPLIT_MIN_ROWS rows of its chunk.
SPLIT_BLOCKS, SPLIT_MIN_ROWS = 1056, 8


def split_plan(n: int, hw: int, c: int) -> SplitPlan:
    """The split route's blocks for x of (n, hw, c): a tile of channels and
    its row lanes, and the row chunks of an item (``csrc/gn_split.cuh``)."""
    tile = min(c, _THREADS)
    lanes = _THREADS // tile
    tiles = -(-c // tile)
    chunks = max(1, min(-(-SPLIT_BLOCKS // (tiles * min(n, _GRID_ITEMS))),
                        -(-hw // (lanes * SPLIT_MIN_ROWS))))
    rows = -(-hw // chunks)
    return SplitPlan(tile, lanes, -(-hw // rows), rows)


def strip_smem_bytes(plan: StripPlan, itemsize: int, backward: bool = False) -> int:
    """A block's dynamic shared memory under ``plan``, as ``gnstrip::smem_bytes``
    (or, for the backward, ``gnstrip::smem_bytes_bwd``) computes it."""
    tiles, vecs, align = (2, 4, 128) if backward else (1, 5, 16)
    tile = -(-plan.items * plan.boxes * plan.box_rows * plan.width * itemsize // align) * align
    return (128 + tiles * tile + _THREADS * (16 // itemsize) * 4
            + vecs * plan.items * plan.width * 4 + _MAX_BOXES * 8)


def strip_plan(n: int, hw: int, c: int, num_groups: int, itemsize: int,
               backward: bool = False) -> Union[StripPlan, SplitPlan]:
    """The kernel's blocks for x of (n, hw, c) in a dtype of ``itemsize``
    bytes: the forward's, or with ``backward`` the backward's, whose share
    holds x and g. Where no strip fits (a strip of the narrowest width over
    more rows than eight blocks' shared memory, sixteen for the backward),
    where the channels are not a multiple of 16 bytes, or where a strip of
    whole groups would be wider than 256 channels, the split route's
    :func:`split_plan`."""
    vec = 16 // itemsize
    cg = c // num_groups
    unit = cg * vec // math.gcd(cg, vec)  # whole groups, whole 16-byte vectors
    if c % vec or unit > 256:
        return split_plan(n, hw, c)
    tensors, share = (2, SHARE_BYTES_BWD) if backward else (1, SHARE_BYTES)

    def fit(width, max_cluster):
        row = width * itemsize * tensors
        cluster = 1
        while cluster < max_cluster and -(-hw // cluster) * row > share:
            cluster *= 2
        rows = -(-hw // cluster)
        boxes = -(-rows // MAX_BOX_ROWS)
        # several boxes start on 128-byte boundaries: rows a multiple of 8
        box_rows = rows if boxes == 1 else -(-rows // (8 * boxes)) * 8
        plan = StripPlan(width, cluster, 1, rows, box_rows, boxes)
        fits = strip_smem_bytes(plan, itemsize, backward) <= SMEM_BYTES and boxes <= _MAX_BOXES
        return plan if fits else None

    width = min(c, unit * max(1, STRIP_BYTES // itemsize // unit))
    tries = [(width, MAX_CLUSTER), (unit, MAX_CLUSTER)]
    if backward:
        tries.append((unit, MAX_CLUSTER_BWD))
    for width, max_cluster in dict.fromkeys(tries):
        plan = fit(width, max_cluster)
        if plan:
            break
    else:
        return split_plan(n, hw, c)
    if plan.cluster == 1 and hw <= MAX_BOX_ROWS:
        strips, items, row = -(-c // plan.width), 1, plan.width * itemsize * tensors
        if backward:  # latency-bound small maps: fewer, fuller blocks, one wave of them
            while (items < MAX_ITEMS and 2 * items * plan.width <= _THREADS
                   and strips * -(-n // items) > MIN_BLOCKS
                   and strip_smem_bytes(plan._replace(items=2 * items), itemsize, True)
                   <= SMEM_BYTES):
                items *= 2
        else:
            while (items < MAX_ITEMS and 2 * items * hw * row <= share
                   and 2 * items * plan.width <= _THREADS
                   and strips * -(-n // (2 * items)) >= MIN_BLOCKS):
                items *= 2
        plan = plan._replace(items=items)
    return plan


def gn_silu_fwd_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int, eps: float = 1e-5, apply_silu: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, mean, inv): the plain forward and its per-channel statistics.

    x: (N, H, W, C) any float dtype; scale/bias: (C,). ``mean`` and ``inv``
    are (N, C) float32, each channel holding its group's mean and
    1 / sqrt(var + eps)."""
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(n, h * w, c)
    s1 = xf.mean(dim=1)                                          # (n, c)
    mean_c = s1.reshape(n, num_groups, cg).mean(dim=-1).repeat_interleave(cg, dim=-1)
    centered = xf - mean_c[:, None, :]
    s2 = centered.square().mean(dim=1)
    var = s2.reshape(n, num_groups, cg).mean(dim=-1)
    inv_c = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1)
    out = (centered * inv_c[:, None, :]).reshape(n, h, w, c)
    out = out * scale.float() + bias.float()
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype), mean_c, inv_c


def gn_silu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, eps: float = 1e-5,
                      apply_silu: bool = False) -> torch.Tensor:
    """x: (N, H, W, C) any float dtype; scale/bias: (C,). Two-pass statistics,
    affine and SiLU in float32, then cast back to ``x.dtype``."""
    return gn_silu_fwd_reference(x, scale, bias, num_groups, eps, apply_silu)[0]


def gn_silu_bwd_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          mean: torch.Tensor, inv: torch.Tensor, g: torch.Tensor,
                          num_groups: int, apply_silu: bool = False, per_item: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) for the output gradient ``g``, a batched
    transcription of ``_gn_silu_bwd_kernel``: norm recomputed from x and the
    saved (N, C) statistics, dy through the SiLU, dnorm = dy * scale,
    dx = inv * (dnorm - mean_g(dnorm) - norm * mean_g(dnorm * norm)) rounded
    to x's dtype, and the float32 sums dscale = sum(dy * norm), dbias =
    sum(dy) over items and pixels (with ``per_item``, each item's own (N, C)
    sums, which the kernel keeps in its workspace)."""
    n, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(n, h * w, c)
    gf = g.float().reshape(n, h * w, c)
    norm = (xf - mean[:, None, :]) * inv[:, None, :]
    scale, bias = scale.float(), bias.float()
    if apply_silu:
        y = norm * scale + bias
        sig = torch.sigmoid(y)
        dy = gf * sig * (1.0 + y * (1.0 - sig))
    else:
        dy = gf
    dnorm = dy * scale
    cnt = float(h * w * cg)

    def group_mean(t):  # (n, hw, c) -> its group means broadcast back to (n, 1, c)
        cols = t.sum(dim=1).reshape(n, num_groups, cg).sum(dim=-1) / cnt
        return cols.repeat_interleave(cg, dim=-1)[:, None, :]

    dx = inv[:, None, :] * (dnorm - group_mean(dnorm) - norm * group_mean(dnorm * norm))
    dims = 1 if per_item else (0, 1)
    dscale = (dy * norm).sum(dim=dims)
    dbias = dy.sum(dim=dims)
    return dx.reshape(x.shape).to(x.dtype), dscale, dbias


def _check(x, scale, bias, num_groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"C={c} must divide by num_groups={num_groups}")
    if n * h * w == 0:
        raise ValueError(f"x is empty: shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (N, H, W, C)")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape ({c},), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


def _device_checks(x):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernels move 16-byte vectors)")


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int = 32, eps: float = 1e-5,
                          apply_silu: bool = True) -> torch.Tensor:
    """silu(GroupNorm(x) * scale + bias), or without the SiLU.

    x: (N, H, W, C) float32 or bfloat16, contiguous; scale/bias: (C,)
    float32. On a CUDA tensor this launches the forward kernel (and adds one
    to ``fused_group_norm_silu.launches``); on a CPU tensor it runs the plain
    forward. When a gradient is wanted, or under a ``torch.func`` transform,
    it goes through :class:`_FusedGroupNormSiLU`, whose backward is
    :func:`fused_group_norm_silu_bwd` and which composes with ``torch.func``.
    """
    _check(x, scale, bias, num_groups)
    if ((torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)))
            or torch._C._are_functorch_transforms_active()):
        return _FusedGroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)[0]
    return _forward(x, scale, bias, num_groups, eps, apply_silu)[0]


fused_group_norm_silu.launches = 0


def _batch_first(t, dim, b):
    """A mapped tensor with its mapped axis first, or an unmapped one expanded to ``b``."""
    return t.movedim(dim, 0) if dim is not None else t.expand((b,) + tuple(t.shape))


def _folded(fn, n, *mapped):
    """``fn`` on the (B, N, ...) tensors ``mapped`` folded to (B * N, ...), in
    calls of at most _GRID_ITEMS items; its outputs concatenated."""
    step = max(1, _GRID_ITEMS // n)
    parts = [fn(*(t[i:i + step].reshape((-1,) + tuple(t.shape[2:])).contiguous()
                  for t in mapped)) for i in range(0, mapped[0].shape[0], step)]
    return [p[0] if len(p) == 1 else torch.cat(p) for p in zip(*parts)]


def _unmapped_affine(in_dims):
    if in_dims[1] is not None or in_dims[2] is not None:
        raise NotImplementedError("GroupNorm under vmap with a mapped scale or bias")


class _FusedGroupNormSiLU(torch.autograd.Function):
    """GroupNorm(+SiLU) as an autograd node that returns the (N, C)
    statistics beside its output and saves them, as the JAX ``custom_vjp``'s
    TPU path does. It composes with ``torch.func``: the vmap rule folds the
    mapped axis into N (one launch for the whole batch, or one for each
    _GRID_ITEMS items of it), the backward is
    :class:`_GroupNormSiLUBwd` (itself mappable and differentiable, so a
    loss can differentiate through a per-sample trace), and the jvp uses
    that backward's dx, which is the same linear map of the tangent."""

    @staticmethod
    def forward(x, scale, bias, num_groups, eps, apply_silu):
        return _forward(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, num_groups, eps, apply_silu = inputs
        _, mean, inv = output
        ctx.mark_non_differentiable(mean, inv)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.save_for_forward(x, scale, bias, mean, inv)
        ctx.args = (num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g, _mean, _inv):
        x, scale, bias, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = _GroupNormSiLUBwd.apply(x, scale, bias, mean, inv, g.contiguous(),
                                                    *ctx.args, False)
        return dx, dscale, dbias, None, None, None

    @staticmethod
    def jvp(ctx, tx, tscale, tbias, *_):
        # d norm = inv * (tx - mean_g(tx) - norm * mean_g(norm * tx)): the
        # backward's dx at unit scale without the SiLU, with g = tx. norm is
        # the block at unit scale, so that it stays differentiable in x.
        x, scale, bias, mean, inv = ctx.saved_tensors
        num_groups, eps, apply_silu = ctx.args
        one, zero = torch.ones_like(scale), torch.zeros_like(bias)
        norm = _FusedGroupNormSiLU.apply(x, one, zero, num_groups, eps, False)[0].float()
        ty = torch.zeros_like(norm)
        if tx is not None:
            dnorm = _GroupNormSiLUBwd.apply(x, one, zero, mean, inv, tx.contiguous(), num_groups,
                                            eps, False, False)[0]
            ty = ty + dnorm.float() * scale
        if tscale is not None:
            ty = ty + norm * tscale
        if tbias is not None:
            ty = ty + tbias
        if apply_silu:
            y = norm * scale + bias
            sig = torch.sigmoid(y)
            ty = ty * sig * (1.0 + y * (1.0 - sig))
        return ty.to(x.dtype), None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, num_groups, eps, apply_silu):
        _unmapped_affine(in_dims)
        xb = x.movedim(in_dims[0], 0)
        b, n = xb.shape[:2]
        out, mean, inv = _folded(lambda xf: _FusedGroupNormSiLU.apply(
            xf, scale, bias, num_groups, eps, apply_silu), n, xb)
        return (out.reshape(xb.shape), mean.reshape(b, n, -1), inv.reshape(b, n, -1)), (0, 0, 0)


class _GroupNormSiLUBwd(torch.autograd.Function):
    """(dx, dscale, dbias) of the block (:func:`fused_group_norm_silu_bwd`,
    kernel #9 on a CUDA tensor) as a node of its own. Its vmap rule folds the
    mapped axis into N and sums each mapped element's dscale and dbias from
    the items' own sums; its backward, the second derivative of the block,
    differentiates the plain backward with the statistics recomputed from
    x (no kernel of the TPU package computes it)."""

    @staticmethod
    def forward(x, scale, bias, mean, inv, g, num_groups, eps, apply_silu, per_item):
        return fused_group_norm_silu_bwd(x, scale, bias, mean, inv, g, num_groups, apply_silu,
                                         per_item=per_item)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, _, _, g = inputs[:6]
        ctx.save_for_backward(x, scale, bias, g)
        ctx.args = inputs[6:]

    @staticmethod
    def backward(ctx, ddx, ddscale, ddbias):
        from torch.func import vjp

        num_groups, eps, apply_silu, per_item = ctx.args

        def plain(x, scale, bias, g):
            _, mean, inv = gn_silu_fwd_reference(x, scale, bias, num_groups, eps)
            return gn_silu_bwd_reference(x, scale, bias, mean, inv, g, num_groups, apply_silu,
                                         per_item)

        _, pullback = vjp(plain, *ctx.saved_tensors)
        dx, dscale, dbias, dg = pullback((ddx, ddscale, ddbias))
        return dx, dscale, dbias, None, None, dg, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, mean, inv, g, num_groups, eps, apply_silu,
             per_item):
        _unmapped_affine(in_dims)
        b = info.batch_size
        xb, mb, ib, gb = (_batch_first(t, d, b) for t, d in zip((x, mean, inv, g),
                                                                (in_dims[0],) + in_dims[3:6]))
        n = xb.shape[1]
        dx, dscale, dbias = _folded(lambda xf, mf, if_, gf: _GroupNormSiLUBwd.apply(
            xf, scale, bias, mf, if_, gf, num_groups, eps, apply_silu, True), n, xb, mb, ib, gb)
        dscale, dbias = dscale.reshape(b, n, -1), dbias.reshape(b, n, -1)
        if not per_item:
            dscale, dbias = dscale.sum(dim=1), dbias.sum(dim=1)
        return (dx.reshape(xb.shape), dscale, dbias), (0, 0, 0)


def fused_group_norm_silu_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              num_groups: int, eps: float = 1e-5, apply_silu: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, mean, inv) as :func:`gn_silu_fwd_reference` gives them: the
    forward kernel on a CUDA tensor (counted in
    ``fused_group_norm_silu.launches``), the plain forward on a CPU tensor."""
    _check(x, scale, bias, num_groups)
    return _forward(x, scale, bias, num_groups, eps, apply_silu)


def _forward(x, scale, bias, num_groups, eps, apply_silu):
    if x.device.type == "cpu":
        return gn_silu_fwd_reference(x, scale, bias, num_groups, eps, apply_silu)
    _device_checks(x)
    n, h, w, c = x.shape
    plan = strip_plan(n, h * w, c, num_groups, x.element_size())
    out = torch.empty_like(x)
    mean = torch.empty((n, c), device=x.device, dtype=torch.float32)
    inv = torch.empty_like(mean)
    args = (n, h * w, c, num_groups, eps, int(apply_silu), 0 if x.dtype == torch.float32 else 1,
            *plan, torch.cuda.current_stream(x.device).cuda_stream)
    ptrs = [t.data_ptr() for t in (x, scale, bias, out, mean, inv)]
    with torch.cuda.device(x.device):
        if isinstance(plan, SplitPlan):
            ws = torch.empty(n * plan.chunks * c, device=x.device, dtype=torch.float32)
            err = _lib().gn_silu_fwd_split(*ptrs, ws.data_ptr(), *args)
        else:
            err = _lib().gn_silu_fwd(*ptrs, *args)
    if err:
        raise RuntimeError(f"gn_silu_fwd launch failed: CUDA error {err}")
    fused_group_norm_silu.launches += 1
    return out, mean, inv


def fused_group_norm_silu_bwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              mean: torch.Tensor, inv: torch.Tensor, g: torch.Tensor,
                              num_groups: int, apply_silu: bool = True, per_item: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of the block at x for the output gradient g
    (with ``per_item``, dscale and dbias are each item's (N, C) sums).

    On a CUDA tensor this launches the backward kernel under
    ``strip_plan(..., backward=True)`` (and adds one to
    ``fused_group_norm_silu_bwd.launches``); on a CPU tensor it runs
    :func:`gn_silu_bwd_reference`."""
    _check(x, scale, bias, num_groups)
    n, h, w, c = x.shape
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be contiguous and match x ({tuple(x.shape)}, {x.dtype}, "
                         f"{x.device}), got ({tuple(g.shape)}, {g.dtype}, {g.device})")
    for name, t in (("mean", mean), ("inv", inv)):
        if tuple(t.shape) != (n, c) or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 of shape ({n}, {c}) on "
                             f"{x.device}")
    if x.device.type == "cpu":
        return gn_silu_bwd_reference(x, scale, bias, mean, inv, g, num_groups, apply_silu,
                                     per_item)
    _device_checks(x)
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned (the kernel loads it by TMA)")
    plan = strip_plan(n, h * w, c, num_groups, x.element_size(), backward=True)
    dx = torch.empty_like(x)
    dscale = torch.empty(c, device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    ws = torch.empty((2, n, c), device=x.device, dtype=torch.float32)  # per-item column sums
    ptrs = [t.data_ptr() for t in (x, g, scale, bias, mean, inv, dx, dscale, dbias, ws)]
    args = (n, h * w, c, num_groups, int(apply_silu), 0 if x.dtype == torch.float32 else 1,
            *plan, torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        if isinstance(plan, SplitPlan):  # the chunks' two sums, then m1 and m2 a channel
            split_ws = torch.empty(2 * n * (plan.chunks + 1) * c, device=x.device,
                                   dtype=torch.float32)
            err = _lib().gn_silu_bwd_split(*ptrs, split_ws.data_ptr(), *args)
        else:
            err = _lib().gn_silu_bwd(*ptrs, *args)
    if err:
        raise RuntimeError(f"gn_silu_bwd launch failed: CUDA error {err}")
    fused_group_norm_silu_bwd.launches += 1
    if per_item:  # the kernel leaves each item's sums in ws: of dy * norm, then of dy
        return dx, ws[0], ws[1]
    return dx, dscale, dbias


fused_group_norm_silu_bwd.launches = 0

def _lib() -> ctypes.CDLL:
    lib = _build.load("groupnorm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_silu_fwd.argtypes = [p] * 6 + [i] * 4 + [ctypes.c_float] + [i] * 8 + [p]
        lib.gn_silu_fwd.restype = i
        lib.gn_silu_bwd.argtypes = [p] * 10 + [i] * 12 + [p]
        lib.gn_silu_bwd.restype = i
        lib.gn_silu_fwd_split.argtypes = [p] * 7 + [i] * 4 + [ctypes.c_float] + [i] * 6 + [p]
        lib.gn_silu_fwd_split.restype = i
        lib.gn_silu_bwd_split.argtypes = [p] * 11 + [i] * 10 + [p]
        lib.gn_silu_bwd_split.restype = i
        lib._typed = True
    return lib
