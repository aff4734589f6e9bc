"""The UNet AttentionBlock in one call: GN + qkv proj + MHA + out proj + residual.

Counterpart of ``cfm_tpu/ops/pallas_attn_block.py``: the forward kernel and
its recomputing backward.

- :func:`attention_block_reference` is the plain PyTorch forward: a batched
  transcription of the TPU kernel's ``_fwd_kernel`` with its rounding points.
  :func:`attention_block_backward_reference` is the plain backward, a batched
  transcription of ``_bwd_kernel`` (not autograd of the plain forward: it
  keeps dy, dattn, dp and ds in f32 and rounds where that kernel rounds).
  They are the CPU path and the oracles the CUDA kernels are held against.
- :func:`fused_attention_block` is the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/attn_block_fwd.cu``: in bf16 its GroupNorm stage is the strip
  kernel of ``fused_group_norm_silu``, planned by ``strip_plan``, its
  products TMA + wgmma GEMMs, its attention kernel #3's) or raises. Under
  autograd it is a ``torch.autograd.Function`` that saves only the primal
  inputs and whose backward is :func:`fused_attention_block_bwd`
  (``csrc/attn_block_bwd.cu`` on CUDA: in bf16 at head dims 64 and 128 a
  chain of ten launches reusing #1's GroupNorm strip and GEMM and #4's
  attention kernels, with do split exactly into three bf16 parts). It never
  falls back.
- :func:`use_fused_block` is the JAX gate's shape and budget test, so both
  packages route the same blocks here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cfm_tpu_torch.ops import _build
from cfm_tpu_torch.ops.groupnorm import StripPlan, strip_plan

_EPS = 1e-5

# Same budget and footprint formula as the JAX gate, so the two packages
# agree on which blocks take the fused path.
_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def _vmem_bytes(S: int, C: int, H: int, D: int, itemsize: int) -> int:
    return (3 * itemsize * S * C
            + 4 * (2 * S * 3 * H * D)
            + 4 * 3 * S * S
            + 4 * 4 * S * C
            + 2 * itemsize * (C * 3 * H * D + H * D * C))


def _strip(N, S, C, groups, itemsize) -> StripPlan:
    """The GroupNorm stage's strip plan; the block's kernels have no split route."""
    plan = strip_plan(N, S, C, groups, itemsize)
    if not isinstance(plan, StripPlan):
        raise ValueError(f"the block's GroupNorm stage needs a strip on chip: N={N}, S={S}, C={C}")
    return plan


def use_fused_block(S: int, C: int, n_heads: int, dtype: torch.dtype) -> bool:
    """Whether an AttentionBlock of S tokens and C channels takes this kernel:
    S a multiple of 8 and at least 64, D = C / n_heads a multiple of 64, C a
    multiple of 128, and the footprint within the JAX gate's budget."""
    if C % n_heads:
        return False
    D = C // n_heads
    itemsize = torch.empty((), dtype=dtype).element_size()
    aligned = S % 8 == 0 and S >= 64 and D % 64 == 0 and C % 128 == 0
    return aligned and _vmem_bytes(S, C, n_heads, D, itemsize) <= _VMEM_BUDGET_BYTES


def attention_block_reference(x, gscale, gbias, wq, bq, wo, bo,
                              n_heads: int, groups: int) -> torch.Tensor:
    """Plain PyTorch forward with the TPU kernel's rounding points.

    x: (N, S, C) in the model dtype; gscale/gbias/bo: (1, C) f32; wq: (C, 3HD)
    and bq: (1, 3HD) with columns in [k][h][d] order; wo: (HD, C).
    """
    N, S, C = x.shape
    lp = x.dtype
    H, D = n_heads, C // n_heads
    xs = x.float()
    xg = xs.reshape(N, S, groups, C // groups)
    centered = xg - xg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(centered.square().mean(dim=(1, 3), keepdim=True) + _EPS)
    tokens = (centered * rstd).reshape(N, S, C) * gscale.float() + gbias.float()
    tokens_lp = tokens.to(lp)
    # f32 products of model-dtype operands, then rounded, then the bias added
    # in the model dtype (pallas_attn_block.py:104-105).
    qkv = (tokens_lp.float() @ wq.to(lp).float()).to(lp) + bq.to(lp)
    qkv = qkv.reshape(N, S, 3, H, D).permute(2, 0, 3, 1, 4)            # (3, N, H, S, D)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2]
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(D))          # f32
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    ctx = w.to(lp).float() @ v.float()                                 # (N, H, S, D) f32
    ctx = ctx.permute(0, 2, 1, 3).reshape(N, S, H * D).to(lp)
    res = ctx.float() @ wo.to(lp).float() + bo.float()
    return (xs + res).to(x.dtype)


def attention_block_backward_reference(x, gscale, gbias, wq, bq, wo, bo, dy,
                                       n_heads: int, groups: int, round_do_ds: bool = False):
    """Plain PyTorch backward with the TPU kernel's rounding points.

    A batched transcription of ``_bwd_kernel``: recompute the forward, then
    dx (model dtype) and the f32 gradients dgscale, dgbias (1, C), dwq
    (C, 3HD), dbq (1, 3HD), dwo (HD, C), dbo (1, C) summed over the batch.

    ``round_do_ds=True`` is not that function: it rounds the f32 operands do
    and ds to the model dtype, as a kernel that fed them to bf16 tensor cores
    would. ``chip_smoke.py`` reads its distance from the true backward to
    show that its limits would catch that error.
    """
    N, S, C = x.shape
    lp = x.dtype
    H, D, G = n_heads, C // n_heads, groups
    scale = 1.0 / math.sqrt(D)
    rows = lambda t: t.reshape(N * S, -1)
    xs, dyf = x.float(), dy.float()
    xg = xs.reshape(N, S, G, C // G)
    centered = xg - xg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(centered.square().mean(dim=(1, 3), keepdim=True) + _EPS)
    rstd_c = rstd.expand_as(centered).reshape(N, S, C)
    centered = centered.reshape(N, S, C)
    tokens_lp = (centered * rstd_c * gscale.float() + gbias.float()).to(lp)
    wq_lp, wo_lp = wq.to(lp).float(), wo.to(lp).float()
    qkv = (tokens_lp.float() @ wq_lp).to(lp) + bq.to(lp)
    q, k, v = qkv.float().reshape(N, S, 3, H, D).permute(2, 0, 3, 1, 4)   # (N, H, S, D)
    logits = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    wf = e / e.sum(dim=-1, keepdim=True)
    w = wf.to(lp).float()
    attn_lp = (w @ v).permute(0, 2, 1, 3).reshape(N, S, H * D).to(lp)
    # out projection + residual
    dres_lp = dyf.to(lp).float()
    dbo = dyf.sum(dim=(0, 1))
    dwo = rows(attn_lp.float()).T @ rows(dres_lp)
    dattn = dres_lp @ wo_lp.T                                            # (N, S, HD) f32
    # per-head attention backward, f32 products of f32 do and ds
    do = dattn.reshape(N, S, H, D).permute(0, 2, 1, 3)
    if round_do_ds:
        do = do.to(lp).float()
    dv = w.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    dw = dp - (dp * w).sum(dim=-1, keepdim=True)
    ds = wf * dw * scale
    if round_do_ds:
        ds = ds.to(lp).float()
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv], dim=2).permute(0, 3, 2, 1, 4).reshape(N, S, 3 * H * D)
    # qkv projection
    dbq = dqkv.sum(dim=(0, 1))
    dqkv_lp = dqkv.to(lp).float()
    dwq = rows(tokens_lp.float()).T @ rows(dqkv_lp)
    dtokens = dqkv_lp @ wq_lp.T                                          # (N, S, C) f32
    # GroupNorm backward
    x_hat = centered * rstd_c
    dgscale = (dtokens * x_hat).sum(dim=(0, 1))
    dgbias = dtokens.sum(dim=(0, 1))
    dxhat = dtokens * gscale.float()
    group_mean = lambda t: t.reshape(N, S, G, C // G).mean(dim=(1, 3), keepdim=True).expand(
        N, S, G, C // G).reshape(N, S, C)
    dx_gn = rstd_c * (dxhat - group_mean(dxhat) - x_hat * group_mean(dxhat * x_hat))
    dx = (dyf + dx_gn).to(lp)
    return (dx, dgscale[None], dgbias[None], dwq, dbq[None], dwo, dbo[None])


def _check(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups):
    if x.dim() != 3:
        raise ValueError(f"x must be (N, S, C), got shape {tuple(x.shape)}")
    N, S, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if C % n_heads or C % groups:
        raise ValueError(f"C={C} must divide by n_heads={n_heads} and groups={groups}")
    HD3 = 3 * C
    shapes = {"gscale": (gscale, (1, C)), "gbias": (gbias, (1, C)),
              "wq": (wq, (C, HD3)), "bq": (bq, (1, HD3)),
              "wo": (wo, (C, C)), "bo": (bo, (1, C))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def fused_attention_block(x, gscale, gbias, wq, bq, wo, bo,
                          n_heads: int, groups: int) -> torch.Tensor:
    """y = x + OutProj(MHA(QKVProj(GroupNorm(x)))).

    Signature and flattened weight layout of the JAX ``fused_attention_block``.
    On a CUDA tensor this launches the Hopper kernel (and adds one to
    ``fused_attention_block.launches``); on a CPU tensor it runs
    :func:`attention_block_reference`. When a gradient is wanted it goes
    through :class:`_FusedAttentionBlock`, whose backward is
    :func:`fused_attention_block_bwd`.
    """
    _check(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gscale, gbias, wq, bq, wo, bo)):
        return _FusedAttentionBlock.apply(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)
    return _forward(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)


fused_attention_block.launches = 0


class _FusedAttentionBlock(torch.autograd.Function):
    """The block as an autograd node that saves only its primal inputs, as the
    JAX ``custom_vjp`` does; the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, x, gscale, gbias, wq, bq, wo, bo, n_heads, groups):
        ctx.save_for_backward(x, gscale, gbias, wq, bq, wo, bo)
        ctx.n_heads, ctx.groups = n_heads, groups
        return _forward(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)

    @staticmethod
    def backward(ctx, dy):
        grads = fused_attention_block_bwd(*ctx.saved_tensors, dy.contiguous(),
                                          ctx.n_heads, ctx.groups)
        return grads + (None, None)


def _device_checks(x, n_heads, *weights):
    """The kernels' limits on a CUDA tensor; raises for anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    D = x.shape[2] // n_heads
    if D % 64:
        raise ValueError(f"the kernel takes head_dim a multiple of 64, got {D}")
    if any(t.data_ptr() % 16 for t in (x,) + weights):
        raise ValueError("x and the weights must be 16-byte aligned (the kernels move 16-byte "
                         "vectors)")
    return D


def _forward(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups):
    if x.device.type == "cpu":
        return attention_block_reference(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)
    D = _device_checks(x, n_heads, wq, wo)
    N, S, C = x.shape
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    smem = lib.attn_block_fwd_smem(S, D, int(bf16))
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit or N > 65535 or S * 3 * C >= 2**31:
        raise ValueError(f"shape N={N}, S={S}, C={C} exceeds the kernel's launch limits "
                         f"({smem} B of shared memory, limit {limit}; N <= 65535; an item's "
                         f"qkv under 2^31 elements)")
    y = torch.empty_like(x)
    qkv = torch.empty((N, S, 3 * C), device=x.device, dtype=x.dtype)
    ctx = torch.empty((N, S, C), device=x.device, dtype=x.dtype)
    # float32: the GroupNorm statistics; bf16: the weights rounded for the
    # tensor-core GEMMs, and the GroupNorm stage's plan (its tokens go to ctx)
    if bf16:
        scratch = torch.empty(4 * C * C, device=x.device, dtype=x.dtype)
        plan = _strip(N, S, C, groups, x.element_size())
    else:
        scratch = torch.empty(2 * N * groups, device=x.device, dtype=torch.float32)
        plan = (0,) * 6
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.attn_block_fwd(
            x.data_ptr(), gscale.data_ptr(), gbias.data_ptr(), wq.data_ptr(),
            bq.data_ptr(), wo.data_ptr(), bo.data_ptr(), y.data_ptr(),
            None if bf16 else scratch.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            scratch.data_ptr() if bf16 else None,
            N, S, C, n_heads, groups, 1.0 / math.sqrt(D), int(bf16), *plan, stream)
    if err:
        raise RuntimeError(f"attn_block_fwd launch failed: CUDA error {err}")
    fused_attention_block.launches += 1
    return y


def fused_attention_block_bwd(x, gscale, gbias, wq, bq, wo, bo, dy, n_heads: int, groups: int):
    """(dx, dgscale, dgbias, dwq, dbq, dwo, dbo) of the block at x for dy.

    On a CUDA tensor this launches the Hopper backward kernel (and adds one to
    ``fused_attention_block_bwd.launches``); on a CPU tensor it runs
    :func:`attention_block_backward_reference`.
    """
    _check(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({tuple(x.shape)}, {x.dtype}, {x.device}), got "
                         f"({tuple(dy.shape)}, {dy.dtype}, {dy.device})")
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")
    if x.device.type == "cpu":
        return attention_block_backward_reference(x, gscale, gbias, wq, bq, wo, bo, dy,
                                                  n_heads, groups)
    D = _device_checks(x, n_heads)
    N, S, C = x.shape
    if N * n_heads > 65535 or groups > 64 or S % 8:
        raise ValueError(f"shape N={N}, S={S}, H={n_heads}, G={groups} is outside the backward "
                         f"kernel (N * H <= 65535, G <= 64, S a multiple of 8)")
    if dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    dtype = 0 if x.dtype == torch.float32 else 1
    lib = _lib_bwd()
    # bf16 at head dims 64 and 128 takes the fused route, whose GroupNorm
    # stage is the strip kernel of the forward, planned by strip_plan
    fused = lib.attn_block_bwd_fused(C, n_heads, groups, dtype)
    plan = _strip(N, S, C, groups, x.element_size()) if fused else (0,) * 6
    ws = torch.empty(lib.attn_block_bwd_workspace(N, S, C, n_heads, groups, dtype),
                     dtype=torch.uint8, device=x.device)
    f32 = dict(device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    grads = (torch.empty((1, C), **f32), torch.empty((1, C), **f32), torch.empty((C, 3 * C), **f32),
             torch.empty((1, 3 * C), **f32), torch.empty((C, C), **f32), torch.empty((1, C), **f32))
    with torch.cuda.device(x.device):
        err = lib.attn_block_bwd(
            x.data_ptr(), dy.data_ptr(), gscale.data_ptr(), gbias.data_ptr(), wq.data_ptr(),
            bq.data_ptr(), wo.data_ptr(), dx.data_ptr(), *(g.data_ptr() for g in grads),
            ws.data_ptr(), N, S, C, n_heads, groups, 1.0 / math.sqrt(D), dtype, *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"attn_block_bwd launch failed: CUDA error {err}")
    fused_attention_block_bwd.launches += 1
    return (dx,) + grads


fused_attention_block_bwd.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("attn_block_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_block_fwd_smem.argtypes = [i, i, i]
        lib.attn_block_fwd_smem.restype = ctypes.c_size_t
        lib.attn_block_fwd.argtypes = [p] * 12 + [i] * 5 + [ctypes.c_float] + [i] * 7 + [p]
        lib.attn_block_fwd.restype = i
        lib._typed = True
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("attn_block_bwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_block_bwd_workspace.argtypes = [i] * 6
        lib.attn_block_bwd_workspace.restype = ctypes.c_size_t
        lib.attn_block_bwd_fused.argtypes = [i] * 4
        lib.attn_block_bwd_fused.restype = i
        lib.attn_block_bwd.argtypes = [p] * 15 + [i] * 5 + [ctypes.c_float] + [i] * 7 + [p]
        lib.attn_block_bwd.restype = i
        lib._typed = True
    return lib
