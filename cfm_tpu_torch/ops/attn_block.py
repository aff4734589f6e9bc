"""The UNet AttentionBlock in one call: GN + qkv proj + MHA + out proj + residual.

Counterpart of ``cfm_tpu/ops/pallas_attn_block.py`` (forward only; the
backward kernel comes with the training slice).

- :func:`attention_block_reference` is the plain PyTorch version: a batched
  transcription of the TPU kernel's ``_fwd_kernel`` with its rounding points.
  The CPU path and the oracle the CUDA kernel is held against.
- :func:`fused_attention_block` is the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the hand-written Hopper kernel
  (``csrc/attn_block_fwd.cu``) or raises. It never falls back.
- :func:`use_fused_block` is the JAX gate's shape and budget test, so both
  packages route the same blocks here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cfm_tpu_torch.ops import _build

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
    :func:`attention_block_reference`.
    """
    _check(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)
    if x.device.type == "cpu":
        return attention_block_reference(x, gscale, gbias, wq, bq, wo, bo, n_heads, groups)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gscale, gbias, wq, bq, wo, bo)):
        raise NotImplementedError(
            "the attention-block kernel has no backward yet (it comes with the "
            "training slice); call it under torch.no_grad() or torch.inference_mode()")
    N, S, C = x.shape
    D = C // n_heads
    if D % 64:
        raise ValueError(f"the kernel takes head_dim a multiple of 64, got {D}")
    lib = _lib()
    smem = lib.attn_block_fwd_smem(S, D)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit or N > 65535:
        raise ValueError(f"shape N={N}, S={S}, D={D} exceeds the kernel's launch limits "
                         f"({smem} B of shared memory, limit {limit}; N <= 65535)")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads 16-byte vectors)")
    y = torch.empty_like(x)
    stats = torch.empty(2 * N * groups, device=x.device, dtype=torch.float32)
    qkv = torch.empty((N, S, 3 * C), device=x.device, dtype=x.dtype)
    ctx = torch.empty((N, S, C), device=x.device, dtype=x.dtype)
    # bf16 only: the weights rounded and transposed for the tensor-core GEMMs
    wt = (torch.empty(4 * C * C, device=x.device, dtype=x.dtype)
          if x.dtype == torch.bfloat16 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.attn_block_fwd(
            x.data_ptr(), gscale.data_ptr(), gbias.data_ptr(), wq.data_ptr(),
            bq.data_ptr(), wo.data_ptr(), bo.data_ptr(), y.data_ptr(),
            stats.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
            None if wt is None else wt.data_ptr(),
            None if wt is None else wt[3 * C * C:].data_ptr(),
            N, S, C, n_heads, groups, 1.0 / math.sqrt(D),
            0 if x.dtype == torch.float32 else 1, stream)
    if err:
        raise RuntimeError(f"attn_block_fwd launch failed: CUDA error {err}")
    fused_attention_block.launches += 1
    return y


fused_attention_block.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("attn_block_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_block_fwd_smem.argtypes = [i, i]
        lib.attn_block_fwd_smem.restype = ctypes.c_size_t
        lib.attn_block_fwd.argtypes = [p] * 13 + [i] * 5 + [ctypes.c_float, i, p]
        lib.attn_block_fwd.restype = i
        lib._typed = True
    return lib
