"""Multi-head self-attention, kernels #3 and #4 (counterpart of
``cfm_tpu/ops/pallas_attention.py``).

- :func:`attn_reference_t` is the plain forward on the kernel layout
  (N, 3, H, S, D) -> (N, H, S, D), with the TPU kernel ``_fwd_kernel``'s
  rounding points: logits and softmax in float32, the weights rounded to the
  input dtype, the value product accumulated in float32 and rounded.
  :func:`attention_t_bwd_reference` is the plain backward, a batched
  transcription of ``_bwd_kernel`` (not autograd of the plain forward, which
  would round at other points). They are the CPU path and the oracles the
  CUDA kernels are held against.
- :func:`attention_t` is the wrapper, ``fused_attention_t``'s counterpart. At
  a shape :func:`gate` admits a CPU tensor runs the plain versions and a
  CUDA tensor launches ``csrc/attention_fwd.cu`` (adding one to
  ``attention_t.launches``) or raises. A shape the gate refuses takes the
  plain composition, with autograd through it, as the JAX package does,
  except on CUDA where :func:`streamed_route` admits it: there the Hopper
  kernels run it in their streaming form (the gate's budget is the TPU's
  VMEM, which they do not have). When a gradient is wanted the kernels are a
  ``torch.autograd.Function`` that saves ``qkv_t``, as the JAX
  ``custom_vjp`` does (and the rows' statistics, below), and whose backward
  is :func:`attention_t_bwd` (``csrc/attention_bwd.cu`` on CUDA, counted in
  ``attention_t_bwd.launches``). Nothing falls back. With spans on, a call
  of the streamed route counts ``attn.streamed_route`` and a CUDA call of
  the plain composition ``attn.plain`` (``profiling.count``).
- On CUDA, bf16 at head dims 64 and 128 takes the Hopper kernels (TMA and
  ``wgmma``; they need ``scale > 0``). Their backward is two launches that
  share a (3, N, H, S) float32 buffer of row statistics (max, sum, delta)
  the wrapper allocates; no (S, S) scratch. Above S = 256 the autograd
  Function's forward also keeps the rows' max and sum, (2, N, H, S) float32,
  which the backward takes as ``saved`` in place of recomputing them: the
  same bits, one pass over K less. float32 and other head dims take
  the FMA forward and the staged backward, whose (S, S) scratch the wrapper
  allocates.
- :func:`attention` is the (N, S, 3, H, D) -> (N, S, H, D) entry,
  ``fused_attention``'s counterpart: the same kernels between two transposes.

The UNet's ``AttentionBlock`` comes here where the fused-block gate
(``ops/attn_block.py``) fails. At guided-diffusion's ImageNet-64 widths its
16x16 blocks (C = 576, 9 heads of 64) take kernel #3 in both packages. Its
32x32 blocks (S = 1024, C = 384, 6 heads of 64: over #3's budget) take the
plain composition in the JAX package and on the CPU, and the streamed
route in bf16 on CUDA. The CIFAR-10 recipe's ``mid_attn`` at 4x4 (S = 16)
takes the plain composition everywhere.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cfm_tpu_torch import profiling
from cfm_tpu_torch.ops import _build

_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def _vmem_bytes(H: int, S: int, D: int, itemsize: int) -> int:
    return itemsize * 7 * H * S * D + 4 * (3 * S * S + 4 * S * D)


def gate(H: int, S: int, D: int, dtype: torch.dtype) -> bool:
    """The JAX ``_gate`` without its backend clause: shapes the Pallas
    attention kernel takes."""
    itemsize = dtype.itemsize
    aligned = S % 128 == 0 and D % 64 == 0
    return aligned and _vmem_bytes(H, S, D, itemsize) <= _VMEM_BUDGET_BYTES


def streamed_route(S: int, D: int, dtype: torch.dtype) -> bool:
    """Shapes beyond :func:`gate` that the Hopper kernels take on CUDA, in
    their streaming form: bf16 at head dims 64 and 128, S a multiple of 64
    above 256. A launch beyond the kernels' limits raises, as at a gated
    shape."""
    return _tensor_core_route(D, dtype) and S % 64 == 0 and S > 256


def attn_reference_t(qkv_t: torch.Tensor, scale: float) -> torch.Tensor:
    """Logits and softmax in float32, weights rounded to the input dtype, then
    the value product accumulated in float32 and rounded."""
    q, k, v = qkv_t[:, 0], qkv_t[:, 1], qkv_t[:, 2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(qkv_t.dtype)
    return (w.float() @ v.float()).to(qkv_t.dtype)


def attention_t_bwd_reference(qkv_t: torch.Tensor, do: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """dqkv_t (N, 3, H, S, D) for the output gradient ``do`` (N, H, S, D).

    q, k, v and do upcast from the input dtype; ``wf`` the float32 softmax
    and ``w`` it rounded to the input dtype; dv = w^T do, dp = do v^T,
    dw = dp - rowsum(dp * w), ds = wf * dw * scale; dq = ds k and dk = ds^T q
    with float32 ds; dqkv rounded to the input dtype once.
    """
    lp = qkv_t.dtype
    q, k, v = qkv_t.float().unbind(1)
    dof = do.float()
    logits = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    wf = e / e.sum(dim=-1, keepdim=True)
    w = wf.to(lp).float()
    dv = w.transpose(-1, -2) @ dof
    dp = dof @ v.transpose(-1, -2)
    ds = wf * (dp - (dp * w).sum(dim=-1, keepdim=True)) * scale
    return torch.stack([ds @ k, ds.transpose(-1, -2) @ q, dv], dim=1).to(lp)


def attention_t(qkv_t: torch.Tensor, scale: float) -> torch.Tensor:
    """Multi-head self-attention on the kernel layout: (N, 3, H, S, D) ->
    (N, H, S, D), softmax(q k^T * scale) v per item and head."""
    if qkv_t.dim() != 5 or qkv_t.shape[1] != 3:
        raise ValueError(f"qkv_t must be (N, 3, H, S, D), got shape {tuple(qkv_t.shape)}")
    _, _, H, S, D = qkv_t.shape
    if not gate(H, S, D, qkv_t.dtype):
        if qkv_t.device.type != "cuda" or not streamed_route(S, D, qkv_t.dtype):
            if qkv_t.device.type == "cuda":
                profiling.count("attn.plain")
            return attn_reference_t(qkv_t, scale)
        profiling.count("attn.streamed_route")
    qkv_t = qkv_t.contiguous()
    if torch.is_grad_enabled() and qkv_t.requires_grad:
        return _Attention.apply(qkv_t, scale)
    return _forward(qkv_t, scale)


attention_t.launches = 0


def attention(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    """Multi-head self-attention: (N, S, 3, H, D) -> (N, S, H, D), the JAX
    ``fused_attention``. It is :func:`attention_t` between two transposes."""
    return attention_t(qkv.permute(0, 2, 3, 1, 4), scale).transpose(1, 2)


class _Attention(torch.autograd.Function):
    """Attention on the kernels as an autograd node that saves qkv_t (and
    on the streamed route the rows' max and sum); the backward recomputes
    the softmax."""

    @staticmethod
    def forward(ctx, qkv_t, scale):
        N, _, H, S, D = qkv_t.shape
        saved = None
        if qkv_t.device.type == "cuda" and _tensor_core_route(D, qkv_t.dtype) and S > 256:
            saved = torch.empty((2, N, H, S), dtype=torch.float32, device=qkv_t.device)
        ctx.save_for_backward(qkv_t, saved)
        ctx.scale = scale
        return _forward(qkv_t, scale, saved)

    @staticmethod
    def backward(ctx, do):
        qkv_t, saved = ctx.saved_tensors
        return attention_t_bwd(qkv_t, do.contiguous(), ctx.scale, saved), None


def _dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype argument; raises for what they do not take."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the attention kernels take float32 or bfloat16, got {t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError("the attention kernels load 16-byte vectors: align the tensor")
    return 0 if t.dtype == torch.float32 else 1


def _tensor_core_route(D: int, dtype: torch.dtype) -> bool:
    """bf16 at head dims 64 and 128 takes the wgmma kernels; float32 and
    other head dims the FMA forward and the staged backward."""
    return dtype == torch.bfloat16 and D in (64, 128)


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """Shared memory a block may opt in to on CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).shared_memory_per_block_optin


def _check_launch(qkv_t: torch.Tensor, scale: float, smem: int, what: str) -> None:
    """Raise for shapes outside the kernels' launch limits."""
    N, _, H, S, D = qkv_t.shape
    limit = _smem_limit(qkv_t.device.index)
    tiled = _tensor_core_route(D, qkv_t.dtype)
    if tiled and not scale > 0:
        raise ValueError(f"the bf16 attention kernels take scale > 0, got {scale}")
    if smem > limit or N > 65535 or H > 65535 or (tiled and (S % 64 or 3 * N * H * S >= 2**31)):
        raise ValueError(f"shape N={N}, H={H}, S={S}, D={D} exceeds the {what} kernel's launch "
                         f"limits ({smem} B of shared memory, limit {limit}; N, H <= 65535; "
                         f"bf16 at D = 64, 128: S a multiple of 64, 3 N H S < 2^31)")


def _forward(qkv_t: torch.Tensor, scale: float, saved=None) -> torch.Tensor:
    """The forward kernel; on the streamed route it writes the rows' max and
    sum into ``saved`` where it is given."""
    if qkv_t.device.type == "cpu":
        return attn_reference_t(qkv_t, scale)
    dtype = _dtype_code(qkv_t)
    N, _, H, S, D = qkv_t.shape
    lib = _lib()
    _check_launch(qkv_t, scale, lib.attention_fwd_smem(S, D, dtype), "forward")
    out = torch.empty((N, H, S, D), device=qkv_t.device, dtype=qkv_t.dtype)
    with torch.cuda.device(qkv_t.device):
        err = lib.attention_fwd(qkv_t.data_ptr(), out.data_ptr(),
                                0 if saved is None else saved.data_ptr(), N, H, S, D, scale,
                                dtype, torch.cuda.current_stream(qkv_t.device).cuda_stream)
    if err:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {err}")
    attention_t.launches += 1
    return out


def attention_t_bwd(qkv_t: torch.Tensor, do: torch.Tensor, scale: float,
                    saved=None) -> torch.Tensor:
    """dqkv_t (N, 3, H, S, D) of :func:`attention_t` at ``qkv_t`` for the
    output gradient ``do`` (N, H, S, D), both contiguous.

    On a CUDA tensor this launches the Hopper backward kernels (and adds one
    to ``attention_t_bwd.launches``); on a CPU tensor it runs
    :func:`attention_t_bwd_reference`. ``saved`` is None or, in bf16 at
    D = 64, 128 and S > 256, the (2, N, H, S) rows' max and sum the forward
    kernel kept at this ``qkv_t``; the result has the same bits either way.
    """
    if qkv_t.dim() != 5 or qkv_t.shape[1] != 3 or not qkv_t.is_contiguous():
        raise ValueError(f"qkv_t must be a contiguous (N, 3, H, S, D), got shape "
                         f"{tuple(qkv_t.shape)}")
    N, _, H, S, D = qkv_t.shape
    if tuple(do.shape) != (N, H, S, D) or do.dtype != qkv_t.dtype or do.device != qkv_t.device \
            or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous {(N, H, S, D)} {qkv_t.dtype} on "
                         f"{qkv_t.device}, got {tuple(do.shape)} {do.dtype} on {do.device}")
    if qkv_t.device.type == "cpu":
        return attention_t_bwd_reference(qkv_t, do, scale)
    dqkv = _backward(qkv_t, do, scale, split=True, saved=saved)
    attention_t_bwd.launches += 1
    return dqkv


attention_t_bwd.launches = 0


def _backward(qkv_t: torch.Tensor, do: torch.Tensor, scale: float, split: bool,
              saved=None) -> torch.Tensor:
    """Launch the backward on CUDA tensors :func:`attention_t_bwd` checked.
    bf16 at D = 64, 128 takes the two fused kernels, with dq and dk as three
    exact bf16 products (``split``, the wrapper's choice) or on f32 FMA
    (``split=False``, kept for the A/B timing), and the forward's ``saved``
    statistics where given; otherwise the staged route."""
    dtype = _dtype_code(qkv_t)
    _dtype_code(do)
    N, _, H, S, D = qkv_t.shape
    lib = _lib_bwd()
    dqkv = torch.empty_like(qkv_t)
    stream = torch.cuda.current_stream(qkv_t.device).cuda_stream
    tiled = _tensor_core_route(D, qkv_t.dtype)
    if saved is not None and (not tiled or S <= 256 or saved.shape != (2, N, H, S)
                              or saved.dtype != torch.float32 or saved.device != qkv_t.device
                              or not saved.is_contiguous()):
        raise ValueError(f"saved must be the forward's contiguous (2, {N}, {H}, {S}) float32 "
                         f"statistics, kept in bf16 at D = 64, 128 and S > 256")
    if tiled:
        _check_launch(qkv_t, scale, lib.attention_bwd_fused_smem(S, D, int(split)), "backward")
        stats = torch.empty((3, N, H, S), dtype=torch.float32, device=qkv_t.device)
        with torch.cuda.device(qkv_t.device):
            err = lib.attention_bwd_fused(qkv_t.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                                          stats.data_ptr(),
                                          0 if saved is None else saved.data_ptr(), N, H, S, D,
                                          scale, int(split), stream)
    else:
        if S % 8 or D % 64 or N * H > 65535:
            raise ValueError(f"shape N={N}, H={H}, S={S}, D={D} is outside the backward kernel "
                             f"(S a multiple of 8, D of 64, N * H <= 65535)")
        ws = torch.empty(lib.attention_bwd_workspace(N, H, S), dtype=torch.uint8,
                         device=qkv_t.device)
        with torch.cuda.device(qkv_t.device):
            err = lib.attention_bwd(qkv_t.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                                    ws.data_ptr(), N, H, S, D, scale, dtype, stream)
    if err:
        raise RuntimeError(f"attention_bwd launch failed: CUDA error {err}")
    return dqkv


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attention_fwd_smem.argtypes = [i, i, i]
        lib.attention_fwd_smem.restype = ctypes.c_size_t
        lib.attention_fwd.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.attention_fwd.restype = i
        lib._typed = True
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("attention_bwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attention_bwd_workspace.argtypes = [i, i, i]
        lib.attention_bwd_workspace.restype = ctypes.c_size_t
        lib.attention_bwd.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.attention_bwd.restype = i
        lib.attention_bwd_fused_smem.argtypes = [i, i, i]
        lib.attention_bwd_fused_smem.restype = ctypes.c_size_t
        lib.attention_bwd_fused.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.attention_bwd_fused.restype = i
        lib._typed = True
    return lib
