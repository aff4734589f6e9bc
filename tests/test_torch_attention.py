"""The port's multi-head attention (cfm_tpu_torch/ops/attention.py, kernels #3
and #4) against JAX.

The plain forward is held against the JAX kernel ``_fwd_kernel`` run in
Pallas interpret mode on the CPU, through both ``fused_attention_t`` and the
(N, S, 3, H, D) ``fused_attention``; the plain backward against ``jax.vjp``
of the same, whose backward is ``_bwd_kernel`` in interpret mode. float32
within 1e-5 of the output's max-abs (summation order only); bfloat16 within
one bf16 rounding step (both sides round the same float32 value, whose two
summation orders may straddle a rounding boundary). The routing gate must
equal JAX's ``_gate``. The CUDA kernels are held against the plain versions
by the ``cuda``-marked tests, which skip without a card; the JAX package is
imported inside the tests that use it, so those also run where only PyTorch
is installed: ``python -m pytest tests/test_torch_attention.py -m cuda -q``.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cfm_tpu_torch.ops import attention as tatt

_DTYPES = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}
SHAPES = [(2, 3, 256, 64), (2, 1, 128, 128)]  # (N, H, S, D), both pass the gate


def _jax(dtype="f32"):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.ops import pallas_attention

    return SimpleNamespace(jax=jax, jnp=jnp, pa=pallas_attention,
                           dtype=getattr(jnp, _DTYPES[dtype][0]))


def _qkv_t(N, H, S, D, seed=0):
    return np.random.default_rng(seed).standard_normal((N, 3, H, S, D)).astype(np.float32)


def bf16_step(ref):
    """One bf16 rounding step at the output's largest magnitude: the spacing
    of bf16 numbers there. Both sides round the same float32 sums, and a
    softmax weight whose two float32 values straddle a bf16 boundary rounds
    one step apart, which moves its row of the output by that step of the
    weight times v."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _assert_close(out, ref, dtype):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "f32":
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, atol=bf16_step(ref), rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,H,S,D", SHAPES)
def test_forward_matches_jax_kernel_interpret(monkeypatch, N, H, S, D, dtype):
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    qkv_t = _qkv_t(N, H, S, D)
    scale = 1.0 / math.sqrt(D)
    ref_t = j.pa.fused_attention_t(j.jnp.asarray(qkv_t, j.dtype), scale)
    ref = j.pa.fused_attention(j.jnp.asarray(qkv_t.transpose(0, 3, 1, 2, 4), j.dtype), scale)
    before = tatt.attention_t.launches
    out_t = tatt.attention_t(torch.from_numpy(qkv_t).to(tdtype), scale)
    out = tatt.attention(torch.from_numpy(qkv_t.transpose(0, 3, 1, 2, 4)).to(tdtype), scale)
    assert out_t.dtype == tdtype and out_t.shape == (N, H, S, D)
    assert tatt.attention_t.launches == before
    _assert_close(out_t, ref_t, dtype)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,H,S,D", SHAPES)
def test_backward_matches_jax_vjp_interpret(monkeypatch, N, H, S, D, dtype):
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    qkv_t = _qkv_t(N, H, S, D, seed=1)
    do = np.random.default_rng(2).standard_normal((N, H, S, D)).astype(np.float32)
    scale = 1.0 / math.sqrt(D)
    _, vjp = j.jax.vjp(lambda a: j.pa.fused_attention_t(a, scale),
                       j.jnp.asarray(qkv_t, j.dtype))
    ref = vjp(j.jnp.asarray(do, j.dtype))[0]
    out = tatt.attention_t_bwd(torch.from_numpy(qkv_t).to(tdtype),
                               torch.from_numpy(do).to(tdtype), scale)
    assert out.dtype == tdtype
    _assert_close(out, ref, dtype)


_IMAGENET64 = [(12, 64, 64), (9, 256, 64), (6, 1024, 64)]  # (H, S, D) at 8x8, 16x16, 32x32


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gate_agrees_with_jax_on_imagenet64_shapes(monkeypatch, dtype):
    """The port's gate equals JAX's ``_gate`` (its backend clause lifted by
    interpret mode) on a grid that holds the three attention shapes of the
    ImageNet-64 UNet; of those only the 16x16 blocks pass, in both dtypes."""
    j = _jax(dtype)
    monkeypatch.setattr(j.pa, "INTERPRET", True)
    tdtype = _DTYPES[dtype][1]
    grid = [(H, S, D) for H in (1, 2, 6, 9, 12, 16) for S in (64, 128, 256, 384, 512, 896, 1024)
            for D in (32, 64, 128)]
    for H, S, D in grid + _IMAGENET64:
        assert tatt.gate(H, S, D, tdtype) == j.pa._gate(H, S, D, j.jnp.dtype(j.dtype)), (H, S, D)
    assert [tatt.gate(H, S, D, tdtype) for H, S, D in _IMAGENET64] == [False, True, False]


def test_autograd_backward_on_cpu_is_the_plain_backward():
    """At a gated shape the gradient through :func:`attention_t` is the
    transcription of ``_bwd_kernel``, not autograd of the plain forward, and
    counts no launch; at a shape the gate refuses it is autograd of the
    plain composition, as in the JAX package."""
    qkv_t = torch.from_numpy(_qkv_t(2, 2, 128, 64, seed=3)).to(torch.bfloat16)
    do = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 2, 128, 64))
                          .astype(np.float32)).to(torch.bfloat16)
    before = (tatt.attention_t.launches, tatt.attention_t_bwd.launches)
    leaf = qkv_t.clone().requires_grad_()
    tatt.attention_t(leaf, 0.125).backward(do)
    assert torch.equal(leaf.grad, tatt.attention_t_bwd_reference(qkv_t, do, 0.125))
    auto = qkv_t.clone().requires_grad_()
    tatt.attn_reference_t(auto, 0.125).backward(do)
    assert not torch.equal(auto.grad, leaf.grad)
    assert (tatt.attention_t.launches, tatt.attention_t_bwd.launches) == before
    small = qkv_t[:, :, :, :16].clone().requires_grad_()   # S = 16: refused
    tatt.attention_t(small, 0.125).backward(do[:, :, :16])
    ref = qkv_t[:, :, :, :16].clone().requires_grad_()
    tatt.attn_reference_t(ref, 0.125).backward(do[:, :, :16])
    assert torch.equal(small.grad, ref.grad)


def test_wrappers_reject_bad_inputs():
    qkv_t = torch.zeros(1, 3, 1, 128, 64)
    with pytest.raises(ValueError, match="N, 3, H, S, D"):
        tatt.attention_t(qkv_t[:, :2], 0.125)
    with pytest.raises(ValueError, match="do must be"):
        tatt.attention_t_bwd(qkv_t, torch.zeros(1, 1, 128, 64, dtype=torch.bfloat16), 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.attention_t(qkv_t.to("meta"), 0.125)


def _card_inputs(N, H, S, D, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv_t = torch.randn((N, 3, H, S, D), generator=g, device="cuda").to(dtype)
    do = torch.randn((N, H, S, D), generator=g, device="cuda").to(dtype)
    return qkv_t, do


_CARD_SHAPES = [(4, 1, 128, 64), (2, 2, 512, 64), (8, 9, 256, 64), (2, 2, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("N,H,S,D", _CARD_SHAPES)
def test_forward_kernel_matches_plain_on_cuda(N, H, S, D, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("the attention kernel runs only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    qkv_t, _ = _card_inputs(N, H, S, D, _DTYPES[dtype][1])
    before = tatt.attention_t.launches
    with torch.no_grad(), strict_f32():
        out = tatt.attention_t(qkv_t, 1.0 / math.sqrt(D))
        ref = tatt.attn_reference_t(qkv_t, 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    assert tatt.attention_t.launches == before + 1
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("N,H,S,D", _CARD_SHAPES)
def test_backward_kernel_matches_plain_on_cuda(N, H, S, D, dtype, tol):
    """Through the autograd Function: the gradient launches the backward
    kernel once and agrees with the plain backward element-wise, abs+rel."""
    if not torch.cuda.is_available():
        pytest.skip("the attention backward kernel runs only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    qkv_t, do = _card_inputs(N, H, S, D, _DTYPES[dtype][1], seed=1)
    leaf = qkv_t.clone().requires_grad_()
    before = tatt.attention_t_bwd.launches
    with strict_f32():
        tatt.attention_t(leaf, 1.0 / math.sqrt(D)).backward(do)
        ref = tatt.attention_t_bwd_reference(qkv_t, do, 1.0 / math.sqrt(D))
    torch.cuda.synchronize()
    assert tatt.attention_t_bwd.launches == before + 1
    np.testing.assert_allclose(leaf.grad.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=tol, rtol=tol)
