"""The port's GroupNorm(+SiLU) (cfm_tpu_torch/ops/groupnorm.py) against JAX.

- The plain forward against the JAX package's ``_gn_silu_reference``, and the
  plain backward (a transcription of ``_gn_silu_bwd_kernel``) against
  ``jax.vjp`` of it, in f32, at one, three and sixteen channels per group
  over 7x7 and 16x16 maps, with and without the SiLU.
- The plain forward with its statistics and the plain backward against the
  TPU kernel bodies ``_gn_silu_fwd_kernel`` and ``_gn_silu_bwd_kernel`` run
  by a ``pl.pallas_call`` in interpret mode that this file builds (the JAX
  module's own calls pin TPU memory spaces; nothing in it changes).
- A recentred-variance case: f32 with |mean| = 100 std, where the one-pass
  E[x^2] - E[x]^2 variance is off by 9e-3 and fails the test's limit.
- The autograd Function on CPU tensors is the plain forward and backward
  and counts no launches; the wrapper rejects what the kernels do not take.
- ``cuda``-marked tests hold kernels #8 and #9 against the plain versions on
  the card: ``python -m pytest tests/test_torch_groupnorm.py -m cuda -q``.
  They import no JAX, so they run where only PyTorch is installed.
"""

import functools

import numpy as np
import pytest
import torch

from cfm_tpu_torch.ops import groupnorm as tgn

# (N, H, C, G): C / G = 1, 3 and 16 channels per group.
SHAPES = [(2, 7, 32, 32), (2, 16, 32, 32), (4, 7, 96, 32), (2, 16, 96, 32),
          (2, 7, 512, 32), (2, 16, 512, 32)]


def _inputs(N, H, C, seed=0, mean=0.5, std=2.0):
    """x, scale, bias and an output gradient g, f32 numpy."""
    rng = np.random.default_rng(seed)
    x = (mean + std * rng.standard_normal((N, H, H, C))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, scale, bias, g


def _rel_err(a, ref):
    """Largest absolute difference over max(1, the reference's max-abs)."""
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / max(1.0, np.abs(ref).max()))


def _port(x, scale, bias, g, G, silu, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in (x, scale, bias, g)]
    x_t, g_t = t[0].to(dtype), t[3].to(dtype)
    out, mean, inv = tgn.gn_silu_fwd_reference(x_t, t[1], t[2], G, 1e-5, silu)
    dx, dscale, dbias = tgn.gn_silu_bwd_reference(x_t, t[1], t[2], mean, inv, g_t, G, silu)
    return [a.float().numpy() for a in (out, mean, inv, dx, dscale, dbias)]


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("N,H,C,G", SHAPES)
def test_plain_forward_and_backward_match_jax_reference(N, H, C, G, silu):
    """Forward against ``_gn_silu_reference`` and (dx, dscale, dbias) against
    its ``jax.vjp``, each within 1e-5 of max(1, its max-abs): float32, two
    summation orders."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.ops.pallas_groupnorm import _gn_silu_reference

    x, scale, bias, g = _inputs(N, H, C, seed=N * H + C)
    out, _, _, dx, dscale, dbias = _port(x, scale, bias, g, G, silu)
    y_ref, vjp = jax.vjp(lambda *a: _gn_silu_reference(*a, G, 1e-5, silu),
                         *(jnp.asarray(a) for a in (x, scale, bias)))
    refs = (y_ref,) + vjp(jnp.asarray(g))
    for name, got, ref in zip(("out", "dx", "dscale", "dbias"), (out, dx, dscale, dbias), refs):
        assert got.shape == np.shape(ref), name
        assert _rel_err(got, ref) <= 1e-5, (name, _rel_err(got, ref))


def _tpu_kernels(x, scale, bias, g, G, silu):
    """The TPU kernel bodies in Pallas interpret mode, one item per grid step:
    (out, mean (N, C), inv (N, C), dx, dscale (C,), dbias (C,))."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cfm_tpu.ops.pallas_groupnorm import _gn_silu_bwd_kernel, _gn_silu_fwd_kernel

    n, h, w, c = x.shape
    item = pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0))
    vec = pl.BlockSpec((1, c), lambda i: (0, 0))
    stat = pl.BlockSpec((1, 1, 1, c), lambda i: (i, 0, 0, 0))
    f32 = jnp.float32
    scale, bias = scale.reshape(1, c), bias.reshape(1, c)
    out, mean, inv = pl.pallas_call(
        functools.partial(_gn_silu_fwd_kernel, num_groups=G, eps=1e-5, apply_silu=silu),
        grid=(n,), in_specs=[item, vec, vec], out_specs=(item, stat, stat),
        out_shape=(jax.ShapeDtypeStruct(x.shape, x.dtype),
                   jax.ShapeDtypeStruct((n, 1, 1, c), f32), jax.ShapeDtypeStruct((n, 1, 1, c), f32)),
        interpret=True)(x, scale, bias)
    dx, dscale, dbias = pl.pallas_call(
        functools.partial(_gn_silu_bwd_kernel, num_groups=G, apply_silu=silu),
        grid=(n,), in_specs=[item, vec, vec, stat, stat, item], out_specs=(item, vec, vec),
        out_shape=(jax.ShapeDtypeStruct(x.shape, x.dtype), jax.ShapeDtypeStruct((1, c), f32),
                   jax.ShapeDtypeStruct((1, c), f32)),
        interpret=True)(x, scale, bias, mean, inv, g)
    return (out, mean.reshape(n, c), inv.reshape(n, c), dx, dscale.reshape(c), dbias.reshape(c))


_NAMES = ("out", "mean", "inv", "dx", "dscale", "dbias")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("N,H,C,G", [(4, 7, 96, 32), (2, 4, 512, 32), (2, 14, 32, 32)])
def test_plain_matches_tpu_kernels_interpret(N, H, C, G, silu, dtype):
    """Every output within 1e-5 of max(1, its max-abs) in f32. In bf16 x and
    g are bf16 on both sides: out and dx, rounded once to bf16 from f32
    values that differ in the last bits, within 1e-2 (one bf16 rounding
    step of an output up to 2); the f32 statistics and weight gradients
    within 1e-5."""
    import jax.numpy as jnp

    x, scale, bias, g = _inputs(N, H, C, seed=C)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = _tpu_kernels(jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias),
                       jnp.asarray(g, jd), G, silu)
    got = _port(x, scale, bias, g, G, silu, td)
    for name, a, r in zip(_NAMES, got, ref):
        tol = 1e-2 if dtype == "bf16" and name in ("out", "dx") else 1e-5
        assert _rel_err(a, r) <= tol, (name, _rel_err(a, r))


def recentred_inputs():
    """f32 at mean 100, std 1: 7x7 maps, three channels per group. Shared
    with the card-side test and ``chip_smoke.py``."""
    x, scale, bias, g = _inputs(2, 7, 96, seed=21, mean=100.0, std=1.0)
    return x, np.ones_like(scale), np.zeros_like(bias), g


def test_recentred_variance_case():
    """The plain forward agrees with JAX's and with float64 within 1e-4 (both
    two-pass; they read 1.6e-5), while a one-pass variance E[x^2] - E[x]^2
    in f32 misses the float64 result by more than 50 times that (9.0e-3)."""
    import jax.numpy as jnp

    from cfm_tpu.ops.pallas_groupnorm import _gn_silu_reference

    x, scale, bias, _ = recentred_inputs()
    G, tol = 32, 1e-4
    ref = np.asarray(_gn_silu_reference(*(jnp.asarray(a) for a in (x, scale, bias)), G, 1e-5,
                                        False))
    out = tgn.gn_silu_reference(*(torch.from_numpy(a) for a in (x, scale, bias)), G).numpy()
    assert np.abs(out - ref).max() <= tol
    xg = torch.from_numpy(x).reshape(2, 49, G, 3)
    m = xg.mean(dim=(1, 3), keepdim=True)
    one_pass = (xg - m) * torch.rsqrt((xg * xg).mean(dim=(1, 3), keepdim=True) - m * m + 1e-5)
    xd = x.astype(np.float64).reshape(2, 49, G, 3)
    md = xd.mean(axis=(1, 3), keepdims=True)
    exact = (xd - md) / np.sqrt(((xd - md) ** 2).mean(axis=(1, 3), keepdims=True) + 1e-5)
    assert np.abs(out - exact.reshape(x.shape)).max() <= tol
    assert np.abs(one_pass.numpy() - exact).max() > 50 * tol


def test_autograd_on_cpu_is_the_plain_forward_and_backward():
    """With a gradient wanted the wrapper is the autograd Function: its
    output and gradients equal the plain forward and backward, and neither
    direction counts a launch. Without one (no_grad, inference_mode) the
    output has no graph."""
    x, scale, bias, g = _inputs(2, 7, 96, seed=5)
    before = (tgn.fused_group_norm_silu.launches, tgn.fused_group_norm_silu_bwd.launches)
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).requires_grad_()
        st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
        gt = torch.from_numpy(g).to(dtype)
        y = tgn.fused_group_norm_silu(xt, st, bt, 32, 1e-5, True)
        y.backward(gt)
        plain = (xt.detach(), st.detach(), bt.detach())
        out, mean, inv = tgn.gn_silu_fwd_reference(*plain, 32, 1e-5, True)
        ref = tgn.gn_silu_bwd_reference(*plain, mean, inv, gt, 32, True)
        assert y.dtype == dtype and torch.equal(y.detach(), out)
        for name, got, r in zip(("dx", "dscale", "dbias"), (xt.grad, st.grad, bt.grad), ref):
            assert got.dtype == r.dtype and torch.equal(got, r), name
        with torch.no_grad():
            assert tgn.fused_group_norm_silu(xt, st, bt, 32).grad_fn is None
        with torch.inference_mode():
            assert torch.equal(tgn.fused_group_norm_silu(xt, st, bt, 32, 1e-5, True), out)
    assert (tgn.fused_group_norm_silu.launches, tgn.fused_group_norm_silu_bwd.launches) == before


@pytest.mark.parametrize("bad", ["rank", "dtype", "groups", "strided", "scale_shape",
                                 "scale_dtype", "group_width"])
def test_wrapper_rejects_bad_inputs(bad):
    x, scale, bias, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 64))
    G = 32
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.double()
    elif bad == "groups":
        G = 24
    elif bad == "strided":
        x = x.permute(0, 2, 1, 3)
    elif bad == "scale_shape":
        scale = scale[:-1]
    elif bad == "scale_dtype":
        scale = scale.to(torch.bfloat16)
    else:  # 512 channels per group: more than one block's threads
        x = torch.zeros(1, 2, 2, 512)
        scale, bias, G = torch.ones(512), torch.zeros(512), 1
    with pytest.raises((ValueError, TypeError)):
        tgn.fused_group_norm_silu(x, scale, bias, G)


def test_wrapper_rejects_other_devices_and_mismatched_gradients():
    x, scale, bias, g = (torch.from_numpy(a) for a in _inputs(1, 4, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        tgn.fused_group_norm_silu(*(t.to("meta") for t in (x, scale, bias)), 32)
    _, mean, inv = tgn.gn_silu_fwd_reference(x, scale, bias, 32)
    with pytest.raises(ValueError, match="g must be contiguous and match x"):
        tgn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, g.to(torch.bfloat16), 32)
    with pytest.raises(ValueError, match="mean must be"):
        tgn.fused_group_norm_silu_bwd(x, scale, bias, mean[:, :32], inv, g, 32)


def _on_card(x, scale, bias, g, dtype):
    return [torch.from_numpy(a).cuda().to(dtype if i in (0, 3) else torch.float32)
            for i, a in enumerate((x, scale, bias, g))]


def _check_kernels_on_cuda(x, scale, bias, g, G, silu, dtype, tol, wtol):
    """Kernels #8 and #9 against the plain versions on the same card tensors:
    out and dx element-wise within ``tol`` abs + rel, the statistics within
    1e-5 (the mean relative to |mean| + std), dscale and dbias within
    ``wtol`` of their max-abs. One launch each."""
    xt, st, bt, gt = _on_card(x, scale, bias, g, dtype)
    before = (tgn.fused_group_norm_silu.launches, tgn.fused_group_norm_silu_bwd.launches)
    out, mean, inv = tgn.fused_group_norm_silu_fwd(xt, st, bt, G, 1e-5, silu)
    dx, dscale, dbias = tgn.fused_group_norm_silu_bwd(xt, st, bt, mean, inv, gt, G, silu)
    r_out, r_mean, r_inv = tgn.gn_silu_fwd_reference(xt, st, bt, G, 1e-5, silu)
    r_dx, r_ds, r_db = tgn.gn_silu_bwd_reference(xt, st, bt, r_mean, r_inv, gt, G, silu)
    torch.cuda.synchronize()
    assert (tgn.fused_group_norm_silu.launches, tgn.fused_group_norm_silu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for name, a, r in (("out", out, r_out), ("dx", dx, r_dx)):
        a, r = a.float(), r.float()
        assert bool(((a - r).abs() <= tol + tol * r.abs()).all()), name
    assert bool(((mean - r_mean).abs() <= 1e-5 * (r_mean.abs() + 1 / r_inv)).all())
    assert bool(((inv - r_inv).abs() <= 1e-5 * r_inv).all())
    for name, a, r in (("dscale", dscale, r_ds), ("dbias", dbias, r_db)):
        assert (a - r).abs().max().item() <= wtol * r.abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,wtol", [("f32", 1e-4, 1e-4), ("bf16", 2e-2, 1e-3)])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("N,H,C", [(128, 32, 128), (8, 7, 96), (8, 28, 32), (16, 4, 512),
                                   (4, 16, 384)])
def test_kernels_match_plain_on_cuda(N, H, C, silu, dtype, tol, wtol):
    if not torch.cuda.is_available():
        pytest.skip("the GroupNorm kernels run only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    with strict_f32():
        _check_kernels_on_cuda(*_inputs(N, H, C, seed=C), 32, silu,
                               {"f32": torch.float32, "bf16": torch.bfloat16}[dtype], tol, wtol)


@pytest.mark.cuda
def test_kernels_recentred_case_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("the GroupNorm kernels run only on a CUDA device")
    _check_kernels_on_cuda(*recentred_inputs(), 32, False, torch.float32, 1e-4, 1e-4)
