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
  Under ``torch.func`` (vmap of jacrev, vjp and jvp, and the second
  derivative of a trace) it equals autograd of a plain GroupNorm, with the
  mapped axis folded into one launch or split at the grid limit.
- The kernels' plans (``strip_plan``, and with ``backward=True`` the
  backward's, whose share holds x and g) at every shape the six paths give
  ``GroupNorm32``; the backward's plan takes every shape the forward's does.
  Torch models of both kernels' summation orders (strips of whole groups,
  rows split over a cluster, fixed-order combines; for the backward also
  the fixed-order sum over the items) against the plain versions and the
  TPU kernels in interpret mode.
- ``cuda``-marked tests hold kernels #8 and #9 against the plain versions on
  the card, and rerun both for the same bits:
  ``python -m pytest tests/test_torch_groupnorm.py -m cuda -q``.
  They import no JAX, so they run where only PyTorch is installed.
"""

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfm_tpu_torch.ops import groupnorm as tgn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _autograd_group_norm(x, scale, bias, G, eps, silu):
    """GroupNorm(+SiLU) in plain differentiable ops, the yardstick of the
    wrapper's autograd Functions under ``torch.func``."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h * w, G, c // G)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * scale + bias
    return y * torch.sigmoid(y) if silu else y


@pytest.mark.parametrize("silu,grid_items", [(False, tgn._GRID_ITEMS), (True, 5)])
def test_autograd_functions_compose_with_torch_func(monkeypatch, silu, grid_items):
    """Per-sample Jacobians (vmap of jacrev), Hutchinson vjp and jvp
    products, and the gradients of their squares in x, scale and bias (the
    second derivative, as a loss through a trace takes it) equal those of
    ``_autograd_group_norm`` within 1e-5 of each tensor's max-abs; with
    ``grid_items`` 5 the folded launches are split at that limit."""
    monkeypatch.setattr(tgn, "_GRID_ITEMS", grid_items)
    from torch.func import jacrev, jvp, vjp, vmap

    rng = np.random.default_rng(7)
    x, e = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((3, 32), (3, 4, 32)))
    scale, bias = (torch.from_numpy(a.astype(np.float32)).requires_grad_()
                   for a in (1 + 0.3 * rng.standard_normal(8), 0.1 * rng.standard_normal(8)))
    x.requires_grad_()

    def traces(gn):
        f = lambda v: gn(v.reshape(1, 2, 2, 8), scale, bias, 4, 1e-4, silu).reshape(-1)
        jac = vmap(jacrev(f))(x)
        back = vmap(lambda xi, ei: vmap(lambda p: vjp(f, xi)[1](p)[0] @ p)(ei))(x, e)
        fwd = vmap(lambda xi, ei: vmap(lambda p: jvp(f, (xi,), (p,))[1])(ei))(x, e)
        loss = (torch.diagonal(jac, dim1=1, dim2=2).sum(1).square().sum() + back.square().sum()
                + fwd.square().sum())
        return [jac, back, fwd] + list(torch.autograd.grad(loss, (x, scale, bias),
                                                           allow_unused=True,
                                                           materialize_grads=True))

    got, want = traces(tgn.fused_group_norm_silu), traces(_autograd_group_norm)
    for name, g, w in zip(("jacobians", "vjp", "jvp", "dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()), err_msg=name)


@pytest.mark.parametrize("bad", ["rank", "dtype", "groups", "strided", "scale_shape",
                                 "scale_dtype"])
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
    else:
        scale = scale.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        tgn.fused_group_norm_silu(x, scale, bias, G)


# (shape, groups, dtype) that no strip on chip holds, or (N above a grid's
# 65535 rows) that the strip takes in several launches: groups wider than
# 256 channels (ResNetDiffEq at intermediate_dim 8192), channels that are
# not whole 16-byte rows (float32 C = 6, bf16 C = 12), N = 70,000 (2x2 maps:
# at 1x1 a group of two channels normalises to +-1 and dx is rounding noise).
BEYOND_STRIP = [((1, 2, 2, 8192), 16, "f32"), ((2, 4, 4, 6), 6, "f32"),
                ((2, 4, 4, 12), 12, "bf16"), ((70000, 2, 2, 32), 16, "f32")]


def _inputs_of(shape, seed, mean=0.5, std=2.0):
    """x, scale, bias and an output gradient g of x's shape, f32 numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (mean + std * rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,G,dtype", BEYOND_STRIP)
def test_wrapper_computes_what_no_strip_holds(shape, G, dtype):
    """The wrapper (with autograd) computes these shapes and equals the JAX
    reference ``_gn_silu_reference`` and its ``jax.vjp``: every output
    within 1e-5 of max(1, its max-abs) in f32, out and dx within 1e-2 in
    bf16 (one rounding step of values up to 2)."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.ops.pallas_groupnorm import _gn_silu_reference

    x, scale, bias, g = _inputs_of(shape, seed=shape[-1] + G)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    y_ref, vjp = jax.vjp(lambda *a: _gn_silu_reference(*a, G, 1e-5, True),
                         jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias))
    refs = (y_ref,) + vjp(jnp.asarray(g, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    y = tgn.fused_group_norm_silu(xt, st, bt, G, 1e-5, True)
    y.backward(torch.from_numpy(g).to(td))
    for name, got, ref in zip(("out", "dx", "dscale", "dbias"), (y, xt.grad, st.grad, bt.grad),
                              refs):
        tol = 1e-2 if dtype == "bf16" and name in ("out", "dx") else 1e-5
        got = got.detach().float().numpy()
        assert got.shape == np.shape(ref), name
        assert _rel_err(got, np.asarray(ref, np.float32)) <= tol, name


def test_wrapper_rejects_other_devices_and_mismatched_gradients():
    x, scale, bias, g = (torch.from_numpy(a) for a in _inputs(1, 4, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        tgn.fused_group_norm_silu(*(t.to("meta") for t in (x, scale, bias)), 32)
    _, mean, inv = tgn.gn_silu_fwd_reference(x, scale, bias, 32)
    with pytest.raises(ValueError, match="g must be contiguous and match x"):
        tgn.fused_group_norm_silu_bwd(x, scale, bias, mean, inv, g.to(torch.bfloat16), 32)
    with pytest.raises(ValueError, match="mean must be"):
        tgn.fused_group_norm_silu_bwd(x, scale, bias, mean[:, :32], inv, g, 32)


# ---------------------------------------------------------------------------
# The forward kernel's plan and summation order (csrc/gn_strip.cuh)
# ---------------------------------------------------------------------------

# (H, W, C, dtype) of every GroupNorm32 call of one model evaluation (32
# groups; chip_smoke.record_gn_shapes logs them on the card), with the
# paths' batches.
_CIFAR10 = [(32, 32, 128, "bf16"), (16, 16, 128, "bf16"), (16, 16, 256, "bf16"),
            (8, 8, 256, "bf16"), (4, 4, 256, "bf16"), (4, 4, 512, "bf16"), (8, 8, 512, "bf16"),
            (16, 16, 512, "bf16"), (16, 16, 384, "bf16"), (32, 32, 384, "bf16"),
            (32, 32, 256, "bf16"), (32, 32, 128, "f32")]
_MNIST = [(28, 28, 32, "bf16"), (14, 14, 32, "bf16"), (14, 14, 64, "bf16"), (7, 7, 64, "bf16"),
          (7, 7, 128, "bf16"), (14, 14, 128, "bf16"), (14, 14, 96, "bf16"), (28, 28, 96, "bf16"),
          (28, 28, 64, "bf16"), (28, 28, 32, "f32")]
_IMAGENET64 = [(64, 64, 192, "bf16"), (32, 32, 192, "bf16"), (32, 32, 384, "bf16"),
               (16, 16, 384, "bf16"), (16, 16, 576, "bf16"), (8, 8, 576, "bf16"),
               (8, 8, 768, "bf16"), (8, 8, 1536, "bf16"), (8, 8, 1344, "bf16"),
               (16, 16, 768, "bf16"), (16, 16, 1344, "bf16"), (16, 16, 1152, "bf16"),
               (16, 16, 960, "bf16"), (32, 32, 576, "bf16"), (32, 32, 960, "bf16"),
               (32, 32, 768, "bf16"), (64, 64, 384, "bf16"), (64, 64, 576, "bf16"),
               (64, 64, 192, "f32")]
GN_PATHS = {"cifar10 generation": (512, _CIFAR10), "cifar10 training": (128, _CIFAR10),
            "mnist training": (128, _MNIST), "mnist generation": (80, _MNIST),
            "imagenet64 generation": (64, _IMAGENET64), "imagenet64 training": (32, _IMAGENET64)}
_ITEMSIZE = {"bf16": 2, "f32": 4}


def _check_plan(plan, N, HW, C, G, itemsize, backward=False):
    """The invariants gnstrip::plan_ok checks, and the shared-memory limit
    (the backward's share holds x and g, and its cluster may reach 16)."""
    vec, cg = 16 // itemsize, C // G
    assert plan.width % cg == 0 and plan.width % vec == 0 and plan.width <= 256
    assert plan.cluster in ((1, 2, 4, 8, 16) if backward else (1, 2, 4, 8))
    assert plan.rows * plan.cluster >= HW
    assert plan.rows * (plan.cluster - 1) < HW  # every block of a cluster has rows
    assert 1 <= plan.box_rows <= 256 and plan.boxes * plan.box_rows >= plan.rows
    assert plan.boxes == 1 or plan.box_rows % 8 == 0
    assert plan.items * plan.width <= 256
    assert plan.items == 1 or (plan.cluster == 1 and plan.rows == HW == plan.box_rows)
    assert tgn.strip_smem_bytes(plan, itemsize, backward) <= 227 * 1024


@pytest.mark.parametrize("path", list(GN_PATHS))
def test_strip_plan_at_recorded_shapes(path):
    """Whole groups, widths a multiple of 16 bytes, a block's share within
    227 KB, a cluster of at most 8: at every recorded shape of the path."""
    N, shapes = GN_PATHS[path]
    for H, W, C, dt in shapes:
        plan = tgn.strip_plan(N, H * W, C, 32, _ITEMSIZE[dt])
        _check_plan(plan, N, H * W, C, 32, _ITEMSIZE[dt])
        # the planner splits rows only where a whole strip exceeds the share
        assert plan.cluster == 1 or H * W * plan.width * _ITEMSIZE[dt] > tgn.SHARE_BYTES


def _check_split_plan(plan, N, HW, C):
    """The invariants gnsplit::plan_ok checks: a tile of C or 256 channels
    and its row lanes, chunks covering HW, every chunk with rows."""
    assert isinstance(plan, tgn.SplitPlan)
    assert plan.tile == min(C, 256) and plan.lanes == 256 // plan.tile
    assert plan.chunks * plan.rows >= HW > (plan.chunks - 1) * plan.rows


# (N, HW, C, G, itemsize, backward) of what no strip holds: a strip of 8
# float32 channels over 256x256 rows (2 MB, beyond 8 blocks' and 16 blocks'
# shares), channels that are not whole 16-byte rows, a group of 512
# channels; and N = 70,000, which the strip takes over several launches.
PLAN_BEYOND = [(8, 65536, 256, 32, 4, False), (8, 65536, 256, 32, 4, True),
               (1, 512 * 512, 256, 32, 4, True), (2, 16, 36, 12, 2, False),
               (2, 16, 6, 6, 4, False), (2, 16, 12, 12, 2, True), (1, 4, 8192, 16, 4, False),
               (70000, 1, 32, 16, 4, False), (70000, 1024, 64, 32, 2, True)]


@pytest.mark.parametrize("N,HW,C,G,itemsize,backward", PLAN_BEYOND)
def test_strip_plan_rejects_what_the_kernel_cannot_hold(N, HW, C, G, itemsize, backward):
    """No shape the wrapper's checks accept is refused any more: what no
    strip holds gets the split route's plan, and N above a grid's rows keeps
    its strip (the launcher loops over the item groups)."""
    plan = tgn.strip_plan(N, HW, C, G, itemsize, backward=backward)
    if N > 65535:
        assert isinstance(plan, tgn.StripPlan)
        _check_plan(plan, N, HW, C, G, itemsize, backward)
    else:
        _check_split_plan(plan, N, HW, C)


@pytest.mark.parametrize("path", [p for p in GN_PATHS if "training" in p])
def test_strip_plan_bwd_at_recorded_shapes(path):
    """The backward's plan at every shape of a training path: the invariants
    of ``_check_plan`` with x and g in a share within 227 KB, a cluster of
    at most 8 (16 only beyond what 8 blocks hold), rows split only where a
    whole strip of x and g exceeds the share."""
    N, shapes = GN_PATHS[path]
    for H, W, C, dt in shapes:
        plan = tgn.strip_plan(N, H * W, C, 32, _ITEMSIZE[dt], backward=True)
        _check_plan(plan, N, H * W, C, 32, _ITEMSIZE[dt], backward=True)
        assert plan.cluster <= 8
        assert plan.cluster == 1 or 2 * H * W * plan.width * _ITEMSIZE[dt] > tgn.SHARE_BYTES_BWD


def test_strip_plan_bwd_takes_every_forward_shape():
    """Every shape the forward's plan takes (so every autograd path that
    runs forward) has a backward plan that fits, across group widths, dtypes
    and maps up to the forward's limit (the largest maps need a cluster of
    16); far beyond it the backward takes the split route too."""
    taken = 0
    for itemsize in (2, 4):
        for cg in (1, 3, 6, 8, 18, 64, 256):
            for hw in (1, 49, 256, 257, 1000, 4096, 9999, 30000, 50000, 65000, 70000, 300000):
                if isinstance(tgn.strip_plan(4, hw, 32 * cg, 32, itemsize), tgn.SplitPlan):
                    continue
                plan = tgn.strip_plan(4, hw, 32 * cg, 32, itemsize, backward=True)
                _check_plan(plan, 4, hw, 32 * cg, 32, itemsize, backward=True)
                taken += 1
    assert taken > 100
    assert tgn.strip_plan(1, 65000, 32, 32, 2, backward=True).cluster == 16
    _check_split_plan(tgn.strip_plan(1, 512 * 512, 256, 32, 4, backward=True), 1, 512 * 512, 256)


def _strip_model(x, scale, bias, G, eps, silu, plan):
    """(out, mean, inv) as the strip kernel computes them: per 16-byte column
    of a strip, each row slot r0 of R adds rows r0, r0 + R, ... of its
    block's share in order; L lanes (the least power of two with 4 L >= R,
    at most 32) take a channel: lane l adds slots l, l + L, ... in order,
    then the L lanes pairwise (xor L / 2, ..., 1); then the cluster's blocks
    are added in rank order, then a group's channels in order; the second
    pass adds fmaf(d, d, s) (one rounding); inv = 1 / sqrtf(var + eps)."""
    n, h, w, c = x.shape
    hw, cg, vec = h * w, c // G, 16 // x.element_size()
    width, cs, rows = plan.width, plan.cluster, plan.rows
    nv = width // vec
    slots = (256 // plan.items) // nv
    strips = -(-c // width)
    xf = F.pad(x.float().reshape(n, hw, c), (0, strips * width - c)).reshape(n, hw, strips, width)

    def totals(vals, add):
        tot = torch.zeros(n, strips, width)
        for rank in range(cs):
            share = vals[:, rank * rows:(rank + 1) * rows]
            steps = -(-share.shape[1] // slots)
            share = F.pad(share, (0, 0, 0, 0, 0, steps * slots - share.shape[1]))
            share = share.reshape(n, steps, slots, strips, width)
            acc = torch.zeros(n, slots, strips, width)
            for i in range(steps):
                acc = add(acc, share[:, i])
            nl = 1
            while nl < 32 and 4 * nl < slots:
                nl *= 2
            lanes = torch.zeros(n, nl, strips, width)
            for r in range(0, slots, nl):
                part = acc[:, r:r + nl]
                lanes = lanes + F.pad(part, (0, 0, 0, 0, 0, nl - part.shape[1]))
            o = nl // 2
            while o:
                lanes = lanes + lanes[:, torch.arange(nl) ^ o]
                o //= 2
            tot = tot + lanes[:, 0]
        groups = tot.reshape(n, strips, width // cg, cg)
        g = torch.zeros(n, strips, width // cg)
        for j in range(cg):
            g = g + groups[..., j]
        return g.repeat_interleave(cg, dim=-1)

    cnt = torch.tensor(float(hw * cg))
    mean = totals(xf, lambda s, v: s + v) / cnt
    d = xf - mean[:, None]
    fma = lambda s, v: (s.double() + v.double() * v.double()).float()
    inv = 1.0 / torch.sqrt(totals(d, fma) / cnt + eps)
    mean_c, inv_c = (t.reshape(n, strips * width)[:, :c] for t in (mean, inv))
    out = (d * inv[:, None]).reshape(n, hw, -1)[..., :c] * scale + bias
    if silu:
        out = out * torch.sigmoid(out)
    return out.reshape(x.shape).to(x.dtype), mean_c, inv_c


def _variant(plan, hw, variant):
    """The planner's plan, or one that takes several items a block or splits
    the rows over a cluster of 4, so the model covers every branch."""
    if variant == "items" and hw <= 256 and 2 * plan.width <= 256:
        return plan._replace(items=2, cluster=1, rows=hw, box_rows=hw, boxes=1)
    if variant == "cluster" and hw >= 16:
        rows = -(-hw // 4)
        boxes = -(-rows // 256)
        return plan._replace(items=1, cluster=4, rows=rows, boxes=boxes,
                             box_rows=rows if boxes == 1 else -(-rows // (8 * boxes)) * 8)
    return plan


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cg,H", [(1, 4), (1, 28), (2, 7), (4, 32), (6, 64), (12, 8), (18, 16),
                                  (24, 4), (24, 8)])
def test_strip_model_matches_plain_and_tpu_kernel(cg, H, dtype):
    """The model of #8's summation order, under the planner's plan and under
    a plan with several items a block and one with a cluster of 4, against
    the plain forward and the TPU kernel in interpret mode: every output
    within 1e-5 of max(1, its max-abs) in f32; in bf16 out within the
    existing 1e-2 (one bf16 rounding step of an output up to 2), the f32
    statistics within 1e-5."""
    import jax.numpy as jnp

    C, G, N = 32 * cg, 32, 2
    x, scale, bias, g = _inputs(N, H, C, seed=cg * 100 + H)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xt = torch.from_numpy(x).to(td)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    ref = tgn.gn_silu_fwd_reference(xt, st, bt, G, 1e-5, True)
    tpu = _tpu_kernels(jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias),
                       jnp.asarray(g, jd), G, True)[:3]
    planned = tgn.strip_plan(N, H * H, C, G, xt.element_size())
    plans = {_variant(planned, H * H, v) for v in ("planned", "items", "cluster")}
    for plan in plans:
        _check_plan(plan, N, H * H, C, G, xt.element_size())
        got = _strip_model(xt, st, bt, G, 1e-5, True, plan)
        for other in (ref, tpu):
            for name, a, r in zip(("out", "mean", "inv"), got, other):
                tol = 1e-2 if dtype == "bf16" and name == "out" else 1e-5
                r = r.float() if isinstance(r, torch.Tensor) else np.asarray(r, np.float32)
                assert _rel_err(a.float().numpy(), r) <= tol, (plan, name)


def _bwd_strip_model(x, scale, bias, mean, inv, g, G, silu, plan):
    """(dx, dscale, dbias) as strip_bwd_kernel and item_sum_kernel compute
    them: norm and dy per element in f32; per 16-byte column of a strip, row
    slot r0 of R adds rows r0, r0 + R, ... of its block's share in order,
    dy for the first sum and fmaf(dy, norm, s) for the second (one
    rounding); L lanes take a channel as in ``_strip_model``; the cluster's
    blocks are added in rank order; m1 and m2 add a group's channels' sums
    times scale in channel order, over HW * cg; dx = inv * (dy * scale - m1
    - norm * m2), rounded once to x's dtype; dscale and dbias add the items'
    column sums on 32 lanes, lane l the items l, l + 32, ... in order, then
    the lanes pairwise (xor 16, ..., 1)."""
    n, h, w, c = x.shape
    hw, cg, vec = h * w, c // G, 16 // x.element_size()
    width, cs, rows = plan.width, plan.cluster, plan.rows
    slots = (256 // plan.items) // (width // vec)
    strips = -(-c // width)
    cp = strips * width
    pad = lambda t: F.pad(t, (0, cp - c))
    xf, gf = (pad(t.float().reshape(n, hw, c)) for t in (x, g))
    mu, iv = pad(mean)[:, None], pad(inv)[:, None]
    sc, bi = pad(scale), pad(bias)
    norm = (xf - mu) * iv
    if silu:
        y = norm * sc + bi
        sig = torch.sigmoid(y)
        dy = gf * sig * (1.0 + y * (1.0 - sig))
    else:
        dy = gf
    nl = 1
    while nl < 32 and 4 * nl < slots:
        nl *= 2

    def totals(add, *vals):  # per-channel totals (n, cp) in the kernel's order
        vals = [v.reshape(n, hw, strips, width) for v in vals]
        tot = torch.zeros(n, strips, width)
        for rank in range(cs):
            share = [v[:, rank * rows:(rank + 1) * rows] for v in vals]
            steps = -(-share[0].shape[1] // slots)
            share = [F.pad(v, (0, 0, 0, 0, 0, steps * slots - v.shape[1]))
                     .reshape(n, steps, slots, strips, width) for v in share]
            acc = torch.zeros(n, slots, strips, width)
            for i in range(steps):
                acc = add(acc, *(v[:, i] for v in share))
            lanes = torch.zeros(n, nl, strips, width)
            for r in range(0, slots, nl):
                part = acc[:, r:r + nl]
                lanes = lanes + F.pad(part, (0, 0, 0, 0, 0, nl - part.shape[1]))
            o = nl // 2
            while o:
                lanes = lanes + lanes[:, torch.arange(nl) ^ o]
                o //= 2
            tot = tot + lanes[:, 0]
        return tot.reshape(n, cp)

    db = totals(lambda s, d: s + d, dy)
    ds = totals(lambda s, d, m: (s.double() + d.double() * m.double()).float(), dy, norm)

    def group_mean(t):  # a group's channels in order, over HW * cg
        t = t.reshape(n, cp // cg, cg)
        acc = torch.zeros(n, cp // cg)
        for k in range(cg):
            acc = acc + t[..., k]
        return (acc / torch.tensor(float(hw * cg))).repeat_interleave(cg, dim=-1)[:, None]

    m1, m2 = group_mean(db * sc), group_mean(ds * sc)
    dx = iv * (dy * sc - m1 - norm * m2)

    def item_sum(t):
        lanes = torch.zeros(32, c)
        for i in range(n):
            lanes[i % 32] = lanes[i % 32] + t[i, :c]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[torch.arange(32) ^ o]
        return lanes[0]

    return dx[..., :c].reshape(x.shape).to(x.dtype), item_sum(ds), item_sum(db)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("cg,H", [(1, 4), (1, 28), (2, 7), (4, 32), (6, 64), (12, 8), (18, 16),
                                  (24, 4), (24, 8)])
def test_bwd_strip_model_matches_plain_and_tpu_kernel(cg, H, dtype):
    """The model of #9's summation order, under the backward's planned plan,
    a plan with several items a block and one with a cluster of 4, against
    ``gn_silu_bwd_reference`` and the TPU kernel in interpret mode, with
    the SiLU, at N = 40 up to 16x16 maps (two rounds of the item sum's 32
    lanes) and N = 4 above: every output
    within 1e-5 of max(1, its max-abs) in f32; in bf16 dx within 1e-2 (one
    bf16 rounding step of a gradient up to 2), dscale and dbias within 1e-5."""
    import jax.numpy as jnp

    C, G, N = 32 * cg, 32, 40 if H <= 16 else 4
    x, scale, bias, g = _inputs(N, H, C, seed=cg * 100 + H + 1)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xt, gt = torch.from_numpy(x).to(td), torch.from_numpy(g).to(td)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    _, mean, inv = tgn.gn_silu_fwd_reference(xt, st, bt, G, 1e-5, True)
    ref = tgn.gn_silu_bwd_reference(xt, st, bt, mean, inv, gt, G, True)
    tpu = _tpu_kernels(jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias),
                       jnp.asarray(g, jd), G, True)[3:]
    planned = tgn.strip_plan(N, H * H, C, G, xt.element_size(), backward=True)
    plans = {_variant(planned, H * H, v) for v in ("planned", "items", "cluster")}
    for plan in plans:
        _check_plan(plan, N, H * H, C, G, xt.element_size(), backward=True)
        got = _bwd_strip_model(xt, st, bt, mean, inv, gt, G, True, plan)
        for other in (ref, tpu):
            for name, a, r in zip(("dx", "dscale", "dbias"), got, other):
                tol = 1e-2 if dtype == "bf16" and name == "dx" else 1e-5
                r = r.float() if isinstance(r, torch.Tensor) else np.asarray(r, np.float32)
                assert _rel_err(a.float().numpy(), r) <= tol, (plan, name)


# ---------------------------------------------------------------------------
# The split route (csrc/gn_split.cuh): row chunks, sums through device memory
# ---------------------------------------------------------------------------


def _fma(s, a, b):
    """fmaf(a, b, s): one rounding (the f32 product is exact in float64)."""
    return (s.double() + a.double() * b.double()).float()


def _chunk_partials(add, plan, hw, *vals):
    """Per (item, chunk, channel) sums as stats_partial and bwd_partial take
    them: lane l of a block adds rows l, l + lanes, ... of its chunk in
    order, then the lanes are added in lane order. vals: (n, hw, c)."""
    n, c = vals[0].shape[0], vals[0].shape[2]
    out = torch.zeros(n, plan.chunks, c)
    for k in range(plan.chunks):
        chunk = [v[:, k * plan.rows:min(hw, (k + 1) * plan.rows)] for v in vals]
        steps = -(-chunk[0].shape[1] // plan.lanes)
        chunk = [F.pad(v, (0, 0, 0, steps * plan.lanes - v.shape[1]))
                 .reshape(n, steps, plan.lanes, c) for v in chunk]
        acc = torch.zeros(n, plan.lanes, c)
        for i in range(steps):
            acc = add(acc, *(v[:, i] for v in chunk))
        tot = torch.zeros(n, c)
        for lane in range(plan.lanes):
            tot = tot + acc[:, lane]
        out[:, k] = tot
    return out


def _chunk_sum(part):
    """(n, chunks, c) -> (n, c): lane L of a warp adds chunks L, L + 32, ...
    in order, then the 32 lanes pairwise (xor 16, ..., 1)."""
    n, chunks, c = part.shape
    lanes = torch.zeros(n, 32, c)
    for k in range(chunks):
        lanes[:, k % 32] = lanes[:, k % 32] + part[:, k]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ o]
    return lanes[:, 0]


def _warp_group_sum(per_channel, G):
    """(n, c) -> (n, G): warp w adds a group's channels w, w + 8, ... in
    order, then the eight warps in order."""
    n, c = per_channel.shape
    t = per_channel.reshape(n, G, c // G)
    warps = torch.zeros(n, G, 8)
    for j in range(c // G):
        warps[..., j % 8] = warps[..., j % 8] + t[..., j]
    tot = torch.zeros(n, G)
    for w in range(8):
        tot = tot + warps[..., w]
    return tot


def _split_model(x, scale, bias, G, eps, silu, plan):
    """(out, mean, inv) as the split route computes them: chunk partials,
    the chunk and group combine, the second pass by fmaf, then the
    element-wise epilogue."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // G
    xf = x.float().reshape(n, hw, c)
    cnt = torch.tensor(float(hw * cg))

    def group_stat(part):
        return _warp_group_sum(_chunk_sum(part), G) / cnt

    mean = group_stat(_chunk_partials(lambda s, v: s + v, plan, hw, xf)).repeat_interleave(cg, -1)
    d = xf - mean[:, None]
    var = group_stat(_chunk_partials(lambda s, v: _fma(s, v, v), plan, hw, d))
    inv = (1.0 / torch.sqrt(var + eps)).repeat_interleave(cg, -1)
    out = d * inv[:, None] * scale + bias
    if silu:
        out = out * torch.sigmoid(out)
    return out.reshape(x.shape).to(x.dtype), mean, inv


def _bwd_split_model(x, scale, bias, mean, inv, g, G, silu, plan):
    """(dx, dscale, dbias) as the split route computes them: chunk partials
    of dy and fmaf(dy, norm), each channel's chunks on a warp, m1 and m2 by
    the warps' channel order, dx element-wise, dscale and dbias over the
    items as item_sum_kernel adds them."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // G
    xf, gf = (t.float().reshape(n, hw, c) for t in (x, g))
    norm = (xf - mean[:, None]) * inv[:, None]
    if silu:
        y = norm * scale + bias
        sig = torch.sigmoid(y)
        dy = gf * sig * (1.0 + y * (1.0 - sig))
    else:
        dy = gf
    db = _chunk_sum(_chunk_partials(lambda s, d: s + d, plan, hw, dy))
    ds = _chunk_sum(_chunk_partials(lambda s, d, m: _fma(s, d, m), plan, hw, dy, norm))
    cnt = torch.tensor(float(hw * cg))
    m1, m2 = ((_warp_group_sum(t * scale, G) / cnt).repeat_interleave(cg, -1)[:, None]
              for t in (db, ds))
    dx = inv[:, None] * (dy * scale - m1 - norm * m2)

    def item_sum(t):
        lanes = torch.zeros(32, c)
        for i in range(n):
            lanes[i % 32] = lanes[i % 32] + t[i]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[torch.arange(32) ^ o]
        return lanes[0]

    return dx.reshape(x.shape).to(x.dtype), item_sum(ds), item_sum(db)


# (N, H, C, G, dtype): channels that are not whole 16-byte rows, a group of
# 512 channels over 32 tiles, a C of a full tile and a tail (cg = 100 across
# the tiles), and a narrow C with four row lanes.
SPLIT_CASES = [(2, 4, 6, 6, "f32"), (2, 4, 12, 12, "bf16"), (1, 2, 8192, 16, "f32"),
               (2, 8, 300, 3, "f32"), (3, 16, 64, 32, "bf16")]


@pytest.mark.parametrize("N,H,C,G,dtype", SPLIT_CASES)
def test_split_model_matches_plain_and_tpu_kernel(N, H, C, G, dtype):
    """The model of the split route's summation orders, under its plan and
    under one of 5-row chunks (more chunks than a warp's 32 lanes at 16x16),
    forward and backward with the SiLU, against the plain versions and the
    TPU kernels in interpret mode: every output within 1e-5 of max(1, its
    max-abs) in f32, out and dx within 1e-2 in bf16 (the f32 statistics and
    weight gradients within 1e-5)."""
    import jax.numpy as jnp

    x, scale, bias, g = _inputs_of((N, H, H, C), seed=C + G)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xt, gt = torch.from_numpy(x).to(td), torch.from_numpy(g).to(td)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    out, mean, inv = tgn.gn_silu_fwd_reference(xt, st, bt, G, 1e-5, True)
    ref = (out, mean, inv) + tgn.gn_silu_bwd_reference(xt, st, bt, mean, inv, gt, G, True)
    tpu = _tpu_kernels(jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias),
                       jnp.asarray(g, jd), G, True)
    planned = tgn.split_plan(N, H * H, C)
    chunked = planned._replace(rows=5, chunks=-(-H * H // 5))
    for plan in {planned, chunked}:
        _check_split_plan(plan, N, H * H, C)
        got = _split_model(xt, st, bt, G, 1e-5, True, plan)
        got += _bwd_split_model(xt, st, bt, got[1], got[2], gt, G, True, plan)
        for other in (ref, tpu):
            for name, a, r in zip(_NAMES, got, other):
                tol = 1e-2 if dtype == "bf16" and name in ("out", "dx") else 1e-5
                r = r.float() if isinstance(r, torch.Tensor) else np.asarray(r, np.float32)
                assert _rel_err(a.float().numpy(), np.asarray(r).reshape(a.shape)) <= tol, \
                    (plan, name)


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
                                   (4, 16, 384), (2, 64, 192), (64, 8, 768)])
def test_kernels_match_plain_on_cuda(N, H, C, silu, dtype, tol, wtol):
    """Also at a cluster of 8 (64x64, 192 channels) and several items a
    block (8x8 at N = 64); the forward's and the backward's reruns give the
    same bits (fixed-order sums, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("the GroupNorm kernels run only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    inputs = _inputs(N, H, C, seed=C)
    with strict_f32():
        _check_kernels_on_cuda(*inputs, 32, silu, td, tol, wtol)
    xt, st, bt, gt = _on_card(*inputs, td)
    first = tgn.fused_group_norm_silu_fwd(xt, st, bt, 32, 1e-5, silu)
    again = tgn.fused_group_norm_silu_fwd(xt, st, bt, 32, 1e-5, silu)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    _, mean, inv = first
    first = tgn.fused_group_norm_silu_bwd(xt, st, bt, mean, inv, gt, 32, silu)
    again = tgn.fused_group_norm_silu_bwd(xt, st, bt, mean, inv, gt, 32, silu)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,G,dtype", BEYOND_STRIP + [((2, 256, 256, 256), 32, "f32")])
def test_kernels_beyond_the_strip_match_plain_on_cuda(shape, G, dtype):
    """The split route (and the strip over several launches at N = 70,000)
    against the plain versions as ``_check_kernels_on_cuda`` holds them,
    with and without the SiLU, and reruns giving the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("the GroupNorm kernels run only on a CUDA device")
    from cfm_tpu_torch.device import strict_f32

    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tol, wtol = (1e-4, 1e-4) if dtype == "f32" else (2e-2, 1e-3)
    inputs = _inputs_of(shape, seed=shape[-1])
    for silu in (False, True):
        with strict_f32():
            _check_kernels_on_cuda(*inputs, G, silu, td, tol, wtol)
    xt, st, bt, gt = _on_card(*inputs, td)
    first = tgn.fused_group_norm_silu_fwd(xt, st, bt, G, 1e-5, True)
    assert all(torch.equal(a, b) for a, b in zip(
        first, tgn.fused_group_norm_silu_fwd(xt, st, bt, G, 1e-5, True)))
    _, mean, inv = first
    first = tgn.fused_group_norm_silu_bwd(xt, st, bt, mean, inv, gt, G, True)
    again = tgn.fused_group_norm_silu_bwd(xt, st, bt, mean, inv, gt, G, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_kernels_recentred_case_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("the GroupNorm kernels run only on a CUDA device")
    _check_kernels_on_cuda(*recentred_inputs(), 32, False, torch.float32, 1e-4, 1e-4)
