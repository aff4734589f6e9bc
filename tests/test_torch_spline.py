"""The port's natural cubic splines and spline CFM (cfm_tpu_torch/spline.py)
against JAX's (cfm_tpu/spline.py), on shared numpy inputs and, for the
matcher, the draws JAX makes from its key (the chaining's Gumbel noise, t
and eps). Values, slopes and the matcher's (t, xt, ut) within 1e-5
relative (of each tensor's max-abs)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu import spline as jsp
from cfm_tpu_torch import spline as tsp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _knots(K=5, uneven=False):
    ts = np.linspace(0.0, K - 1.0, K, dtype=np.float32)
    if uneven:
        ts = np.cumsum(np.r_[0.0, np.random.default_rng(0).uniform(0.3, 1.5, K - 1)]).astype(
            np.float32)
    return ts


@pytest.mark.parametrize("shape,uneven", [((5, 3), False), ((16, 5, 2), True),
                                          ((4, 2, 5, 3), False)])
def test_fit_natural_cubic_spline_matches_jax(shape, uneven):
    ys = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ts = _knots(shape[-2], uneven)
    ref = jax.jit(jsp.fit_natural_cubic_spline)(jnp.asarray(ts), jnp.asarray(ys))
    out = tsp.fit_natural_cubic_spline(_t(ts), _t(ys))
    _close(out.m, ref.m)
    # Natural: zero curvature at both ends (to the solve's rounding).
    ends = torch.stack([out.m[..., 0, :], out.m[..., -1, :]])
    assert float(ends.abs().max()) <= 1e-5 * float(out.m.abs().max())


@pytest.mark.parametrize("derivative", [False, True])
def test_spline_eval_matches_jax_on_every_batching(derivative):
    rng = np.random.default_rng(2)
    ts = _knots(5, uneven=True)
    per = rng.standard_normal((12, 5, 3)).astype(np.float32)
    t_batch = rng.uniform(ts[0] - 0.2, ts[-1] + 0.2, 12).astype(np.float32)  # ends extrapolate
    cases = [(per, np.float32(1.7)), (per, t_batch), (per[0], t_batch), (per[:1], t_batch),
             (rng.standard_normal((12, 2, 5, 3)).astype(np.float32), t_batch)]
    @jax.jit
    def ref_eval(ts, ys, t):
        sp = jsp.fit_natural_cubic_spline(ts, ys)
        return (sp.derivative if derivative else sp.evaluate)(t)

    for ys, t in cases:
        sp = tsp.fit_natural_cubic_spline(_t(ts), _t(ys))
        ref = ref_eval(jnp.asarray(ts), jnp.asarray(ys), jnp.asarray(t))
        out = (sp.derivative if derivative else sp.evaluate)(_t(t))
        assert out.shape == ref.shape, (ys.shape, np.shape(t))
        _close(out, ref)
    sp = tsp.fit_natural_cubic_spline(_t(ts), _t(per[:3]))
    with pytest.raises(ValueError, match="does not match spline batch"):
        sp.evaluate(_t(t_batch))


def test_spline_interpolates_its_knots():
    rng = np.random.default_rng(3)
    ts = _knots(4, uneven=True)
    ys = rng.standard_normal((6, 4, 2)).astype(np.float32)
    sp = tsp.fit_natural_cubic_spline(_t(ts), _t(ys))
    for k in range(4):
        torch.testing.assert_close(sp.evaluate(float(ts[k])), _t(ys[:, k]), rtol=0, atol=1e-5)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_matcher_draws(key, bs, T, shape):
    """The numbers JAX's spline matcher draws from ``key``."""
    plan_key, t_key, eps_key = jax.random.split(key, 3)
    keys = jax.random.split(plan_key, T - 1)
    gumbel = [jax.vmap(lambda k: jax.random.gumbel(k, (bs,)))(jax.random.split(keys[t], bs))
              for t in range(T - 1)]
    t = jax.random.uniform(t_key, (bs,), minval=0.0, maxval=float(T - 1))
    return gumbel, t, jax.random.normal(eps_key, (bs,) + shape)


@pytest.mark.parametrize("ot_method,shape", [("exact", (2,)), ("none", (2,)), ("exact", (2, 2))])
def test_spline_matcher_matches_jax_given_its_draws(ot_method, shape):
    """Tie-free clouds, so the exact chaining is deterministic."""
    bs, T = 32, 5
    X = (np.random.default_rng(4).standard_normal((bs, T) + shape)
         + np.arange(T).reshape((1, T) + (1,) * len(shape))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    gumbel, t, eps = _jax_matcher_draws(key, bs, T, shape)
    gumbel, t, eps = [_t(g) for g in gumbel], _t(t), _t(eps)
    ref = jax.jit(jsp.SplineConditionalFlowMatcher(sigma=0.1, ot_method=ot_method)
                  .sample_location_and_conditional_flow)(key, jnp.asarray(X))
    matcher = tsp.SplineConditionalFlowMatcher(sigma=0.1, ot_method=ot_method)
    out = matcher.sample_location_and_conditional_flow(None, _t(X), t=t, eps=eps, gumbel=gumbel)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        _close(a, b)
    drawn = matcher.sample_location_and_conditional_flow(torch.Generator().manual_seed(0), _t(X))
    assert all(a.shape == b.shape for a, b in zip(drawn, ref))
    assert 0.0 <= float(drawn[0].min()) and float(drawn[0].max()) < T - 1
