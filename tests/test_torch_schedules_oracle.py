"""The port's noise schedules (cfm_tpu_torch/schedules.py) and the closed-form
Schrödinger-bridge oracle (cfm_tpu_torch/eval/sb_oracle.py) against JAX's
(cfm_tpu/schedules.py, cfm_tpu/eval/sb_oracle.py) on shared numpy inputs.
Values within 1e-6 relative (of each result's max-abs; the KLs' matrix
inverses and log-determinants within 1e-5)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu import schedules as js
from cfm_tpu.eval import sb_oracle as jo
from cfm_tpu_torch import schedules as ts
from cfm_tpu_torch.eval import sb_oracle as to

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from flax_variables import fast_jit  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, rtol=1e-6):
    ref = np.asarray(ref, np.float64)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


SCHEDULES = [
    ("constant", lambda m: m.ConstantNoiseScheduler(0.5)),
    ("constant_small", lambda m: m.ConstantNoiseScheduler(0.1)),
    ("linear", lambda m: m.LinearDecreasingNoiseScheduler()),
    ("linear_wide", lambda m: m.LinearDecreasingNoiseScheduler(0.2, 2.0)),
    ("cosine", lambda m: m.CosineNoiseScheduler()),
    ("cosine_half", lambda m: m.CosineNoiseScheduler(0.5)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, make):
    """g, F, the bridge std and d/dt log sigma_t on a grid inside (0, 1)
    (the log-derivative's eps floor at the ends included), on a (bs, 1)
    column as the bridge matcher calls them, and on a Python float."""
    t = np.concatenate([[0.0, 1e-4], np.linspace(0.01, 0.99, 37), [1 - 1e-4, 1.0]])
    t = t.astype(np.float32)[:, None]
    j, p = make(js), make(ts)
    tt = torch.from_numpy(t)
    for fn in ("g", "F", "bridge_sigma_t"):
        out, ref = getattr(p, fn)(tt), getattr(j, fn)(jnp.asarray(t))
        assert out.dtype == torch.float32 and out.shape == tt.shape, fn
        _close(out, ref)
        _close(getattr(p, fn)(0.3), getattr(j, fn)(0.3))
    inner = slice(1, -1)  # the ends divide the eps floor; held within 1e-5
    out = p.bridge_sigma_t_prime_over_sigma_t(tt)
    ref = np.asarray(j.bridge_sigma_t_prime_over_sigma_t(jnp.asarray(t)))
    _close(out[inner], ref[inner], rtol=2e-6)
    _close(out, ref, rtol=1e-5)


def test_schedule_casts_time_to_float32():
    """A float64 or integer t is cast to float32, as jnp.asarray(t, float32)."""
    p = ts.CosineNoiseScheduler(0.7)
    for t in (torch.tensor([0.25, 0.5], dtype=torch.float64), torch.tensor([0, 1])):
        assert p.g(t).dtype == torch.float32 and p.F(t).dtype == torch.float32
        _close(p.F(t), js.CosineNoiseScheduler(0.7).F(jnp.asarray(t.numpy())))


@pytest.mark.parametrize("a,sigma,dim", [(0.1, 0.5, 2), (1.0, 1.0, 3), (0.3, 2.0, 1)])
def test_sb_gaussian_marginal_matches_jax(a, sigma, dim):
    marginal = fast_jit(lambda t: jo.sb_gaussian_marginal(a, sigma, t, dim))
    for t in (0.0, 0.3, 0.5, 1.0):
        mean, cov = to.sb_gaussian_marginal(a, sigma, t, dim)
        rm, rc = marginal(t)
        _close(mean, rm)
        _close(cov, rc)


def test_gaussian_kl_matches_jax():
    rng = np.random.default_rng(0)
    d = 3
    A, B = rng.standard_normal((2, d, d)).astype(np.float32)
    cp, cq = A @ A.T + 0.5 * np.eye(d, dtype=np.float32), B @ B.T + np.eye(d, dtype=np.float32)
    mp, mq = rng.standard_normal((2, d)).astype(np.float32)
    out = to.gaussian_kl(*(torch.from_numpy(v) for v in (mp, cp, mq, cq)))
    ref = fast_jit(jo.gaussian_kl)(*(jnp.asarray(v) for v in (mp, cp, mq, cq)))
    _close(out, ref, rtol=1e-5)
    same = to.gaussian_kl(torch.from_numpy(mp), torch.from_numpy(cp), torch.from_numpy(mp),
                          torch.from_numpy(cp))
    assert abs(float(same)) < 1e-5


@pytest.mark.parametrize("dim", [1, 2, 5])
def test_sb_marginal_kl_matches_jax(dim):
    """At dim 1 JAX fits the biased variance (jnp.var), above it the
    unbiased covariance (jnp.cov, n - 1): at n = 16 the two differ by 1/15,
    far above the tolerance, so each branch is held to its own."""
    rng = np.random.default_rng(dim)
    xt = (0.2 + 1.3 * rng.standard_normal((16, dim))).astype(np.float32)
    kl = fast_jit(lambda x, t: jo.sb_marginal_kl(x, 0.1, 0.5, t))
    for t in (0.2, 0.5):
        out = to.sb_marginal_kl(torch.from_numpy(xt), 0.1, 0.5, t)
        ref = kl(jnp.asarray(xt), t)
        _close(out, ref, rtol=1e-5)
    other = (xt.var(axis=0, ddof=1) if dim == 1 else np.cov(xt.T, ddof=0))
    fit = to.sb_marginal_kl(torch.from_numpy(xt), 0.1, 0.5, 0.5)
    alt = fast_jit(lambda m, c: jo.gaussian_kl(m, jnp.atleast_2d(c),
                                               *jo.sb_gaussian_marginal(0.1, 0.5, 0.5, dim)))(
        jnp.asarray(xt.mean(0)), jnp.asarray(other))
    assert abs(float(fit) - float(alt)) > 1e-3


def test_sb_trajectory_kl_matches_jax():
    rng = np.random.default_rng(3)
    traj = rng.standard_normal((5, 64, 2)).astype(np.float32)
    ts_ = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    out = to.sb_trajectory_kl(torch.from_numpy(traj), torch.from_numpy(ts_), 0.1, 0.5)
    ref = fast_jit(lambda x, t: jo.sb_trajectory_kl(x, t, 0.1, 0.5))(jnp.asarray(traj),
                                                                      jnp.asarray(ts_))
    _close(out, ref, rtol=1e-5)


def test_sample_sb_endpoints_statistics():
    """The draws are the port's own (a torch.Generator): x0 from N(-a, I)
    first, then x1 from N(+a, I), reproducible from the seed."""
    x0, x1 = to.sample_sb_endpoints(torch.Generator().manual_seed(0), 20000, a=0.5, dim=3)
    again = to.sample_sb_endpoints(torch.Generator().manual_seed(0), 20000, a=0.5, dim=3)
    assert torch.equal(x0, again[0]) and torch.equal(x1, again[1])
    assert x0.shape == x1.shape == (20000, 3)
    np.testing.assert_allclose(x0.mean(0).numpy(), -0.5, atol=0.03)
    np.testing.assert_allclose(x1.mean(0).numpy(), 0.5, atol=0.03)
    np.testing.assert_allclose(x1.std(0).numpy(), 1.0, atol=0.03)
