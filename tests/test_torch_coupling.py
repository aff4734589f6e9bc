"""The port's OT coupling and matchers (cfm_tpu_torch/coupling.py, paths.py,
ops/cost.py, utils.py) against JAX, on shared numpy inputs.

Exact plans must be equal when both sides solve with the same algorithm,
and the plan-sampling indices equal when the port is handed JAX's own
uniforms; the batch is a power of two so that the CDF of the 1/n plan is
exact in f32. The entropic, unbalanced, partial and general-marginal plans
agree within rtol 1e-4, atol 1e-7, and the flash route's pairs are equal
given the Gumbel noise and fallback partners JAX draws from its key.
"""

import numpy as np
import pytest
import torch

from cfm_tpu_torch import coupling as tcp
from cfm_tpu_torch import paths as tpa
from cfm_tpu_torch import utils as tut
from cfm_tpu_torch.ops.cost import sq_euclidean_cost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clouds(n, d=6, seed=0, shift=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            (rng.standard_normal((n, d)) + shift).astype(np.float32))


@pytest.mark.parametrize("shape", [(8, 6), (4, 4, 4, 3)])
def test_sq_euclidean_cost_matches_jax(shape):
    import jax.numpy as jnp

    from cfm_tpu.ops.cost import sq_euclidean_cost as jcost

    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape).astype(np.float32) + 50.0
    b = rng.standard_normal(shape).astype(np.float32) + 50.0
    ref = np.asarray(jcost(jnp.asarray(a), jnp.asarray(b)))
    out = sq_euclidean_cost(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert (out >= 0).all()


@pytest.mark.parametrize("solver,n", [("auction", 16), ("auction", 64), ("auto", 32)])
def test_get_map_plans_are_equal(solver, n):
    """"auction" on both sides; "auto" is the JV solver in JAX and scipy's
    in the port on the CPU, both exact."""
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    x0, x1 = _clouds(n, seed=n)
    ref, bad_ref = OTPlanSampler("exact", solver=solver).get_map(
        jnp.asarray(x0), jnp.asarray(x1), return_status=True)
    plan, bad = tcp.OTPlanSampler("exact", solver=solver).get_map(
        torch.from_numpy(x0), torch.from_numpy(x1), return_status=True)
    np.testing.assert_array_equal(plan.numpy(), np.asarray(ref))
    assert bad.dtype == torch.bool and not bool(bad) and not bool(bad_ref)


@pytest.mark.parametrize("n", [8, 32])
def test_sample_map_equal_given_jax_uniforms(n):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    x0, x1 = _clouds(n, seed=2)
    pi = np.array(OTPlanSampler("exact").get_map(jnp.asarray(x0), jnp.asarray(x1)))
    key = jax.random.PRNGKey(n)
    i_ref, j_ref = OTPlanSampler.sample_map(key, jnp.asarray(pi), n)
    u = np.array(jax.random.uniform(key, (n,), minval=0.0, maxval=1.0))
    i, j = tcp.OTPlanSampler.sample_map(None, torch.from_numpy(pi), n, noise=torch.from_numpy(u))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(j.numpy(), np.asarray(j_ref))


def test_sample_map_without_replacement_equal_given_jax_gumbels():
    import jax
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    n = 8
    x0, x1 = _clouds(n, seed=3)
    pi = np.array(OTPlanSampler("exact").get_map(jnp.asarray(x0), jnp.asarray(x1)))
    key = jax.random.PRNGKey(5)
    i_ref, j_ref = OTPlanSampler.sample_map(key, jnp.asarray(pi), n, replace=False)
    g = np.array(jax.random.gumbel(key, (n * n,)))
    i, j = tcp.OTPlanSampler.sample_map(None, torch.from_numpy(pi), n, replace=False,
                                        noise=torch.from_numpy(g))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(j.numpy(), np.asarray(j_ref))
    # without replacement every (i, j) of the permutation plan is drawn once
    assert sorted(i.tolist()) == list(range(n))


def test_sample_plan_pairs_by_the_plan_and_shortens_distances():
    n = 16
    x0, x1 = (torch.from_numpy(a) for a in _clouds(n, seed=4))
    s = tcp.OTPlanSampler("exact")
    a, b, bad = s.sample_plan(torch.Generator().manual_seed(0), x0, x1, return_status=True)
    assert a.shape == b.shape == (n, 6) and not bool(bad)
    plan = s.get_map(x0, x1)
    rows = [int((x0 == r).all(1).nonzero()[0]) for r in a]
    cols = [int((x1 == r).all(1).nonzero()[0]) for r in b]
    assert all(plan[i, j] > 0 for i, j in zip(rows, cols))
    d_ot = ((a - b) ** 2).sum(1).mean()
    assert d_ot < ((x0 - x1) ** 2).sum(1).mean()
    y0, y1 = torch.arange(n), torch.arange(n) + 100
    a2, b2, ya, yb, bad2 = s.sample_plan_with_labels(
        torch.Generator().manual_seed(0), x0, x1, y0, y1, return_status=True)
    assert torch.equal(a2, a) and torch.equal(b2, b)
    assert torch.equal(x0[ya], a2) and torch.equal(x1[yb - 100], b2)
    keep0, perm1 = s.sample_plan_exact_order(x0, x1)
    assert torch.equal(keep0, x0) and torch.equal(s.sample_plan_with_scipy(x0, x1)[1], perm1)


def test_degenerate_plan_falls_back_to_uniform_and_flags_it(monkeypatch):
    """A plan with no mass is replaced by the uniform coupling and flagged
    (warned about only on the CPU, where reading the flag costs no sync)."""
    x0, x1 = (torch.from_numpy(a) for a in _clouds(4, seed=5))
    monkeypatch.setattr(tcp, "_plan_from_perm", lambda perm, n, m: torch.zeros(n, m))
    s = tcp.OTPlanSampler("exact", solver="auction")
    with pytest.warns(UserWarning, match="Degenerate"):
        plan, bad = s.get_map(x0, x1, return_status=True)
    assert bool(bad) and torch.allclose(plan, torch.full((4, 4), 1 / 16))


def test_unported_methods_and_marginals_raise():
    """An unknown method still raises. The entropic methods and the exact
    plan between batches of unequal sizes, which raised before the entropic
    branch was ported, now build and match JAX (the exact plan to 1e-6: both
    are the unique LP optimum, from a network simplex or HiGHS)."""
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    with pytest.raises(ValueError, match="Unknown method"):
        tcp.OTPlanSampler("simplex")
    s = tcp.OTPlanSampler("sinkhorn")
    assert (s.reg, s.reg_m, s.num_iters, s.flash) == (0.05, 1.0, 1000, None)
    x0, x1 = _clouds(4, seed=6)
    ref = OTPlanSampler("exact").get_map(jnp.asarray(x0), jnp.asarray(x1[:3]))
    plan = tcp.OTPlanSampler("exact").get_map(torch.from_numpy(x0), torch.from_numpy(x1[:3]))
    np.testing.assert_allclose(plan.numpy(), np.asarray(ref), atol=1e-6)


def _plan_clouds(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            (rng.standard_normal((m, 2)) * 1.2 + 1.0).astype(np.float32))


@pytest.mark.parametrize("method", ["exact", "sinkhorn", "unbalanced", "partial"])
@pytest.mark.parametrize("weighted", [False, True])
def test_get_map_of_every_method_matches_jax(method, weighted):
    """At n = 48, m = 40 (and weighted marginals): the plan within rtol 1e-4,
    atol 1e-7, the same degenerate flag."""
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    n, m = 48, 40
    x0, x1 = _plan_clouds(n, m, seed=20)
    rng = np.random.default_rng(21)
    a, b = (rng.uniform(0.5, 1.5, k).astype(np.float32) for k in (n, m))
    a, b = a / a.sum(), b / b.sum()
    kw = dict(reg=0.5, reg_m=(1.0, 2.0))
    ja = dict(a=jnp.asarray(a), b=jnp.asarray(b)) if weighted else {}
    ta = dict(a=torch.from_numpy(a), b=torch.from_numpy(b)) if weighted else {}
    ref, bad_ref = OTPlanSampler(method, **kw).get_map(jnp.asarray(x0), jnp.asarray(x1),
                                                       return_status=True, **ja)
    plan, bad = tcp.OTPlanSampler(method, **kw).get_map(torch.from_numpy(x0),
                                                        torch.from_numpy(x1),
                                                        return_status=True, **ta)
    np.testing.assert_allclose(plan.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-7)
    assert bool(bad) == bool(bad_ref) is False


@pytest.mark.parametrize("flash", [False, True])
def test_sinkhorn_sample_plan_matches_jax_on_both_routes(flash):
    """flash=False: pairs from the dense plan by JAX's uniforms; flash=True
    (on the CPU the potentials come from the dense twin): x0 in order and
    one partner per row by Gumbel-max with the noise JAX draws from its
    sampling key. The same pairs either way."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    n = 64
    x0, x1 = _plan_clouds(n, n, seed=22)
    key = jax.random.PRNGKey(23)
    js = OTPlanSampler("sinkhorn", reg=0.5, flash=flash)
    a_ref, b_ref, bad_ref = js.sample_plan(key, jnp.asarray(x0), jnp.asarray(x1),
                                           return_status=True)
    ts = tcp.OTPlanSampler("sinkhorn", reg=0.5, flash=flash)
    if flash:
        ks, ku = jax.random.split(key)
        draws = dict(gumbel=torch.from_numpy(np.array(jax.random.gumbel(
                         jax.random.split(ks, 1)[0], (n, n)))),
                     uniform_j=torch.from_numpy(np.array(jax.random.randint(ku, (n,), 0, n))))
    else:
        draws = dict(noise=torch.from_numpy(np.array(jax.random.uniform(key, (n,)))))
    a, b, bad = ts.sample_plan(None, torch.from_numpy(x0), torch.from_numpy(x1),
                               return_status=True, **draws)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))
    assert bool(bad) == bool(bad_ref) is False
    if flash:
        assert torch.equal(a, torch.from_numpy(x0))


def test_flash_route_falls_back_to_uniform_partners_like_jax():
    """A solve cut at 2 iterations at a small reg misses its row masses by
    far more than half: both packages flag it and pair each row with the
    fallback's uniform partner."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.coupling import OTPlanSampler

    n = 32
    x0, x1 = _plan_clouds(n, n, seed=24)
    key = jax.random.PRNGKey(25)
    _, b_ref, bad_ref = OTPlanSampler("sinkhorn", reg=0.01, num_iters=2, flash=True).sample_plan(
        key, jnp.asarray(x0), jnp.asarray(x1), return_status=True)
    ks, ku = jax.random.split(key)
    uj = np.array(jax.random.randint(ku, (n,), 0, n))
    _, b, bad = tcp.OTPlanSampler("sinkhorn", reg=0.01, num_iters=2, flash=True).sample_plan(
        None, torch.from_numpy(x0), torch.from_numpy(x1), return_status=True,
        gumbel=torch.zeros(n, n), uniform_j=torch.from_numpy(uj))
    assert bool(bad) and bool(bad_ref)
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_ref))
    np.testing.assert_array_equal(b.numpy(), x1[uj])


def test_flash_route_is_taken_only_where_jax_takes_it():
    """Auto-routing: never on the CPU (JAX's CPU run never does either); on
    the card for sinkhorn at 2048^2 entries and above within the point
    budget; never for another method, without replacement or with a
    normalised cost."""
    s = tcp.OTPlanSampler("sinkhorn")
    cpu = torch.zeros(2048, 2)
    assert not s._use_flash(cpu, cpu)
    assert tcp._flash_route(2048, 2048, 2, "cuda") and not tcp._flash_route(1024, 2048, 2, "cuda")
    assert not tcp._flash_route(2048, 2048, 3072, "cuda")  # 4 d (n + m) over 8 MiB
    assert tcp.OTPlanSampler("sinkhorn", flash=True)._use_flash(cpu, cpu)
    assert not tcp.OTPlanSampler("sinkhorn", flash=True)._use_flash(cpu, cpu, replace=False)
    assert not tcp.OTPlanSampler("exact", flash=True)._use_flash(cpu, cpu)
    assert not tcp.OTPlanSampler("sinkhorn", flash=True, normalize_cost=True)._use_flash(cpu, cpu)


def test_sbcfm_entropic_coupled_sampling_matches_jax_given_its_draws():
    """SB-CFM with the entropic coupling on the flash route (forced: on the
    CPU the potentials come from the dense twin): handed the Gumbel noise,
    the fallback partners, t and eps JAX draws from its key, the port gives
    JAX's t, xt, ut and eps (1e-6)."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.paths import SchrodingerBridgeConditionalFlowMatcher as JSB

    n, sigma = 64, 0.8
    x0, x1 = _plan_clouds(n, n, seed=26)
    jm, tm = JSB(sigma, ot_method="sinkhorn"), tpa.SchrodingerBridgeConditionalFlowMatcher(
        sigma, ot_method="sinkhorn")
    jm.ot_sampler.flash = tm.ot_sampler.flash = True
    key = jax.random.PRNGKey(27)
    ref = jm.sample_location_and_conditional_flow(key, jnp.asarray(x0), jnp.asarray(x1),
                                                  return_noise=True, return_coupling_status=True)
    plan_key, path_key = jax.random.split(key)
    ks, ku = jax.random.split(plan_key)
    t_key, eps_key = jax.random.split(path_key)
    arr = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    out = tm.sample_location_and_conditional_flow(
        None, torch.from_numpy(x0), torch.from_numpy(x1), return_noise=True,
        return_coupling_status=True, t=arr(jax.random.uniform(t_key, (n,))),
        eps=arr(jax.random.normal(eps_key, (n, 2))),
        gumbel=arr(jax.random.gumbel(jax.random.split(ks, 1)[0], (n, n))),
        uniform_j=arr(jax.random.randint(ku, (n,), 0, n)))
    assert tm.ot_sampler._use_flash(torch.from_numpy(x0), torch.from_numpy(x1))
    for got, want in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert bool(out[4]) == bool(ref[4]) is False


def test_icfm_path_matches_jax_given_t_and_eps():
    import jax.numpy as jnp

    from cfm_tpu.paths import ConditionalFlowMatcher

    rng = np.random.default_rng(7)
    x0, x1, eps = (rng.standard_normal((4, 3, 2)).astype(np.float32) for _ in range(3))
    t = rng.uniform(size=4).astype(np.float32)
    for sigma in (0.0, 0.3):
        jm, tm = ConditionalFlowMatcher(sigma), tpa.ConditionalFlowMatcher(sigma)
        xt_ref = jm.sample_xt(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t), jnp.asarray(eps))
        tt, xt, ut, e, bad = tm.sample_location_and_conditional_flow(
            None, torch.from_numpy(x0), torch.from_numpy(x1), t=torch.from_numpy(t),
            eps=torch.from_numpy(eps), return_noise=True, return_coupling_status=True)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xt_ref), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ut.numpy(), x1 - x0)
        assert torch.equal(e, torch.from_numpy(eps)) and not bool(bad)


def test_otcfm_couples_with_the_plan_uniforms_then_draws_the_path():
    """OT-CFM given the plan uniforms, t and eps equals coupling by hand
    (sample_plan with those uniforms) followed by the I-CFM path; without
    coupling it is the I-CFM path on the original pairs."""
    n = 8
    x0, x1 = (torch.from_numpy(a) for a in _clouds(n, seed=8))
    g = torch.Generator().manual_seed(1)
    u, t, eps = torch.rand(n, generator=g), torch.rand(n, generator=g), torch.randn(n, 6,
                                                                                 generator=g)
    m = tpa.ExactOptimalTransportConditionalFlowMatcher()
    tt, xt, ut, bad = m.sample_location_and_conditional_flow(
        None, x0, x1, t=t, eps=eps, plan_noise=u, return_coupling_status=True)
    a, b = m.ot_sampler.sample_plan(None, x0, x1, noise=u)
    assert torch.equal(ut, b - a) and torch.equal(xt, m.sample_xt(a, b, t, eps))
    assert bad.dtype == torch.bool and not bool(bad)
    plain = m.without_coupling()
    _, xt2, ut2 = plain.sample_location_and_conditional_flow(None, x0, x1, t=t, eps=eps)
    assert torch.equal(ut2, x1 - x0) and torch.equal(xt2, m.sample_xt(x0, x1, t, eps))
    assert not getattr(m, "_skip_coupling", False)


def test_matcher_draws_from_the_generator_in_order():
    """Plan uniforms, then t, then eps, all from one generator."""
    n = 8
    x0, x1 = (torch.from_numpy(a) for a in _clouds(n, seed=9))
    m = tpa.ExactOptimalTransportConditionalFlowMatcher()
    t, xt, ut = m.sample_location_and_conditional_flow(torch.Generator().manual_seed(3), x0, x1)
    g = torch.Generator().manual_seed(3)
    u, t2 = torch.rand(n, generator=g), torch.rand(n, generator=g)
    eps = torch.randn(n, 6, generator=g)
    _, xt2, ut2 = m.sample_location_and_conditional_flow(None, x0, x1, t=t2, eps=eps, plan_noise=u)
    assert torch.equal(t, t2) and torch.equal(xt, xt2) and torch.equal(ut, ut2)


def test_utils_match_jax():
    import jax.numpy as jnp

    from cfm_tpu import utils as jut

    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 2, 4)).astype(np.float32)
    t = rng.uniform(size=3).astype(np.float32)
    assert tut.pad_t_like_x(0.5, torch.from_numpy(x)) == 0.5
    assert tuple(tut.pad_t_like_x(torch.from_numpy(t), torch.from_numpy(x)).shape) == tuple(
        jut.pad_t_like_x(jnp.asarray(t), jnp.asarray(x)).shape)
    for a in (x, x[:, 0, 0], x[:, 0]):
        assert tuple(tut.flatten_batch(torch.from_numpy(a)).shape) == tuple(
            jut.flatten_batch(jnp.asarray(a)).shape)
    np.testing.assert_allclose(tut.mean_flat(torch.from_numpy(x)).numpy(),
                               np.asarray(jut.mean_flat(jnp.asarray(x))), rtol=1e-6)
    e, p = rng.standard_normal((2, 5)).astype(np.float32)
    ref = np.asarray(jut.ema_update(jnp.asarray(e), jnp.asarray(p), 0.9999))
    et = [torch.from_numpy(e.copy())]
    tut.ema_update(et, [torch.from_numpy(p)], 0.9999)
    np.testing.assert_allclose(et[0].numpy(), ref, rtol=1e-6, atol=1e-7)
