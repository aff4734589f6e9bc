"""The port's variant objectives (cfm_tpu_torch/variants.py) against JAX's
(cfm_tpu/variants.py) on shared numpy inputs, flax parameters carried
across by ``models/convert.py``, and the draws JAX makes from its key (the
bridge's t and eps, action matching's t, the Rademacher probes, the
Brownian normals, average_ut's indices) handed to the port. Values within
1e-5 and gradients within 1e-4, each relative to the tensor's max-abs (or
to 1e-3 of the largest leaf's, where that is more); the adaptive NLL's
gradients, through two continuous adjoints, within 5e-3 of each other."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu import schedules as js
from cfm_tpu import variants as jv
from cfm_tpu.models import mlp as jm
from cfm_tpu_torch import schedules as ts
from cfm_tpu_torch import variants as tv
from cfm_tpu_torch.models import mlp as tm
from cfm_tpu_torch.models.convert import variables_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from flax_variables import fast_jit, random_variables  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, rtol=1e-5, err_msg=""):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30),
                               err_msg=err_msg)


def _grads_close(modules, jax_grads, rtol=1e-4):
    """``modules``: {name: torch module}; ``jax_grads``: {name: flax params}."""
    want = {n: variables_from_flax({"params": g}) for n, g in jax_grads.items()}
    top = max(float(v.abs().max()) for w in want.values() for v in w.values())
    for n, module in modules.items():
        for k, p in module.named_parameters():
            got = torch.zeros_like(p) if p.grad is None else p.grad
            w = want[n][k].numpy()
            np.testing.assert_allclose(got.numpy(), w, rtol=rtol,
                                       atol=rtol * max(np.abs(w).max(), 1e-3 * top),
                                       err_msg=f"{n}.{k}")


def _mlp(seed, dim=2, w=16):
    jmod = jm.MLP(dim=dim, w=w)
    params = random_variables(jmod, jnp.zeros((2,)), jnp.zeros((2, dim)), seed=seed)
    tmod = tm.MLP(dim, w=w, device="cpu")
    tmod.load_state_dict(variables_from_flax(params))
    return jmod, params, tmod


def _pair(n=16, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((n, d)).astype(np.float32) - 1.0
    x1 = rng.standard_normal((n, d)).astype(np.float32) + 1.0
    return x0, x1


def _t(a):
    return torch.from_numpy(np.array(a))


def _bridge_draws(key, x0):
    """t and eps as ScheduleBridgeMatcher draws them: split(key), then
    uniform (bs,) and normal of x0's shape."""
    def draw(key):
        kt, ke = jax.random.split(key)
        return (jax.random.uniform(kt, (x0.shape[0],), dtype=jnp.float32),
                jax.random.normal(ke, x0.shape, jnp.float32))

    return tuple(np.array(a) for a in fast_jit(draw)(key))


SCHEDULES = [("constant", lambda m: m.ConstantNoiseScheduler(0.5)),
             ("linear", lambda m: m.LinearDecreasingNoiseScheduler(0.1, 1.0)),
             ("cosine", lambda m: m.CosineNoiseScheduler(0.8))]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_bridge_matcher_matches_jax(name, make):
    x0, x1 = _pair()
    key = jax.random.PRNGKey(1)
    ref = fast_jit(lambda a, b: jv.ScheduleBridgeMatcher(make(js)).sample_location_and_targets(
        key, a, b))(jnp.asarray(x0), jnp.asarray(x1))
    t, eps = _bridge_draws(key, x0)
    out = tv.ScheduleBridgeMatcher(make(ts)).sample_location_and_targets(
        None, _t(x0), _t(x1), t=_t(t), eps=_t(eps))
    assert sorted(out) == sorted(ref)
    for k in ref:
        _close(out[k], ref[k], err_msg=k)
    st = np.random.default_rng(2).standard_normal(x0.shape).astype(np.float32)
    _close(tv.sf2m_score_loss(_t(st), out), jv.sf2m_score_loss(jnp.asarray(st), ref))
    for a, b in zip(tv.dsbm_targets(_t(x0), _t(x1), out, make(ts)),
                    jv.dsbm_targets(jnp.asarray(x0), jnp.asarray(x1), ref, make(js))):
        _close(a, b)


def test_bridge_matcher_draws_from_its_generator():
    """t from the generator first, then eps; reproducible from the seed."""
    x0, x1 = _pair()
    m = tv.ScheduleBridgeMatcher()
    a = m.sample_location_and_targets(torch.Generator().manual_seed(3), _t(x0), _t(x1))
    g = torch.Generator().manual_seed(3)
    t = torch.rand((16,), generator=g)
    eps = torch.randn((16, 2), generator=g)
    assert torch.equal(a["t"], t) and torch.equal(a["eps"], eps)


@pytest.mark.parametrize("oneway", [False, True])
def test_dsbm_losses_and_gradients_match_jax(oneway):
    x0, x1 = _pair(seed=4)
    key = jax.random.PRNGKey(5)
    jf, pf, tf = _mlp(6)
    jb, pb, tb = _mlp(7)
    sched = (js.LinearDecreasingNoiseScheduler(0.1, 0.8), ts.LinearDecreasingNoiseScheduler(0.1, 0.8))
    t, eps = _bridge_draws(key, x0)
    if oneway:
        jloss = jv.make_oneway_dsbm_loss(jf.apply, sched[0])
        params = pf
        modules = {"forward": tf}
        out, aux = tv.make_oneway_dsbm_loss(tf, sched[1])(None, _t(x0), _t(x1), t=_t(t),
                                                          eps=_t(eps))
    else:
        jloss = jv.make_dsbm_loss(jf.apply, jb.apply, sched[0])
        params = {"forward": pf, "backward": pb}
        modules = {"forward": tf, "backward": tb}
        out, aux = tv.make_dsbm_loss(tf, tb, sched[1])(None, _t(x0), _t(x1), t=_t(t),
                                                       eps=_t(eps))
    (ref, raux), g = fast_jit(jax.value_and_grad(jloss, has_aux=True))(
        params, key, jnp.asarray(x0), jnp.asarray(x1))
    _close(out, ref)
    for k in raux:
        _close(aux[k], raux[k], err_msg=k)
    out.backward()
    grads = ({"forward": g["params"]} if oneway else
             {n: g[n]["params"] for n in ("forward", "backward")})
    _grads_close(modules, grads)


def test_dsbm_ode_drift_reflow_and_straightness_match_jax():
    jf, pf, tf = _mlp(8)
    jb, pb, tb = _mlp(9)
    x0, _ = _pair(seed=10)
    drift = jv.dsbm_ode_drift(jf.apply, jb.apply, {"forward": pf, "backward": pb})
    _close(tv.dsbm_ode_drift(tf, tb)(0.3, _t(x0)), drift(0.3, jnp.asarray(x0)))
    with torch.no_grad():
        a, b = tv.reflow_pairs(tf, _t(x0), n_steps=12)
        s = tv.straightness(tf, _t(x0), n_steps=10)
    ra, rb = fast_jit(lambda x: jv.reflow_pairs(jf.apply, pf, x, n_steps=12))(jnp.asarray(x0))
    _close(a, ra)
    _close(b, rb)
    rs = fast_jit(lambda x: jv.straightness(jf.apply, pf, None, x, n_steps=10))(jnp.asarray(x0))
    _close(s, rs)


def test_action_matching_loss_and_gradients_match_jax():
    x0, x1 = _pair(seed=11)
    net = jm._ActionNet(w=16)
    params = random_variables(net, jnp.zeros((2,)), jnp.zeros((2, 2)), seed=12)
    tnet = tm._ActionNet(2, 16, device="cpu")
    tnet.load_state_dict(variables_from_flax(params))
    key = jax.random.PRNGKey(13)
    (ref, _), g = fast_jit(jax.value_and_grad(jv.make_action_matching_loss(net.apply),
                                             has_aux=True))(params, key, jnp.asarray(x0),
                                                            jnp.asarray(x1))
    t = np.asarray(jax.random.uniform(key, (16,), dtype=jnp.float32))
    out, _ = tv.make_action_matching_loss(tnet)(None, _t(x0), _t(x1), t=_t(t))
    _close(out, ref)
    out.backward()
    _grads_close({"a": tnet}, {"a": g["params"]})


@pytest.mark.parametrize("divergence", ["exact", "hutch"])
def test_cnf_nll_loss_and_gradients_match_jax(divergence):
    """The fixed-step route (euler, 6 steps): loss, nll per dim and the
    parameter gradients, with JAX's probes for hutch."""
    jmod, params, tmod = _mlp(14)
    _, x1 = _pair(seed=15)
    key = jax.random.PRNGKey(16)
    jloss = jv.make_cnf_nll_loss(jmod.apply, n_steps=6, divergence=divergence, num_probes=2)
    (ref, raux), g = fast_jit(jax.value_and_grad(jloss, has_aux=True))(
        params, key, None, jnp.asarray(x1))
    keys = jax.random.split(key, 16)
    probes = torch.from_numpy(np.asarray(jax.vmap(
        lambda k: jax.random.rademacher(k, (2, 2), dtype=jnp.float32))(keys)))
    out, aux = tv.make_cnf_nll_loss(tmod, n_steps=6, divergence=divergence, num_probes=2)(
        None, None, _t(x1), probes=probes if divergence == "hutch" else None)
    _close(out, ref)
    _close(aux["nll_per_dim"], raux["nll_per_dim"])
    out.backward()
    _grads_close({"m": tmod}, {"m": g["params"]})


def test_adaptive_cnf_nll_gradients_match_jax_adjoint():
    """``adaptive=True``: dopri5 on (x, logp) through each package's
    continuous adjoint at rtol = atol = 1e-6; the losses within 1e-5, the
    gradients within 5e-3 of each other (of each tensor's max-abs, the
    bound of the adjoint test of ``tests/test_torch_integrate.py``). The
    field is a tanh ``VelocityNet``: a SELU net's divergence jumps where a
    pre-activation crosses 0, and dopri5 then rejects step after step in
    both packages, each on its own path."""
    jmod = jm.VelocityNet(dim=2, hidden_dims=(8, 8), activation="tanh")
    params = random_variables(jmod, jnp.zeros((2,)), jnp.zeros((2, 2)), seed=17)
    tmod = tm.VelocityNet(2, (8, 8), "tanh", device="cpu")
    tmod.load_state_dict(variables_from_flax(params))
    _, x1 = _pair(n=6, seed=18)
    key = jax.random.PRNGKey(19)
    jloss = jv.make_cnf_nll_loss(jmod.apply, adaptive=True, rtol=1e-6, atol=1e-6)
    (ref, _), g = fast_jit(jax.value_and_grad(jloss, has_aux=True))(params, key, None,
                                                                    jnp.asarray(x1))
    out, _ = tv.make_cnf_nll_loss(tmod, adaptive=True, rtol=1e-6, atol=1e-6)(None, None, _t(x1))
    _close(out, ref)
    out.backward()
    want = variables_from_flax(g)
    for k, p in tmod.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=5e-3 * np.abs(w).max(),
                                   err_msg=k)


def test_icnn_losses_and_gradients_match_jax():
    """g_loss in g's parameters, f_loss in f's (the map detached), the W2
    estimate and grad_g."""
    rng = np.random.default_rng(20)
    x = rng.standard_normal((12, 2)).astype(np.float32)
    y = (rng.standard_normal((12, 2)) + 1.5).astype(np.float32)
    jf, jg = jm.ICNN(dim=2, hidden_dims=(16, 16)), jm.ICNN(dim=2, hidden_dims=(16, 16))
    pf = random_variables(jf, jnp.zeros((2, 2)), seed=21)
    pg = random_variables(jg, jnp.zeros((2, 2)), seed=22)
    tf_, tg = tm.ICNN(2, (16, 16), device="cpu"), tm.ICNN(2, (16, 16), device="cpu")
    tf_.load_state_dict(variables_from_flax(pf))
    tg.load_state_dict(variables_from_flax(pg))
    jgl, jfl, jgrad, jw2 = jv.make_icnn_losses(jf, jg)
    g_loss, f_loss, grad_g, w2 = tv.make_icnn_losses(tf_, tg)
    X, Y = jnp.asarray(x), jnp.asarray(y)
    (rg, _), gg = fast_jit(jax.value_and_grad(jgl, has_aux=True))(pg, pf, X)
    (rf, _), gf = fast_jit(jax.value_and_grad(jfl, has_aux=True))(pf, pg, X, Y)
    out, _ = g_loss(_t(x))
    _close(out, rg)
    out.backward()
    _grads_close({"g": tg}, {"g": gg["params"]})
    tg.zero_grad()
    tf_.zero_grad()
    out, _ = f_loss(_t(x), _t(y))
    _close(out, rf)
    out.backward()
    _grads_close({"f": tf_}, {"f": gf["params"]})
    assert all(p.grad is None or not p.grad.any() for p in tg.parameters())
    with torch.no_grad():
        _close(grad_g(_t(x)), fast_jit(jgrad)(pg, X))
        _close(w2(_t(x), _t(y)), fast_jit(jw2)(pf, pg, X, Y))


@pytest.mark.parametrize("reverse", [False, True])
def test_ipf_resample_pairs_matches_jax_given_its_normals(reverse):
    """Euler-Maruyama over 10 steps of the cosine schedule; the reverse run
    integrates the time-flipped drift on the increasing grid. The port is
    handed JAX's Brownian normals (split(key, n_steps), one normal each)."""
    jmod, params, tmod = _mlp(23)
    x0, x1 = _pair(seed=24)
    start = x1 if reverse else x0
    key = jax.random.PRNGKey(25)
    sched = (js.CosineNoiseScheduler(0.5), ts.CosineNoiseScheduler(0.5))
    ra, rb = fast_jit(lambda x: jv.ipf_resample_pairs(key, jmod.apply, params, x, sched[0],
                                                     n_steps=10, reverse=reverse))(
        jnp.asarray(start))
    noise = [torch.from_numpy(np.asarray(jax.random.normal(k, start.shape, jnp.float32)))
             for k in jax.random.split(key, 10)]
    a, b = tv.ipf_resample_pairs(None, tmod, _t(start), sched[1], n_steps=10, reverse=reverse,
                                 noise=noise)
    _close(a, ra)
    _close(b, rb)
    assert torch.equal(b if reverse else a, _t(start))


def test_average_ut_matches_jax_given_its_indices():
    rng = np.random.default_rng(26)
    x, mu, ut = rng.standard_normal((3, 10, 2, 2)).astype(np.float32)
    key = jax.random.PRNGKey(27)
    ref = fast_jit(lambda a, b, c: jv.average_ut(key, a, b, 0.7, c, 4))(
        jnp.asarray(x), jnp.asarray(mu), jnp.asarray(ut))
    idx = torch.from_numpy(np.asarray(jax.random.randint(key, (10, 3), 0, 10)))
    _close(tv.average_ut(None, _t(x), _t(mu), 0.7, _t(ut), 4, idx=idx), ref)
    drawn = tv.average_ut(torch.Generator().manual_seed(0), _t(x), _t(mu), 0.7, _t(ut), 4)
    assert drawn.shape == ut.shape and torch.isfinite(drawn).all()
