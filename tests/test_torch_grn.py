"""The port's GRN models (cfm_tpu_torch/models/grn.py) against flax's
(cfm_tpu/models/grn.py), the flax parameters carried across by
``models/convert.mlpodef_params_from_flax``: outputs, structure readouts,
regularisers and gradients within 1e-5 relative (of each tensor's
max-abs), given JAX's draws where the models sample. ``svgd_update`` equals
JAX's on one leaf; on a multi-leaf particle set it equals a per-particle
float64 formula and not JAX's, which mixes particles when it flattens the
set as a whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.models import grn as jgrn
from cfm_tpu_torch.models import grn as tgrn
from cfm_tpu_torch.models.convert import mlpodef_params_from_flax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=RTOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _x(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _port(module, params):
    module.load_state_dict(mlpodef_params_from_flax(params["params"]), strict=True)
    return module


def _grads_match(module, loss_t, ref_grads):
    """Gradients of loss_t(module) agree leaf by leaf with JAX's gradient
    tree ``ref_grads``."""
    for p in module.parameters():
        p.grad = None
    loss_t(module).backward()
    ref = mlpodef_params_from_flax(ref_grads["params"])
    for name, p in module.named_parameters():
        _close(p.grad, ref[name].numpy())


@pytest.mark.parametrize("dims,time_invariant", [([5, 4, 1], True), ([5, 3, 6, 1], False)])
def test_mlpodef_matches_flax(dims, time_invariant):
    d = dims[0]
    x, t = _x(16, d), np.linspace(0, 1, 16, dtype=np.float32)
    grn = (np.random.default_rng(1).uniform(size=(d, d)) < 0.5).astype(np.float32)
    jm = jgrn.MLPODEF(dims=dims, time_invariant=time_invariant)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(x))

    def loss_j(p):
        v = jm.apply(p, jnp.asarray(t), jnp.asarray(x))
        return (jnp.mean(v ** 2) + jm.group_lasso_reg(p) + 1e-3 * jm.l2_reg(p)
                + 1e-3 * jm.grn_reg(p, jnp.asarray(grn)))

    @jax.jit
    def ref_all(p):  # one compilation of JAX's side
        return dict(v=jm.apply(p, jnp.asarray(t), jnp.asarray(x)), s=jm.get_structure(p),
                    l1_reg=jm.l1_reg(p), l2_reg=jm.l2_reg(p),
                    group_lasso_reg=jm.group_lasso_reg(p), grn=jm.grn_reg(p, jnp.asarray(grn)),
                    grads=jax.grad(loss_j)(p))

    ref = ref_all(params)
    tm = _port(tgrn.MLPODEF(dims, time_invariant=time_invariant), params)
    _close(tm(_t(t), _t(x)), ref["v"])
    _close(tm.get_structure(), ref["s"])
    for name in ("l1_reg", "l2_reg", "group_lasso_reg"):
        _close(getattr(tm, name)(), ref[name])
    _close(tm.grn_reg(_t(grn)), ref["grn"])

    def loss_t(m):
        v = m(_t(t), _t(x))
        return (torch.mean(v ** 2) + m.group_lasso_reg() + 1e-3 * m.l2_reg()
                + 1e-3 * m.grn_reg(_t(grn)))

    _grads_match(tm, loss_t, ref["grads"])


def test_structure_is_not_transposed():
    """Only input gene 2 drives output gene 0: get_structure[2, 0] is the one
    edge, as in flax, not [0, 2]."""
    d, k = 3, 4
    m = tgrn.MLPODEF([d, k, 1])
    with torch.no_grad():
        m.fc1.weight.zero_()
        m.fc1.weight[0 * k:1 * k, 2] = 1.0  # output gene 0's hidden units read input gene 2
    s = m.get_structure().detach()
    assert float(s[2, 0]) == 2.0 and float(s.sum()) == 2.0


def test_init_statistics_match_flax():
    """lecun-normal draws with flax's fan-in (the locally-connected weight's
    leading axis counts, as in flax's variance scaling)."""
    d, k = 40, 30
    m = tgrn.MLPODEF([d, k, 20, 1], seed=3)
    jm = jgrn.MLPODEF(dims=[d, k, 20, 1])
    p = jax.jit(jm.init)(jax.random.PRNGKey(3), 0.0, jnp.zeros((2, d)))["params"]
    for ours, theirs in ((m.fc1.weight, p["fc1"]["kernel"]),
                         (m.fc2_0.weight, p["fc2_0"]["weight"])):
        assert float(ours.detach().std()) == pytest.approx(float(jnp.std(theirs)), rel=0.05)
    assert float(m.fc1.bias.detach().abs().max()) == 0.0


def test_ensemble_matches_flax():
    d = 4
    x = _x(8, d)
    jinit, japply = jgrn.make_ensemble(jgrn.MLPODEF(dims=[d, 3, 1]), 5)
    stacked = jax.jit(jinit)(jax.random.PRNGKey(2), jnp.zeros(()), jnp.asarray(x))
    ref = jax.jit(japply)(stacked, 0.0, jnp.asarray(x))
    init_fn, apply_fn = tgrn.make_ensemble(tgrn.MLPODEF([d, 3, 1]), 5)
    ours = mlpodef_params_from_flax(stacked["params"])
    assert set(ours) == set(dict(tgrn.MLPODEF([d, 3, 1]).named_parameters()))
    out = apply_fn(ours, 0.0, _t(x))
    assert out.shape == (5, 8, d)
    _close(out, ref)
    drawn = init_fn(torch.Generator().manual_seed(0))
    outs = apply_fn(drawn, 0.0, _t(x))
    assert not torch.allclose(outs[0], outs[1])  # the members differ
    scores = tgrn.MLPODEF([d, 3, 1]).get_structure(drawn)
    assert scores.shape == (5, d, d)


def test_deepset_and_hyper_mlpodef_match_flax():
    rng = np.random.default_rng(4)
    sets = rng.standard_normal((6, 5, 3)).astype(np.float32)
    jds = jgrn.DeepSet(phi_dims=(8, 8), rho_dims=(8,), out_dim=4)
    params = jax.jit(jds.init)(jax.random.PRNGKey(1), jnp.asarray(sets))
    tds = _port(tgrn.DeepSet(3, phi_dims=(8, 8), rho_dims=(8,), out_dim=4), params)
    _close(tds(_t(sets)), jax.jit(jds.apply)(params, jnp.asarray(sets)))

    d, x, ctx = 4, _x(6, 4), rng.standard_normal((6, 5)).astype(np.float32)
    jh = jgrn.HyperMLPODEF(dims=[d, 3, 1], context_dim=5)
    params = jax.jit(jh.init)(jax.random.PRNGKey(2), 0.0, jnp.asarray(x), jnp.asarray(ctx))

    @jax.jit
    def ref_all(p):
        def fwd(q):
            return jh.apply(q, 0.0, jnp.asarray(x), jnp.asarray(ctx))

        return fwd(p), jax.grad(lambda q: jnp.mean(fwd(q) ** 2))(p)

    v, grads = ref_all(params)
    th = _port(tgrn.HyperMLPODEF([d, 3, 1], context_dim=5), params)
    _close(th(0.0, _t(x), _t(ctx)), v)
    _grads_match(th, lambda m: torch.mean(m(0.0, _t(x), _t(ctx)) ** 2), grads)


def test_bayes_mlpodef_matches_flax_given_its_uniforms():
    d, x = 4, _x(10, 4)
    jm = jgrn.BayesMLPODEF(dims=[d, 3, 2, 1])
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), 0.0, jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)  # non-zero logits and biases
    key = jax.random.PRNGKey(4)

    @jax.jit
    def ref_all(p):
        def sampled(q):
            return jm.apply(q, 0.0, jnp.asarray(x), key)

        return dict(mean=jm.apply(p, 0.0, jnp.asarray(x)), sampled=sampled(p),
                    probs=jm.edge_probs(p), grads=jax.grad(lambda q: jnp.mean(sampled(q) ** 2))(p),
                    u=jax.random.uniform(key, (d, d), minval=1e-6, maxval=1 - 1e-6))

    ref = ref_all(params)
    tm = _port(tgrn.BayesMLPODEF([d, 3, 2, 1]), params)
    u = _t(ref["u"])
    _close(tm(0.0, _t(x)), ref["mean"])
    _close(tm(0.0, _t(x), u=u), ref["sampled"])
    _close(tm.edge_probs(), ref["probs"])
    _grads_match(tm, lambda m: torch.mean(m(0.0, _t(x), u=u) ** 2), ref["grads"])
    assert tm(0.0, _t(x), generator=torch.Generator().manual_seed(0)).shape == (10, d)


def test_dibs_mlpodef_matches_flax_given_its_normals():
    d, x = 5, _x(12, 5)
    jm = jgrn.DibsMLPODEF(dims=[d, 3, 1], rank=4)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5), 0.0, jnp.asarray(x))
    key, k_s = jax.random.PRNGKey(6), jax.random.PRNGKey(7)

    def loss_j(p):
        return jnp.mean(jm.apply(p, 0.0, jnp.asarray(x), key) ** 2) + 1e-3 * jm.kl_to_prior(p) \
            + jm.h_acyclic(p, 2.0)

    @jax.jit
    def ref_all(p):
        kw, kv = jax.random.split(key)
        return dict(mean=jm.apply(p, 0.0, jnp.asarray(x)),
                    sampled=jm.apply(p, 0.0, jnp.asarray(x), key),
                    nw=jax.random.normal(kw, (4, d)), nv=jax.random.normal(kv, (4, d * 3)),
                    z=jm.latent_z(p), probs=jm.edge_probs(p, iter_num=10.0),
                    h=jm.h_acyclic(p, iter_num=3.0), kl=jm.kl_to_prior(p, prior_log_sigma=0.5),
                    u=jax.random.uniform(k_s, (6, d, d)),
                    graphs=jm.sample_structures(p, k_s, 6, iter_num=10.0),
                    grads=jax.grad(loss_j)(p))

    ref = ref_all(params)
    tm = _port(tgrn.DibsMLPODEF([d, 3, 1], rank=4), params)
    noise = (_t(ref["nw"]), _t(ref["nv"]))
    _close(tm(0.0, _t(x)), ref["mean"])
    _close(tm(0.0, _t(x), noise=noise), ref["sampled"])
    _close(tm.latent_z(), ref["z"])
    _close(tm.edge_probs(iter_num=10.0), ref["probs"])
    _close(tm.h_acyclic(iter_num=3.0), ref["h"])
    _close(tm.kl_to_prior(prior_log_sigma=0.5), ref["kl"])
    np.testing.assert_array_equal(
        tm.sample_structures(None, 6, iter_num=10.0, u=_t(ref["u"])).numpy(),
        np.asarray(ref["graphs"]))
    _grads_match(tm, lambda m: torch.mean(m(0.0, _t(x), noise=noise) ** 2)
                 + 1e-3 * m.kl_to_prior() + m.h_acyclic(iter_num=2.0), ref["grads"])


def test_svgd_update_equals_jax_on_one_leaf():
    """Eight particles: the median of 64 squared distances, an even count."""
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 3)) * 3.0)
    G = -X * 0.7
    ref = jax.jit(jgrn.svgd_update)({"x": jnp.asarray(X)}, {"x": jnp.asarray(G)})
    out = tgrn.svgd_update({"x": _t(X)}, {"x": _t(G)})
    _close(out["x"], ref["x"])
    ref = jax.jit(lambda a, b: jgrn.svgd_update(a, b, bandwidth=1.5))(
        {"x": jnp.asarray(X)}, {"x": jnp.asarray(G)})
    _close(tgrn.svgd_update({"x": _t(X)}, {"x": _t(G)}, bandwidth=1.5)["x"], ref["x"])


def _svgd_f64(particles, grads):
    """SVGD's direction with each particle's own vector, in float64."""
    names = list(particles)
    P = particles[names[0]].shape[0]
    X = np.concatenate([np.asarray(particles[k], np.float64).reshape(P, -1) for k in names], 1)
    G = np.concatenate([np.asarray(grads[k], np.float64).reshape(P, -1) for k in names], 1)
    sq = ((X[:, None] - X[None]) ** 2).sum(-1)
    h = np.sqrt(0.5 * np.median(sq) / np.log(P + 1.0) + 1e-12)
    K = np.exp(-sq / (2 * h ** 2 + 1e-12))
    phi = (K @ G + (K.sum(1, keepdims=True) * X - K @ X) / (h ** 2 + 1e-12)) / P
    out, col = {}, 0
    for k in names:
        w = int(np.prod(particles[k].shape[1:]))
        out[k] = phi[:, col:col + w].reshape(particles[k].shape)
        col += w
    return out


def test_svgd_update_is_per_particle_on_a_dibs_ensemble():
    """Six DiBS particles (seven leaves each) from a flax ensemble init, and
    their gradients of a data-fit loss: the port equals the per-particle
    formula; JAX, which flattens the whole set before splitting it into
    particles, does not."""
    d, P = 4, 6
    x = _x(16, d)
    jinit, japply = jgrn.make_ensemble(jgrn.DibsMLPODEF(dims=[d, 3, 1], rank=3), P)
    stacked = jax.jit(jinit)(jax.random.PRNGKey(8), 0.0, jnp.asarray(x))

    @jax.jit
    def ref_all(p):
        grads = jax.grad(lambda q: jnp.mean(japply(q, 0.0, jnp.asarray(x)) ** 2))(p)
        return grads, jgrn.svgd_update(p, grads)

    grads, ref = ref_all(stacked)
    particles = mlpodef_params_from_flax(stacked["params"])
    g = mlpodef_params_from_flax(grads["params"])
    assert len(particles) == 7
    out = tgrn.svgd_update(particles, g)
    want = _svgd_f64(particles, g)
    ref = mlpodef_params_from_flax(ref["params"])
    scale = max(np.abs(w).max() for w in want.values())  # the isp leaves' phi is 0
    for k in particles:
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=RTOL, atol=RTOL * scale)
    assert not all(np.allclose(ref[k].numpy(), want[k], rtol=1e-3, atol=1e-6) for k in particles)
    # The port's gradients on the same particles give the same direction.
    init_fn, apply_fn = tgrn.make_ensemble(tgrn.DibsMLPODEF([d, 3, 1], rank=3), P)
    leaves = {k: v.clone().requires_grad_(True) for k, v in particles.items()}
    torch.mean(apply_fn(leaves, 0.0, _t(x)) ** 2).backward()
    for k in particles:  # the std leaves, unused without noise, have no gradient
        got = leaves[k].grad if leaves[k].grad is not None else torch.zeros_like(leaves[k])
        _close(got, g[k].numpy())


def test_mlpodef_recovers_the_structure_of_a_linear_system():
    """x' = x A^T with a sparse A, the JAX package's recovery setting
    (d = 4, k = 8, gl_reg 1e-3, 512 points, Adam 5e-3, 500 steps): true edges
    rank above absent ones."""
    from cfm_tpu_torch.train import make_optimizer

    A = torch.tensor([[0.0, 1.5, 0.0, 0.0], [0.0, 0.0, -1.5, 0.0], [0.0, 0.0, 0.0, 1.5],
                      [1.5, 0.0, 0.0, 0.0]])
    model = tgrn.MLPODEF([4, 8, 1], gl_reg=1e-3, seed=1)
    x0 = torch.randn((512, 4), generator=torch.Generator().manual_seed(1))
    v_true = x0 @ A.T
    opt = make_optimizer(lr=5e-3, warmup_steps=0, grad_clip=0.0)
    params = list(model.parameters())
    state = opt.init(params)
    for _ in range(500):
        for p in params:
            p.grad = None
        loss = torch.mean(torch.square(model(0.0, x0) - v_true)) + model.group_lasso_reg()
        loss.backward()
        opt.apply(params, [p.grad for p in params], state)
    scores = model.get_structure().detach().T  # [out, in], as A
    true = A.abs() > 0
    assert float(scores[true].min()) > float(scores[~true].max()), scores
