"""The port's augmented integration (cfm_tpu_torch/augment.py) and the
pytree-aware ``odeint`` it needs (cfm_tpu_torch/integrate.py) against JAX's
(cfm_tpu/augment.py, cfm_tpu/integrate.py) on shared numpy inputs and, for
the Hutchinson estimators, the Rademacher probes JAX draws from its key
(split per sample). States and traces within 1e-5, gradients within 1e-4,
each relative to the tensor's max-abs; the adaptive solvers' NFE equal."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu import augment as ja
from cfm_tpu.integrate import odeint as jodeint
from cfm_tpu.models import diffeq as jd
from cfm_tpu.models.mlp import MLP as JMLP
from cfm_tpu_torch import augment as ta
from cfm_tpu_torch.integrate import odeint
from cfm_tpu_torch.models import MLP
from cfm_tpu_torch.models import diffeq as td
from cfm_tpu_torch.models.convert import mlp_params_from_flax, variables_from_flax
from cfm_tpu_torch.ops import groupnorm as tgn

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


def _state_close(out, ref, rtol=1e-5):
    _close(out.x, ref.x, rtol)
    _close(out.logp, ref.logp, rtol)
    assert sorted(out.regs) == sorted(ref.regs)
    for k in ref.regs:
        _close(out.regs[k], ref.regs[k], rtol, err_msg=k)


# --------------------------------------------------------------------------
# odeint over tuple, NamedTuple and dict states
# --------------------------------------------------------------------------


def _aug_fields():
    """The same field over (x, logp, regs) in both packages: a nonlinear
    drift, a logp rate that depends on x, two regulariser channels."""

    def jf(t, s):
        dx = jnp.sin(3.0 * s.x) - 0.5 * s.x + t
        return ja.AugmentedState(x=dx, logp=-jnp.sum(jnp.cos(s.x), axis=1),
                                 regs={"b": jnp.sum(dx * dx, axis=1), "a": s.regs["a"] * 0.1 + t})

    def tf(t, s):
        dx = torch.sin(3.0 * s.x) - 0.5 * s.x + t
        return ta.AugmentedState(x=dx, logp=-torch.sum(torch.cos(s.x), dim=1),
                                 regs={"b": torch.sum(dx * dx, dim=1), "a": s.regs["a"] * 0.1 + t})

    return jf, tf


def _aug_init(bs=6, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, d)).astype(np.float32)
    logp, a, b = (rng.standard_normal(bs).astype(np.float32) for _ in range(3))
    j = ja.AugmentedState(jnp.asarray(x), jnp.asarray(logp), {"a": jnp.asarray(a),
                                                                "b": jnp.asarray(b)})
    t = ta.AugmentedState(torch.from_numpy(x), torch.from_numpy(logp),
                          {"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    return j, t


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "euler", "midpoint", "heun", "rk4"])
def test_odeint_integrates_augmented_state_like_jax(method):
    """An (x, logp, regs) state along a 5-point grid: every leaf's trajectory
    within 1e-5 of JAX's, the same NFE (dopri5's and tsit5's error norm is
    one RMS over all leaves together: a per-leaf norm takes other steps)."""
    jf, tf = _aug_fields()
    j0, t0 = _aug_init()
    ts = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    ref = fast_jit(lambda s: jodeint(jf, s, jnp.asarray(ts), method=method))(j0)
    out = odeint(tf, t0, ts, method=method)
    assert out.nfe == int(ref.nfe)
    assert isinstance(out.ys, ta.AugmentedState) and out.ys.x.shape == (5, 6, 3)
    _state_close(out.ys, ref.ys)
    _state_close(out.final, jax.tree.map(lambda y: y[-1], ref.ys))


def test_odeint_adaptive_norm_spans_all_leaves():
    """The dopri5 NFE with a state whose second leaf is stiff differs from
    the NFE on x alone: the error norm reads every leaf."""
    def tf(t, s):
        return (torch.sin(s[0]), -50.0 * s[1])

    both = odeint(tf, (torch.ones(4, 2), torch.ones(4)), [0.0, 1.0], method="dopri5")
    alone = odeint(lambda t, x: torch.sin(x), torch.ones(4, 2), [0.0, 1.0], method="dopri5")
    assert both.nfe > alone.nfe
    _close(both.final[0], alone.final.numpy(), 1e-4)


@pytest.mark.parametrize("method", ["dopri5", "rk4"])
def test_odeint_tuple_and_dict_states_match_jax(method):
    """A plain tuple and a dict state, trajectory off, against JAX, at
    rtol = atol = 1e-6 (at 1e-5 one of this field's trial steps has an error
    ratio within rounding of 1, and a tensor state of the same numbers
    already takes other steps in the port than in JAX)."""
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((2, 4, 2)).astype(np.float32)
    jf = lambda t, s: {"u": -s["v"], "v": s["u"] * (1.0 + t)}
    tf = lambda t, s: {"u": -s["v"], "v": s["u"] * (1.0 + t)}
    tol = dict(rtol=1e-6, atol=1e-6)
    ref = fast_jit(lambda s0: jodeint(jf, s0, jnp.array([0.0, 2.0]), method=method,
                                     return_trajectory=False, **tol))(
        {"u": jnp.asarray(x), "v": jnp.asarray(y)})
    out = odeint(tf, {"u": torch.from_numpy(x), "v": torch.from_numpy(y)}, [0.0, 2.0],
                 method=method, return_trajectory=False, **tol)
    assert out.nfe == int(ref.nfe) and out.ys["u"].shape == (2, 4, 2)
    for k in ("u", "v"):
        _close(out.ys[k], ref.ys[k])
    jt = lambda t, s: (-s[1], s[0])
    ref = fast_jit(lambda s0: jodeint(jt, s0, jnp.array([0.0, 2.0]), method=method, **tol))(
        (jnp.asarray(x), jnp.asarray(y)))
    out = odeint(jt, (torch.from_numpy(x), torch.from_numpy(y)), [0.0, 2.0], method=method,
                 **tol)
    assert out.nfe == int(ref.nfe) and isinstance(out.final, tuple)
    _close(out.final[0], ref.final[0])
    _close(out.final[1], ref.final[1])


# --------------------------------------------------------------------------
# Traces, regularisers and the log-likelihood on a flax MLP
# --------------------------------------------------------------------------


def _mlp(dim=2, seed=0, w=16):
    jm = JMLP(dim=dim, w=w)
    params = random_variables(jm, jnp.zeros((2,)), jnp.zeros((2, dim)), seed=seed)
    tm = MLP(dim, w=w, device="cpu")
    tm.load_state_dict(mlp_params_from_flax(params["params"]))

    def jf(t, x):
        return jm.apply(params, jnp.full((x.shape[0],), t, x.dtype), x)

    def tf(t, x):
        return tm(torch.full((x.shape[0],), float(t)), x)

    return jm, params, tm, jf, tf


def _jax_probes(key, bs, k, d):
    """JAX's draws: one key a sample, (k, d) Rademacher probes from each."""
    eps = fast_jit(lambda key: jax.vmap(lambda kk: jax.random.rademacher(
        kk, (k, d), dtype=jnp.float32))(jax.random.split(key, bs)))(key)
    return torch.from_numpy(np.array(eps))


def _x(bs=8, d=2, seed=2):
    return np.random.default_rng(seed).standard_normal((bs, d)).astype(np.float32)


def test_regularizers_match_jax():
    rng = np.random.default_rng(3)
    x, dx = rng.standard_normal((2, 5, 3, 2)).astype(np.float32)
    for name in ta.REGULARIZERS:
        _close(ta.REGULARIZERS[name](0.1, torch.from_numpy(x), torch.from_numpy(dx)),
               ja.REGULARIZERS[name](0.1, jnp.asarray(x), jnp.asarray(dx)), err_msg=name)


@pytest.mark.parametrize("method,k", [("exact", 1), ("hutch", 1), ("hutch", 3)])
def test_batched_divergence_matches_jax(method, k):
    _, _, _, jf, tf = _mlp()
    x = _x()
    key = jax.random.PRNGKey(4)
    ref = fast_jit(lambda xx: ja.batched_divergence(jf, 0.3, xx, method=method, key=key,
                                                   num_probes=k))(jnp.asarray(x))
    probes = _jax_probes(key, 8, k, 2) if method == "hutch" else None
    out = ta.batched_divergence(tf, 0.3, torch.from_numpy(x), method=method, num_probes=k,
                                probes=probes)
    _close(out, ref)


def test_traces_of_one_sample_match_jax():
    """``exact_trace`` and ``hutch_trace`` on a per-sample field (d,) -> (d,)."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((4, 4)).astype(np.float32)
    x = rng.standard_normal(4).astype(np.float32)
    jfx = lambda v: jnp.tanh(jnp.asarray(A) @ v) * v
    tfx = lambda v: torch.tanh(torch.from_numpy(A) @ v) * v
    _close(ta.exact_trace(tfx, torch.from_numpy(x)), ja.exact_trace(jfx, jnp.asarray(x)))
    key = jax.random.PRNGKey(6)
    probes = torch.from_numpy(np.asarray(jax.random.rademacher(key, (5, 4), dtype=jnp.float32)))
    _close(ta.hutch_trace(tfx, torch.from_numpy(x), probes),
           ja.hutch_trace(jfx, jnp.asarray(x), key, k=5))


def test_divergence_keeps_the_per_sample_meaning():
    """A field that couples the batch (each sample scaled by the batch mean):
    JAX's per-sample vmap sees a batch of one, and so must the port; the
    batch Jacobian's trace differs."""
    x = _x(bs=6, d=3, seed=7)

    def jf(t, v):
        return v * jnp.mean(v, axis=0, keepdims=True)

    def tf(t, v):
        return v * torch.mean(v, dim=0, keepdim=True)

    ref = ja.batched_divergence(jf, 0.0, jnp.asarray(x))
    _close(ta.batched_divergence(tf, 0.0, torch.from_numpy(x)), ref)
    xx = torch.from_numpy(x).requires_grad_(True)
    out = tf(0.0, xx)
    batch_trace = sum(torch.autograd.grad(out[:, j].sum(), xx, retain_graph=True)[0][:, j]
                      for j in range(3))
    assert (batch_trace - torch.from_numpy(np.asarray(ref))).abs().max() > 1e-2


@pytest.mark.parametrize("method", ["exact", "hutch"])
def test_jacobian_regs_match_jax(method):
    _, _, _, jf, tf = _mlp(seed=1)
    x = _x(seed=8)
    key = jax.random.PRNGKey(9)
    names = ja.JACOBIAN_REGULARIZERS if method == "exact" else ("jac_frobenius",)
    ref = fast_jit(lambda xx: ja.batched_jacobian_regs(jf, 0.6, xx, names, method=method, key=key,
                                                      num_probes=2))(jnp.asarray(x))
    probes = _jax_probes(key, 8, 2, 2) if method == "hutch" else None
    out = ta.batched_jacobian_regs(tf, 0.6, torch.from_numpy(x), names, method=method,
                                   num_probes=2, probes=probes)
    for k in names:
        _close(out[k], ref[k], err_msg=k)
    with pytest.raises(ValueError):
        ta.batched_jacobian_regs(tf, 0.6, torch.from_numpy(x), ("jac_diag_frobenius",),
                                 method="hutch", probes=probes)


@pytest.mark.parametrize("method,divergence", [("euler", "exact"), ("midpoint", "exact"),
                                               ("rk4", "hutch")])
def test_augmented_odeint_matches_jax(method, divergence):
    """The three dx regularisers, the Jacobian ones (exact, or the
    Hutchinson Frobenius on the divergence's probes) and the divergence,
    integrated together; with JAX's key the probes are the same at every
    evaluation along the path in both. (dopri5 on this state takes some 100
    trial steps with many rejections in both packages, and the traces'
    roundings move accept decisions: its NFE is held on the field of
    ``test_odeint_integrates_augmented_state_like_jax``.)"""
    _, _, _, jf, tf = _mlp(seed=2)
    x = _x(seed=10)
    key = jax.random.PRNGKey(11)
    jac = ja.JACOBIAN_REGULARIZERS if divergence == "exact" else ("jac_frobenius",)
    ts = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    kw = dict(reg_names=("l1", "l2", "squared_l2"), divergence=divergence, method=method,
              jac_reg_names=jac, jac_method=divergence, num_probes=2)
    ref = fast_jit(lambda xx: ja.augmented_odeint(jf, xx, jnp.asarray(ts), div_key=key, **kw))(
        jnp.asarray(x))
    probes = _jax_probes(key, 8, 2, 2) if divergence == "hutch" else None
    out = ta.augmented_odeint(tf, torch.from_numpy(x), ts, probes=probes, **kw)
    _state_close(out, ref)


def test_hutch_probes_are_drawn_once_per_call():
    """With a generator the field draws its probes at the first evaluation
    and reuses them: the result equals the run handed those probes, and
    differs from one with fresh probes at every step."""
    _, _, _, _, tf = _mlp(seed=3)
    x = torch.from_numpy(_x(seed=12))
    ts = np.linspace(1.0, 0.0, 6, dtype=np.float32)
    out = ta.cnf_log_likelihood(tf, x, n_steps=5, divergence="hutch",
                                generator=torch.Generator().manual_seed(0))
    probes = ta.rademacher(torch.Generator().manual_seed(0), (8, 1, 2))
    with torch.no_grad():
        again = ta.cnf_log_likelihood(tf, x, n_steps=5, divergence="hutch", probes=probes)
    _close(out, again.numpy(), 0)
    gen = torch.Generator().manual_seed(0)

    def redraw(t, s):  # a new field at every evaluation: new probes each time
        return ta.make_augmented_field(tf, divergence="hutch", generator=gen)(t, s)

    init = ta.AugmentedState(x, torch.zeros(8), {})
    with torch.no_grad():
        moved = odeint(redraw, init, ts, method="euler", return_trajectory=False).final
    assert (ta.standard_normal_logprob(moved.x) - moved.logp - out).abs().max() > 1e-4


@pytest.mark.parametrize("divergence,method", [("exact", "euler"), ("hutch", "euler"),
                                               ("exact", "midpoint")])
def test_cnf_log_likelihood_and_its_gradients_match_jax(divergence, method):
    """log p(x1) along 8 backward steps, and the gradient of its mean in the
    MLP's parameters (second order: through the trace)."""
    jm, params, tm, _, tf = _mlp(seed=4)
    x = _x(seed=13)
    key = jax.random.PRNGKey(14)

    def jll(p, xx):
        f = lambda t, v: jm.apply(p, jnp.full((v.shape[0],), t, v.dtype), v)
        return ja.cnf_log_likelihood(f, xx, n_steps=8, divergence=divergence, key=key,
                                     method=method)

    ref = fast_jit(jll)(params, jnp.asarray(x))
    g = fast_jit(jax.grad(lambda p: jnp.mean(jll(p, jnp.asarray(x)))))(params)
    probes = _jax_probes(key, 8, 1, 2) if divergence == "hutch" else None
    out = ta.cnf_log_likelihood(tf, torch.from_numpy(x), n_steps=8, divergence=divergence,
                                method=method, probes=probes)
    _close(out, ref)
    out.mean().backward()
    want = mlp_params_from_flax(g["params"])
    for name, p in tm.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-4, err_msg=name)


@pytest.mark.parametrize("divergence", ["exact", "hutch"])
def test_cnf_log_likelihood_through_group_norms_matches_jax(divergence):
    """log p(x1) of a ``ResNetDiffEq`` drift, whose GroupNorms go through the
    port's wrapper (its autograd Functions under ``torch.func``: vmap, vjp
    and, for the loss, their second derivative), along 3 backward euler
    steps, and the gradient of its mean in the parameters; with "hutch"
    also the Hutchinson Jacobian regulariser (jvp) and its gradient. The
    values within 1e-5; the gradients within 2e-4, the bound of the
    ResNetDiffEq test of ``tests/test_torch_diffeq.py`` (flax's one-pass
    variance)."""
    jmod = jd.ResNetDiffEq(dim=1, intermediate_dim=8, n_resblocks=1)
    x = 2.0 * np.random.default_rng(16).standard_normal((3, 3, 3, 1)).astype(np.float32) + 0.5
    variables = random_variables(jmod, jnp.zeros((3,)), jnp.asarray(x), seed=17)
    tmod = td.ResNetDiffEq(1, 8, 1)
    tmod.load_state_dict(variables_from_flax(variables), strict=True)
    key = jax.random.PRNGKey(18)
    probes = _jax_probes(key, 3, 1, 9) if divergence == "hutch" else None

    def jloss(p, xx):
        f = lambda t, v: jmod.apply({"params": p}, jnp.full((v.shape[0],), t, v.dtype), v)
        ll = ja.cnf_log_likelihood(f, xx, n_steps=3, divergence=divergence, key=key)
        jac = (ja.batched_jacobian_regs(f, 0.3, xx, ["jac_frobenius"], method="hutch",
                                        key=key)["jac_frobenius"]
               if divergence == "hutch" else jnp.zeros(3))
        return jnp.mean(ll) + jnp.mean(jac), (ll, jac)

    (_, (ref_ll, ref_jac)), g = fast_jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], jnp.asarray(x))
    tf = lambda t, v: tmod(torch.full((v.shape[0],), float(t)), v)
    xt = torch.from_numpy(x)
    before = tgn.fused_group_norm_silu.launches
    ll = ta.cnf_log_likelihood(tf, xt, n_steps=3, divergence=divergence, probes=probes)
    _close(ll, ref_ll)
    loss = ll.mean()
    if divergence == "hutch":
        jac = ta.batched_jacobian_regs(tf, 0.3, xt, ["jac_frobenius"], method="hutch",
                                       probes=probes)["jac_frobenius"]
        _close(jac, ref_jac)
        loss = loss + jac.mean()
    loss.backward()
    want = variables_from_flax({"params": g})
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in tmod.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-4,
                                   atol=2e-4 * max(np.abs(w).max(), 1e-3 * top), err_msg=name)
    assert tgn.fused_group_norm_silu.launches == before  # the CPU runs the plain versions


def test_standard_normal_logprob_matches_jax():
    z = np.random.default_rng(15).standard_normal((4, 3, 2)).astype(np.float32)
    _close(ta.standard_normal_logprob(torch.from_numpy(z)),
           ja.standard_normal_logprob(jnp.asarray(z)))
