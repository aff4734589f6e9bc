"""The port's examples (cfm_tpu_torch/train_2d.py, tabular_forest_flow.py)
and the repairs of their slice (``data.eight_normal_sample``, the ``ops``
and ``eval`` package exports) against the JAX package, on the CPU.

- ``train_2d``: JAX's key schedule of ``examples/train_2d.py`` is replayed
  (per step ``split(key, 4)``, 8 Gaussians and moons from two of the keys,
  the step's draws from the third, split as the JAX step splits it), and 5
  steps of ``otcfm`` and of ``sbcfm --sde`` at the example's arguments
  (batch 256, lr 2e-3, clip 1.0, EMA 0.99) run through the port's loop and
  through JAX's jitted ``make_train_step``, from the same converted initial
  weights: each step's loss within 1e-5 relative, parameters and EMA
  within 1e-6. Then, from JAX's 2048 source points and the EMA parameters,
  the euler-101 generation (1e-5 relative to the largest value) and its W1
  and W2 to JAX's 2048 target points (1e-5 relative); with ``--sde``, the
  SDE rollout given JAX's normals (1e-5).
- ``train_2d.main`` with ``--device cpu`` prints JAX's line format on
  three routes (its evaluation cut from 2048 to 256 points, a CPU size);
  the ``MATCHERS`` table builds JAX's matchers with JAX's sigmas.
- ``tabular_forest_flow``: both mains at ``--n_t 3 --dup 3 --steps 10
  --seed 0`` (the JAX one imported from its file, run with ``sys.argv``
  set; its two W2 values recorded from ``cfm_tpu.coupling.wasserstein``):
  W2 and the noise baseline within 1e-4. The per-level training sets also
  within 1e-6 of JAX's ``sample_xt``.
- ``eight_normal_sample`` against JAX by moments at dim 2 and 5, and its
  ``ValueError``; ``cfm_tpu_torch.ops`` and ``cfm_tpu_torch.eval`` export
  JAX's ``__all__``.
- Without a card the scripts raise unless given ``--device cpu``; the
  tabular one raises ``ImportError`` without scikit-learn before it
  touches the device.

The card's twin (``-m cuda``) runs ``train_2d`` as ``chip_smoke.py`` phase
34 does. The chip machine has no flax, so JAX is imported only inside the
CPU tests.
"""

import importlib
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from cfm_tpu_torch import tabular_forest_flow as ttf
from cfm_tpu_torch import train_2d as t2
from cfm_tpu_torch.data import toy as ttoy
from cfm_tpu_torch.train import StepDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABULAR_ARGS = ["--n_t", "3", "--dup", "3", "--steps", "10", "--seed", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    """The JAX example ``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(out, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# train_2d
# ---------------------------------------------------------------------------


def test_matchers_table_builds_jax_matchers():
    ex = _example("train_2d")
    assert sorted(t2.MATCHERS) == sorted(ex.MATCHERS)
    for kind in ex.MATCHERS:
        for sigma in (0.0, 0.05, 0.1, 0.5):
            ref, got = ex.MATCHERS[kind](sigma), t2.MATCHERS[kind](sigma)
            assert type(got).__name__ == type(ref).__name__, kind
            assert got.sigma == pytest.approx(ref.sigma), (kind, sigma)
            if hasattr(ref, "ot_method"):
                assert got.ot_method == ref.ot_method, kind
    assert t2.MATCHERS["sbcfm"](0.0).sigma == 0.1


def _jax_example_run(kind, sde, steps, batch):
    """``examples/train_2d.py``'s main for ``steps`` steps, recording the
    initial parameters, each step's batch, loss and draws, the final state
    and the key after the loop."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu import train as jtr
    from cfm_tpu.data import eight_gaussians, sample_moons
    from cfm_tpu.models import MLP as JMLP

    ex = _example("train_2d")
    matcher = ex.MATCHERS[kind](0.1)
    model = JMLP(dim=2, w=64)
    key = jax.random.PRNGKey(0)
    params = model.init(key, jnp.zeros((2,)), jnp.zeros((2, 2)))
    if sde:
        params = {"flow": params,
                  "score": model.init(jax.random.fold_in(key, 1), jnp.zeros((2,)),
                                      jnp.zeros((2, 2)))}
    opt = jtr.make_optimizer(lr=2e-3, warmup_steps=0, grad_clip=1.0)
    state = jtr.init_train_state(params, opt)
    step = jax.jit(jtr.make_train_step(matcher, model.apply, opt, ema_decay=0.99,
                                       score_apply_fn=model.apply if sde else None))
    batches, draws, losses = [], [], []
    for _ in range(steps):
        key, k0, k1, ks = jax.random.split(key, 4)
        x0, x1 = eight_gaussians(k0, batch), sample_moons(k1, batch)
        state, metrics = step(state, ks, x0, x1)
        plan_key, path_key = jax.random.split(jax.random.split(ks, 3)[0])
        t_key, eps_key = jax.random.split(path_key)
        draws.append(StepDraws(_t(jax.random.uniform(t_key, (batch,))),
                               _t(jax.random.normal(eps_key, (batch, 2))),
                               _t(jax.random.uniform(plan_key, (batch,)))))
        batches.append((_t(x0), _t(x1)))
        losses.append(float(metrics["loss"]))
    return dict(model=model, params=params, state=state, batches=batches, draws=draws,
                losses=losses, key=key)


def _port_run(kind, sde, params):
    """The port's heads from JAX's initial ``params`` (the EMA equal to them)."""
    from cfm_tpu_torch.models.convert import mlp_pair_params_from_flax, mlp_params_from_flax

    run = t2.build(t2.MATCHERS[kind](0.1), lr=2e-3, seed=0, sde=sde, device="cpu")
    if sde:
        flow_sd, score_sd = mlp_pair_params_from_flax(params)
        run.score_model.load_state_dict(score_sd)
    else:
        flow_sd = mlp_params_from_flax(params["params"])
    run.model.load_state_dict(flow_sd)
    with torch.no_grad():
        for e, p in zip(run.state.ema_params, run.state.params):
            e.copy_(p)
    return run


def _flat_flax(params, sde, names):
    """JAX's (flow[, score]) parameters converted, in the port's order ``names``."""
    from cfm_tpu_torch.models.convert import mlp_pair_params_from_flax, mlp_params_from_flax

    sds = mlp_pair_params_from_flax(params) if sde else (mlp_params_from_flax(params["params"]),)
    return [sd[name] for sd in sds for name in names]


@pytest.mark.parametrize("kind,sde", [("otcfm", False), ("sbcfm", True)])
def test_train_2d_steps_and_generation_match_jax_example(kind, sde):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.coupling import wasserstein as jwasserstein
    from cfm_tpu.data import eight_gaussians, sample_moons
    from cfm_tpu.integrate import FlowSolver, odeint, vector_field_from_model

    from cfm_tpu_torch.coupling import wasserstein

    steps, batch = 5, 256
    ref = _jax_example_run(kind, sde, steps, batch)
    run = _port_run(kind, sde, ref["params"])
    losses, step = [], run.step
    # Where an element's gradients have so far stayed within 100 eps (1e-6)
    # of zero, they are the rounding noise of sums that cancel, and that
    # step's Adam update divides the noise by eps: the element may move by up
    # to lr (2e-3) in one package and not in the other (SB-CFM's score head
    # has one such element at the first step, |g| = 3.2e-8). Those elements
    # are held to that bound, every other one to 1e-6.
    noise = [torch.zeros(p.shape, dtype=torch.bool) for p in run.state.params]

    def recording(*a, **kw):
        metrics = step(*a, **kw)
        losses.append(float(metrics["loss"]))
        opt = run.state.opt_state
        for m, v in zip(noise, opt.nu):
            m |= torch.sqrt(v / (1.0 - 0.999 ** opt.count)) < 1e-6
        return metrics

    run.step = recording
    t2.train(run, steps, batch, None, batches=ref["batches"], draws=ref["draws"])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    jstate = ref["state"]
    names = [n for n, _ in run.model.named_parameters()]
    assert sum(int(m.sum()) for m in noise) <= 0.01 * sum(m.numel() for m in noise)
    for got, want, what in ((run.state.params, _flat_flax(jstate.params, sde, names), "params"),
                            (run.state.ema_params, _flat_flax(jstate.ema_params, sde, names),
                             "ema")):
        assert len(got) == len(want) == (16 if sde else 8)
        for name, g, w, m in zip(names * 2, got, want, noise):
            diff = np.abs(g.detach().numpy() - w.numpy())
            m = m.numpy()
            assert diff[~m].max() <= 1e-6, (what, name, diff[~m].max())
            assert diff[m].max(initial=0.0) <= 2e-3 * steps, (what, name, diff[m].max())

    # The example's evaluation: 2048 source and target points from JAX's keys.
    key, kg, kt = jax.random.split(ref["key"], 3)
    x0, target = eight_gaussians(kg, t2.N_EVAL), sample_moons(kt, t2.N_EVAL)
    model, ema = ref["model"], jstate.ema_params
    ts = jnp.linspace(0, 1, t2.EVAL_GRID)
    f = vector_field_from_model(model.apply, ema["flow"] if sde else ema)
    if sde:
        s = vector_field_from_model(model.apply, ema["score"])
        sde_key = jax.random.fold_in(key, 2)
        want = FlowSolver(drift=f, score=s, sigma=0.1).sdeint(sde_key, x0, ts).final
        noise = [_t(jax.random.normal(k, x0.shape))
                 for k in jax.random.split(sde_key, t2.EVAL_GRID - 1)]
        gen, label = t2.generate(run, _t(x0), sigma=0.1, sde=True, noise=noise)
        assert label == "SDE"
        _rel_close(gen.numpy(), want)
        return
    want = odeint(f, x0, ts, method="euler").final
    gen, label = t2.generate(run, _t(x0))
    assert label == "ODE/euler (nfe 100)"
    _rel_close(gen.numpy(), want)
    for power in (1, 2):
        np.testing.assert_allclose(float(wasserstein(gen, _t(target), power=power)),
                                   float(jwasserstein(want, target, power=power)), rtol=1e-5)


LINE = (r"^\[{kind}\] {label}: 2-moons W1=\d+\.\d{{3}} W2=\d+\.\d{{3}} "
        r"\(source W2=\d+\.\d{{3}}\)$")


@pytest.mark.parametrize("argv,label", [
    (["--matcher", "otcfm"], r"ODE/euler \(nfe 100\)"),
    (["--matcher", "sbcfm", "--sde"], "SDE"),
    (["--matcher", "icfm", "--ode-method", "dopri5"], r"ODE/dopri5 \(nfe \d+\)"),
])
def test_train_2d_main_prints_the_jax_lines(argv, label, capsys, monkeypatch):
    """20 steps at batch 64 on the CPU; the evaluation at 256 points (2048 in
    the script: three scipy solves of 4-7 s each here)."""
    monkeypatch.setattr(t2, "N_EVAL", 256)
    out = t2.main(argv + ["--device", "cpu", "--steps", "20", "--batch", "64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln[:10] for ln in lines[:10]] == [f"step {i:5d}"[:10] for i in range(0, 20, 2)]
    assert all(re.match(r"^step +\d+  loss \d+\.\d{4}$", ln) for ln in lines[:10])
    assert re.match(r"^trained 20 steps in \d+\.\ds \(\d+\.\d steps/s\)$", lines[10])
    kind = argv[1]
    assert re.match(LINE.format(kind=kind, label=label), lines[11]), lines[11]
    assert len(lines) == 12 and out["samples"].shape == (256, 2)
    assert np.isfinite([out["w1"], out["w2"], out["w2_src"]]).all()
    assert out["w1"] <= out["w2"] * (1 + 1e-6)


def test_scripts_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t2.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.main(TABULAR_ARGS)
    # Without scikit-learn the tabular example stops before the device.
    for name in ("sklearn", "sklearn.datasets", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="sklearn"):
        ttf.main(TABULAR_ARGS)


@pytest.mark.cuda
def test_train_2d_otcfm_on_cuda():
    """``chip_smoke.py`` phase 34's first run: 2000 steps at batch 256, one
    dense auction launch (#5) a step, three tiled auction launches (#6) in
    the evaluation, W2 under 0.9."""
    if not torch.cuda.is_available():
        pytest.skip("the auction kernels run only on a CUDA device")
    from cfm_tpu_torch.ops import auction as au

    dense, tiled = au.pallas_auction_assignment, au.pallas_auction_assignment_tiled
    before = dense.launches, tiled.launches
    out = t2.main(["--matcher", "otcfm"])
    assert (dense.launches - before[0], tiled.launches - before[1]) == (2000, 3)
    assert out["w2"] < 0.9 and out["samples"].is_cuda


# ---------------------------------------------------------------------------
# tabular_forest_flow
# ---------------------------------------------------------------------------


def test_tabular_forest_flow_matches_jax_example(monkeypatch, capsys):
    from threadpoolctl import threadpool_limits

    import cfm_tpu.coupling as jcoupling
    from cfm_tpu import ConditionalFlowMatcher as JCFM

    recorded = []
    wasserstein = jcoupling.wasserstein

    def recording(*a, **kw):
        out = wasserstein(*a, **kw)
        recorded.append(float(out))
        return out

    monkeypatch.setattr(jcoupling, "wasserstein", recording)
    monkeypatch.setattr(sys, "argv", ["tabular_forest_flow.py"] + TABULAR_ARGS)
    with threadpool_limits(1):
        _example("tabular_forest_flow").main()
        ref_line = capsys.readouterr().out.strip().splitlines()[-1]
        out = ttf.main(TABULAR_ARGS + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(recorded) == 2 and line == ref_line
    np.testing.assert_allclose([out["w2"], out["base"]], recorded, rtol=1e-4)
    assert out["w2"] < out["base"]

    # The per-level training sets against JAX's sample_xt on the same draws.
    rng = np.random.default_rng(3)
    x1 = np.repeat(rng.standard_normal((20, 4)).astype(np.float32), 3, axis=0)
    x0 = rng.standard_normal(x1.shape).astype(np.float32)
    import jax.numpy as jnp

    sets = ttf.level_training_sets(x0, x1, 4, "cpu")
    fm = JCFM(sigma=0.0)
    for (xt, ut), t in zip(sets, np.linspace(0.0, 1.0, 4, endpoint=False)):
        want = fm.sample_xt(jnp.asarray(x0), jnp.asarray(x1), jnp.full((60,), float(t)),
                            jnp.zeros((60, 4)))
        np.testing.assert_allclose(xt, np.asarray(want), atol=1e-6)
        np.testing.assert_array_equal(ut, x1 - x0)


# ---------------------------------------------------------------------------
# The repairs
# ---------------------------------------------------------------------------


def _moments_agree(a, b, what, k=4.0):
    """Means and covariances within k standard errors (each estimated from
    its own sample, combined)."""
    se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
    assert (np.abs(a.mean(0) - b.mean(0)) <= k * se).all(), (what, a.mean(0), b.mean(0))
    ca, cb = a - a.mean(0), b - b.mean(0)
    d = a.shape[1]
    for i in range(d):
        for j in range(i, d):
            pa, pb = ca[:, i] * ca[:, j], cb[:, i] * cb[:, j]
            se = np.sqrt(pa.var() / len(pa) + pb.var() / len(pb))
            assert abs(pa.mean() - pb.mean()) <= k * se, (what, i, j, pa.mean(), pb.mean())


@pytest.mark.parametrize("dim,scale,var", [(2, 1.0, 1.0), (5, 3.0, 0.2)])
def test_eight_normal_sample_matches_jax_by_moments(dim, scale, var):
    import jax

    from cfm_tpu.data.toy import eight_normal_sample as jsample

    n = 200_000
    ref = np.asarray(jsample(jax.random.PRNGKey(0), n, dim=dim, scale=scale, var=var),
                     dtype=np.float64)
    out = ttoy.eight_normal_sample(torch.Generator().manual_seed(0), n, dim=dim, scale=scale,
                                   var=var)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (n, dim)
    _moments_agree(out.numpy().astype(np.float64), ref, (dim, scale, var))
    if dim > 2:  # the centres lie in the first two coordinates only
        assert abs(out[:, 2:].mean().item()) < 0.01


def test_eight_normal_sample_refuses_dim_below_two_as_jax():
    import jax

    from cfm_tpu.data.toy import eight_normal_sample as jsample

    from cfm_tpu_torch.data import eight_normal_sample

    with pytest.raises(ValueError) as ref:
        jsample(jax.random.PRNGKey(0), 4, dim=1)
    with pytest.raises(ValueError) as got:
        eight_normal_sample(torch.Generator().manual_seed(0), 4, dim=1)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("package", ["ops", "eval", "data"])
def test_package_exports_match_jax(package):
    jax_pkg = importlib.import_module(f"cfm_tpu.{package}")
    pkg = importlib.import_module(f"cfm_tpu_torch.{package}")
    missing = set(jax_pkg.__all__) - set(pkg.__all__)
    assert not missing, missing
    if package != "data":  # the port's data package also exports its own helpers
        assert sorted(pkg.__all__) == sorted(jax_pkg.__all__)
    for name in pkg.__all__:
        assert callable(getattr(pkg, name)), name
    assert "triton" not in sys.modules
