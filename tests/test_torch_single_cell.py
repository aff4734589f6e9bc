"""The single-cell trajectory path as a whole (cfm_tpu_torch/single_cell.py)
against JAX's ``examples/single_cell.py``, whose step (:124-147) is rebuilt
here: the same npz data through both loaders, the flax MLP's parameters
carried across, and the port handed the draws JAX makes from its keys. The
per-batch route's population batch is drawn here without replacement and
given to both steps: a resampled batch repeats cells, whose assignment then
has tied optima that the solvers may break apart (the resampling is held on
its own in test_torch_trajectory.py). One
step's loss, parameters and EMA within 1e-5 relative (parameters and EMA of
each tensor's max-abs), on both routes (OT per batch with a held-out
timepoint, and joint plans solved up front); the evaluation's rk4 rollout
and its metrics against JAX's on the same parameters and predictions,
1e-5. Then the CLI with ``--device cpu`` on the synthetic population (n =
256, 20 steps) by both routes, and the plotting helpers against JAX's
figures."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cfm_tpu import ExactOptimalTransportConditionalFlowMatcher as JOTCFM
from cfm_tpu.coupling import OTPlanSampler as JOTPlanSampler
from cfm_tpu.data import trajectory as jtr
from cfm_tpu.eval.metrics import compute_distribution_distances as jdistances
from cfm_tpu.integrate import odeint as jodeint
from cfm_tpu.models import MLP as JMLP
from cfm_tpu.train import init_train_state, make_optimizer
from cfm_tpu.utils import ema_update
from cfm_tpu_torch import single_cell as tsc
from cfm_tpu_torch.models.convert import mlp_params_from_flax
from cfm_tpu_torch.train import init_train_state as tinit


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
BATCH = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _npz(tmp_path, sizes, dim=3, seed=0):
    """A tree population with ``sizes`` cells a timepoint, written as the
    npz loader reads it (pcs, sample_labels)."""
    rng = np.random.default_rng(seed)
    X = np.asarray(jtr.tree_population(jax.random.PRNGKey(seed), max(sizes), T=len(sizes),
                                       dim=dim))
    pcs = np.concatenate([X[rng.permutation(max(sizes))[:n], t] for t, n in enumerate(sizes)])
    labels = np.concatenate([np.full(n, float(t)) for t, n in enumerate(sizes)])
    path = str(tmp_path / "traj.npz")
    np.savez(path, pcs=pcs * 3.0 + 1.0, sample_labels=labels)
    return path


class _JaxRun:
    """examples/single_cell.py's model, optimizer and step, on ``marginals``."""

    def __init__(self, marginals, leaveout, plan_sample, sigma=0.1):
        self.marginals, self.leaveout, self.plan_sample = marginals, leaveout, plan_sample
        dim = marginals[0].shape[1]
        matcher = JOTCFM(sigma=sigma)
        self.inner = matcher.without_coupling() if plan_sample is not None else matcher
        self.model = JMLP(dim=dim, w=64)
        params = self.model.init(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, dim)))
        self.opt = make_optimizer(lr=1e-3, warmup_steps=0)
        self.state = init_train_state(params, self.opt)
        self.value_and_grad = jax.jit(jax.value_and_grad(self.loss_fn))  # the example jits it

    def loss_fn(self, params, key, X):
        k_seg, k_fm = jax.random.split(key)
        if self.plan_sample is not None:
            x0, x1, t_sel = self.plan_sample(k_seg, BATCH)
        else:
            x0, x1, t_sel = jtr.sample_segment_pairs(k_seg, X, leaveout_timepoint=self.leaveout,
                                                     training=True)
        t, xt, ut = self.inner.sample_location_and_conditional_flow(k_fm, x0, x1)
        ut, t = jtr.leaveout_adjusted_targets(ut, t, t_sel, self.leaveout)
        vt = self.model.apply(params, t + t_sel, xt)
        return jnp.mean(jnp.square(vt - ut))

    def step(self, key, X):
        state = self.state
        loss, grads = self.value_and_grad(state.params, key, X)
        updates, opt_state = self.opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        self.state = state._replace(params=params, opt_state=opt_state, step=state.step + 1,
                                    ema_params=ema_update(state.ema_params, params, 0.99))
        return float(loss)


def _population_batch(marginals, rng):
    """A (BATCH, T, dim) batch of distinct cells of each timepoint."""
    return np.stack([m[rng.permutation(len(m))[:BATCH]] for m in marginals], 1).astype(np.float32)


def _port_draws(key, run, sc):
    """The numbers JAX's step draws from ``key``."""
    T, B = sc.T, BATCH
    k_seg, k_fm = jax.random.split(key)
    sizes = [m.shape[0] for m in run.marginals]
    held = 0 < run.leaveout < T
    d = tsc.TrajectoryDraws()
    if run.plan_sample is not None:
        k_t, k_i, k_u = jax.random.split(k_seg, 3)
        d.t_draw = _t(jax.random.randint(k_t, (B,), 0, T - 2 if held else T - 1))
        d.u = _t(jax.random.uniform(k_u, (B,)))
        d.rows = {t: _t(jax.random.randint(jax.random.fold_in(k_i, t), (B,), 0, sizes[t]))
                  for t in sc.plan_sample.segments}
        path_key = k_fm
    else:
        d.t_draw = _t(jax.random.randint(k_seg, (B,), 0, T - 2 if held else T - 1))
        plan_key, path_key = jax.random.split(k_fm)
        d.plan_u = _t(jax.random.uniform(plan_key, (B,)))
    t_key, eps_key = jax.random.split(path_key)
    d.t = _t(jax.random.uniform(t_key, (B,)))
    d.eps = _t(jax.random.normal(eps_key, (B, sc.dim)))
    return d


def _port_run(path, leaveout, joint, params):
    argv = ["--npz", path, "--dim", "3", "--batch", str(BATCH), "--leaveout", str(leaveout),
            "--device", "cpu"] + (["--joint-plans"] if joint else [])
    sc = tsc.SingleCell(tsc.build_parser().parse_args(argv))
    sc.model.load_state_dict(mlp_params_from_flax(params["params"]))
    sc.state = tinit(sc.model, sc.optimizer)
    return sc


def _state_close(sc, run):
    flat = mlp_params_from_flax(run.state.params["params"])
    ema = mlp_params_from_flax(run.state.ema_params["params"])
    names = [n for n, _ in sc.model.named_parameters()]
    for name, p, e in zip(names, sc.state.params, sc.state.ema_params):
        _close(p.detach().numpy(), flat[name].numpy())
        _close(e.numpy(), ema[name].numpy())


@pytest.mark.parametrize("joint,leaveout", [(False, 2), (False, -1), (True, 2)])
def test_steps_match_the_examples_jax_step(tmp_path, joint, leaveout):
    """Two steps. Jagged timepoints on the per-batch route; equal ones (the
    exact joint plans are then unique permutations) with joint plans."""
    sizes = [48] * 5 if joint else [40, 48, 36, 44, 40]
    path = _npz(tmp_path, sizes)
    marginals, _ = jtr.load_npz_timeseries(path, max_dim=3)
    marginals, _, _ = jtr.whiten(marginals)
    plan_sample = None
    if joint:
        solver = JOTPlanSampler(method="exact")
        plans = [np.asarray(solver.get_map(jnp.asarray(marginals[t]),
                                           jnp.asarray(marginals[t + 1]))) for t in range(4)]
        straddle = [np.asarray(solver.get_map(jnp.asarray(marginals[t]),
                                              jnp.asarray(marginals[t + 2]))) for t in range(3)]
        plan_sample = jtr.make_joint_plan_sampler(marginals, plans, leaveout_timepoint=leaveout,
                                                  straddle_plans=straddle)
    run = _JaxRun(marginals, leaveout, plan_sample)
    sc = _port_run(path, leaveout, joint, run.state.params)
    for a, b in zip(sc.marginals, marginals):
        _close(a.numpy(), b, rtol=1e-6)
    if joint:
        for a, b in zip(sc.plans + sc.straddle_plans, plans + straddle):
            np.testing.assert_array_equal(a.numpy(), b)
    key, rng = jax.random.PRNGKey(1), np.random.default_rng(2)
    for _ in range(2):
        key, ks = jax.random.split(key)
        X = None if joint else _population_batch(marginals, rng)
        ref = run.step(ks, None if joint else jnp.asarray(X))
        loss = float(sc.step(None if joint else _t(X), _port_draws(ks, run, sc)))
        assert loss == pytest.approx(ref, rel=RTOL)
        _state_close(sc, run)


def test_evaluation_matches_jax_rollout_and_metrics(tmp_path, capsys):
    """Sizes above and below the evaluation's 1000-point cap are not needed:
    n_eval = min(1000, smallest marginal) = 36 here."""
    path = _npz(tmp_path, [40, 48, 36, 44, 40])
    marginals = jtr.whiten(jtr.load_npz_timeseries(path, max_dim=3)[0])[0]
    run = _JaxRun(marginals, 2, None)
    key = jax.random.PRNGKey(3)
    key, kb, ks = jax.random.split(key, 3)
    run.step(ks, jtr.resample_to_trajectory(kb, marginals, BATCH))  # EMA != params
    sc = _port_run(path, 2, False, run.state.params)
    ema = mlp_params_from_flax(run.state.ema_params["params"])
    for (name, _), e in zip(sc.model.named_parameters(), sc.state.ema_params):
        e.copy_(ema[name])
    preds = sc.rollout()

    @jax.jit
    def rollout(ema, x):
        def f(t, x):
            return run.model.apply(ema, jnp.full((x.shape[0],), t, x.dtype), x)

        preds = []
        for seg in range(4):
            x = jodeint(f, x, jnp.linspace(float(seg), float(seg + 1), 51), method="rk4",
                        return_trajectory=False).final
            preds.append(x)
        return preds

    ref_preds = rollout(run.state.ema_params, jnp.asarray(marginals[0][:36]))
    for a, b in zip(preds, ref_preds):
        _close(a.numpy(), b)
    names, vals = sc.evaluate()
    ref_names, ref_vals = jdistances([jnp.asarray(p.numpy()) for p in preds],
                                     [jnp.asarray(m[:36]) for m in marginals[1:]])
    assert names == ref_names and len(names) == 5 * 8
    np.testing.assert_allclose(vals, ref_vals, rtol=RTOL, atol=1e-7)
    out = capsys.readouterr().out
    assert "held-out timepoint 2 W2:" in out and "  2-Wasserstein:" in out


@pytest.mark.parametrize("extra", [[], ["--joint-plans", "--leaveout", "2"]])
def test_cli_runs_on_the_cpu_by_both_routes(capsys, extra):
    assert tsc.main(["--synthetic", "--device", "cpu", "--n", "256", "--steps", "20"]
                    + extra) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "5 timepoints, dim 2, sizes [256, 256, 256, 256, 256]"
    assert sum(line.startswith("step ") for line in out) == 10
    metrics = [line for line in out if line.startswith("  ")]
    assert len(metrics) == 8 and all(np.isfinite(float(m.split(": ")[1])) for m in metrics)
    if extra:
        assert "solved 4 joint plans up front (synthetic mode)" in out
        assert np.isfinite(float(out[-1].split(": ")[1]))


def test_plots_draw_what_jax_draws(tmp_path):
    """Each figure's plotted data against JAX's, on the same inputs."""
    from cfm_tpu.eval import plotting as jpl
    from cfm_tpu_torch.eval import plotting as tpl

    rng = np.random.default_rng(5)
    traj = rng.standard_normal((6, 30, 2)).astype(np.float32)
    obs = [rng.standard_normal((n, 2)).astype(np.float32) for n in (20, 25, 18)]
    g = [rng.uniform(size=(4, 4)) for _ in range(4)]

    def field_np(t, x):
        return -0.5 * x + t

    pairs = [
        (jpl.plot_trajectories(traj), tpl.plot_trajectories(_t(traj))),
        (jpl.plot_trajectory(obs, traj), tpl.plot_trajectory([_t(o) for o in obs], _t(traj))),
        (jpl.plot_scatter_and_flow(traj[0], lambda t, x: field_np(t, x)),
         tpl.plot_scatter_and_flow(_t(traj[0]), lambda t, x: field_np(t, x))),
        (jpl.plot_paths(obs, lambda t, x: field_np(t, x), n=10),
         tpl.plot_paths([_t(o) for o in obs], lambda t, x: field_np(t, x), n=10)),
        (jpl.plot_graph_dist(*g), tpl.plot_graph_dist(*g)),
    ]
    for ref, out in pairs:
        for ra, oa in zip(ref.axes, out.axes):
            for rc, oc in zip(ra.collections, oa.collections):
                np.testing.assert_allclose(np.asarray(oc.get_offsets()),
                                           np.asarray(rc.get_offsets()), rtol=1e-5, atol=1e-5)
            for rl, ol in zip(ra.lines, oa.lines):
                np.testing.assert_allclose(ol.get_xydata(), rl.get_xydata(), rtol=1e-5, atol=1e-5)
            for ri, oi in zip(ra.images, oa.images):
                np.testing.assert_array_equal(oi.get_array(), ri.get_array())
        assert len(out.axes) == len(ref.axes)
    saved = tpl.plot_trajectories(_t(traj), save_path=str(tmp_path / "p" / "traj.png"))
    assert saved.endswith("traj.png") and (tmp_path / "p" / "traj.png").stat().st_size > 0
    npy = tpl.store_trajectories(_t(traj), str(tmp_path / "t" / "traj.npy"))
    np.testing.assert_array_equal(np.load(npy), traj)
    imgs = rng.uniform(-1, 1, (120, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tpl.plot_samples(imgs), tpl.image_grid(imgs[:100], nrow=10))
    import matplotlib.pyplot as plt

    plt.close("all")
