"""The port's 2-D tutorial path (cfm_tpu_torch/models/mlp.py, data/toy.py,
paths.py's other matchers, coupling.wasserstein, the 2-D presets, the
Trainer's 2-D branch and cli.py) against JAX, on the CPU.

- ``MLP`` equals flax's ``MLP`` after ``mlp_params_from_flax`` within 1e-6
  (f32), for scalar and vector t; its initial weights have flax's
  truncated lecun-normal statistics.
- The target FM, SB-CFM and VP matchers give JAX's mu_t, sigma_t, u_t,
  lambda and score target for the same t and eps (1e-6).
- ``wasserstein`` gives JAX's exact W1 and W2 on the same clouds (1e-6
  relative).
- Each toy generator matches JAX's by mean and covariance at 200k samples,
  within 4 standard errors (the generators draw different numbers).
- One 2-D OT-CFM step equals ``cfm_tpu.train.make_train_step``'s step given
  the same x0, x1 and the draws JAX makes from its key (loss 1e-5 relative,
  parameters and EMA 1e-6).
- An 800-step ``2d_icfm`` run on the CPU passes the JAX package's gate,
  W2 < 1.1 (``tests/test_quality_band.py:94-99``).

Every Trainer and cli run writes its checkpoints and logs under the test's
own temporary directory.
"""

import numpy as np
import pytest
import torch

from cfm_tpu_torch import cli as tcli
from cfm_tpu_torch import config as tcfg
from cfm_tpu_torch import coupling as tcp
from cfm_tpu_torch import paths as tpa
from cfm_tpu_torch import trainer as ttrn
from cfm_tpu_torch.data import toy as ttoy
from cfm_tpu_torch.models.convert import mlp_params_from_flax
from cfm_tpu_torch.models.mlp import MLP


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def iso(tmp_path):
    """The test's own checkpoint directory, as an override."""
    return [f"trainer.ckpt_dir={tmp_path / 'ckpt'}"]


def _flax_mlp(dim, out_dim=None, time_varying=True, seed=0):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.models.mlp import MLP as JMLP

    m = JMLP(dim=dim, out_dim=out_dim, time_varying=time_varying)
    params = m.init(jax.random.PRNGKey(seed), jnp.zeros((2,)), jnp.zeros((2, dim)))
    return m, params


@pytest.mark.parametrize("dim,out_dim,time_varying", [(2, None, True), (3, 5, True),
                                                      (2, None, False)])
def test_mlp_matches_flax(dim, out_dim, time_varying):
    import jax.numpy as jnp

    m, params = _flax_mlp(dim, out_dim, time_varying, seed=1)
    model = MLP(dim, out_dim=out_dim, time_varying=time_varying, device="cpu")
    model.load_state_dict(mlp_params_from_flax(params["params"]))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, dim)).astype(np.float32) * 3
    for t in (rng.uniform(size=16).astype(np.float32), np.float32(0.3)):
        ref = np.asarray(m.apply(params, jnp.asarray(t), jnp.asarray(x)))
        with torch.no_grad():
            out = model(torch.as_tensor(t), torch.from_numpy(x)).numpy()
        assert out.shape == (16, out_dim or dim)
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_mlp_init_statistics_match_flax():
    """Per layer: std within 5% of flax's over 10 seeds (and of the
    lecun-normal value sqrt(1 / fan_in)), no weight beyond 2 / 0.8796 of
    sqrt(1 / fan_in), zero biases."""
    import jax

    flax_w = [[], [], [], []]
    port_w = [[], [], [], []]
    for seed in range(10):
        _, params = _flax_mlp(2, seed=seed)
        model = MLP(2, seed=seed, device="cpu")
        for k in range(4):
            flax_w[k].append(np.asarray(params["params"][f"Dense_{k}"]["kernel"]).ravel())
            layer = getattr(model, f"Dense_{k}")
            port_w[k].append(layer.weight.detach().numpy().ravel())
            assert not layer.bias.detach().any()
    assert not jax.tree.leaves({k: v["bias"] for k, v in params["params"].items()})[0].any()
    for k, fan_in in enumerate((3, 64, 64, 64)):
        f, p = np.concatenate(flax_w[k]), np.concatenate(port_w[k])
        want = fan_in ** -0.5
        assert abs(p.std() / f.std() - 1) < 0.05 and abs(p.std() / want - 1) < 0.05, k
        assert np.abs(p).max() <= 2 * want / 0.87962566103423978 * (1 + 1e-6)
        assert abs(p.mean()) < 4 * want / np.sqrt(p.size)


def _matchers(kind, sigma):
    from cfm_tpu import paths as jpa

    if kind == "fm":
        return jpa.TargetConditionalFlowMatcher(sigma), tpa.TargetConditionalFlowMatcher(sigma)
    if kind == "sbcfm":
        return (jpa.SchrodingerBridgeConditionalFlowMatcher(sigma),
                tpa.SchrodingerBridgeConditionalFlowMatcher(sigma))
    return (jpa.VariancePreservingConditionalFlowMatcher(sigma),
            tpa.VariancePreservingConditionalFlowMatcher(sigma))


@pytest.mark.parametrize("kind,sigma", [("fm", 0.1), ("sbcfm", 1.0), ("sbcfm", 0.5),
                                        ("vpcfm", 0.1), ("vpcfm", 0.0)])
def test_matchers_match_jax_given_t_and_eps(kind, sigma):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x0, x1, eps = (rng.standard_normal((8, 2)).astype(np.float32) for _ in range(3))
    t = rng.uniform(0.05, 0.95, size=8).astype(np.float32)
    jm, tm = _matchers(kind, sigma)
    J = dict(x0=jnp.asarray(x0), x1=jnp.asarray(x1), t=jnp.asarray(t))
    T = dict(x0=torch.from_numpy(x0), x1=torch.from_numpy(x1), t=torch.from_numpy(t))
    xt_ref = jm.sample_xt(J["x0"], J["x1"], J["t"], jnp.asarray(eps))
    coupled = {"plan_noise": torch.rand(8)} if kind == "sbcfm" else {}
    out = tm.sample_location_and_conditional_flow(None, T["x0"], T["x1"], t=T["t"],
                                                  eps=torch.from_numpy(eps), return_noise=True,
                                                  **coupled)
    assert tuple(out[1].shape) == (8, 2) and torch.equal(out[3], torch.from_numpy(eps))
    xt = tm.sample_xt(T["x0"], T["x1"], T["t"], torch.from_numpy(eps))
    pairs = (
        (tm.compute_mu_t(T["x0"], T["x1"], T["t"]), jm.compute_mu_t(J["x0"], J["x1"], J["t"])),
        (tm.compute_sigma_t(T["t"]), jm.compute_sigma_t(J["t"])),
        (xt, xt_ref),
        (tm.compute_conditional_flow(T["x0"], T["x1"], T["t"], xt),
         jm.compute_conditional_flow(J["x0"], J["x1"], J["t"], xt_ref)),
        (tm.compute_lambda(T["t"]), jm.compute_lambda(J["t"])),
        (tm.compute_score_target(xt, T["x0"], T["x1"], T["t"]),
         jm.compute_score_target(xt_ref, J["x0"], J["x1"], J["t"])),
    )
    for got, ref in pairs:
        got = got.numpy() if isinstance(got, torch.Tensor) else np.float32(got)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_sbcfm_refusals_match_jax():
    from cfm_tpu.paths import SchrodingerBridgeConditionalFlowMatcher as JSB

    for sigma in (0.0, -1.0):
        with pytest.raises(ValueError, match="strictly positive"):
            JSB(sigma)
        with pytest.raises(ValueError, match="strictly positive"):
            tpa.SchrodingerBridgeConditionalFlowMatcher(sigma)
    with pytest.warns(UserWarning, match="Small sigma"):
        tpa.SchrodingerBridgeConditionalFlowMatcher(1e-4)
    # The entropic coupling, refused before the entropic branch was ported,
    # builds as in JAX: reg = 2 sigma^2.
    sb = tpa.SchrodingerBridgeConditionalFlowMatcher(1.0, ot_method="sinkhorn")
    assert sb.ot_sampler.method == JSB(1.0, ot_method="sinkhorn").ot_sampler.method == "sinkhorn"


@pytest.mark.parametrize("sigma", [0.1, 0.5, 1.0, 2.0])
def test_sbcfm_entropic_reg_is_two_sigma_squared_as_in_jax(sigma):
    from cfm_tpu.paths import SchrodingerBridgeConditionalFlowMatcher as JSB

    for method in ("sinkhorn", "exact"):
        port = tpa.SchrodingerBridgeConditionalFlowMatcher(sigma=sigma, ot_method=method)
        assert port.ot_sampler.reg == 2 * sigma ** 2
        assert port.ot_sampler.reg == JSB(sigma=sigma, ot_method=method).ot_sampler.reg


@pytest.mark.parametrize("power", [1, 2])
def test_wasserstein_matches_jax(power):
    import jax.numpy as jnp

    from cfm_tpu.coupling import wasserstein as jw

    rng = np.random.default_rng(4 + power)
    a = rng.standard_normal((256, 2)).astype(np.float32) * 2
    b = (rng.standard_normal((256, 2)) + [1.0, -0.5]).astype(np.float32)
    ref = float(jw(jnp.asarray(a), jnp.asarray(b), power=power))
    out = tcp.wasserstein(torch.from_numpy(a), torch.from_numpy(b), power=power)
    assert out.dim() == 0 and out.dtype == torch.float32
    np.testing.assert_allclose(float(out), ref, rtol=1e-6)
    tiled = tcp.wasserstein(torch.from_numpy(a), torch.from_numpy(b), power=power,
                            solver="pallas_tiled")  # the plain version of the card's kernel
    np.testing.assert_allclose(float(tiled), ref, rtol=1e-5)
    # Unequal sizes (the exact general-marginal plan) and the entropic cost,
    # refused before the entropic branch was ported, match JAX.
    ref = float(jw(jnp.asarray(a), jnp.asarray(b[:100]), power=power))
    out = tcp.wasserstein(torch.from_numpy(a), torch.from_numpy(b[:100]), power=power)
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    ref = float(jw(jnp.asarray(a), jnp.asarray(b), method="sinkhorn", reg=0.5, power=power))
    out = tcp.wasserstein(torch.from_numpy(a), torch.from_numpy(b), method="sinkhorn", reg=0.5,
                          power=power)
    np.testing.assert_allclose(float(out), ref, rtol=1e-5)
    with pytest.raises(ValueError):
        tcp.wasserstein(torch.from_numpy(a), torch.from_numpy(b), power=3)


_TOY = [("8gaussians", 0), ("moons", 0), ("pinwheel", 0), ("checkerboard", 0), ("circles", 0),
        ("2spirals", 0), ("swissroll", 0), ("scurve", 0), ("mixture", 0), ("gaussian", 0),
        ("gaussian", 5), ("funnel", 0), ("funnel", 4), ("blobs", 0)]


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


@pytest.mark.parametrize("name,dim", _TOY)
def test_toy_generators_match_jax_by_moments(name, dim):
    import jax

    from cfm_tpu.data.toy import two_dim_data as jdata

    n = 200_000
    ref = np.asarray(jdata(name, dim)(jax.random.PRNGKey(0), n), dtype=np.float64)
    out = ttoy.two_dim_data(name, dim)(torch.Generator().manual_seed(0), n)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    _moments_agree(out.numpy().astype(np.float64), ref, (name, dim))


def test_toy_name_errors_match_jax():
    from cfm_tpu.data.toy import two_dim_data as jdata

    for name, dim in (("nope", 0), ("moons", 3), ("8gaussians", 10)):
        with pytest.raises(ValueError) as ref:
            jdata(name, dim)
        with pytest.raises(ValueError) as got:
            ttoy.two_dim_data(name, dim)
        assert str(got.value) == str(ref.value)
    g = torch.Generator().manual_seed(0)
    for fn in (ttoy.eight_gaussians, ttoy.sample_moons, ttoy.moons):
        assert tuple(fn(g, 5).shape) == (5, 2)


def test_2d_otcfm_step_matches_jax_make_train_step():
    """JAX's step draws from its key: split into (matcher key, dropout key,
    score key), the matcher key into (plan key, path key), the path key into
    (t key, eps key). The test makes those draws and hands them to the port."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu import paths as jpa
    from cfm_tpu import train as jtr
    from cfm_tpu_torch import train as ttr

    B, lr, decay, sigma = 64, 2e-3, 0.99, 0.1
    rng = np.random.default_rng(6)
    x0 = rng.standard_normal((B, 2)).astype(np.float32) * 2
    x1 = (rng.standard_normal((B, 2)) * 0.5 + 1).astype(np.float32)
    m, params = _flax_mlp(2, seed=7)
    jopt = jtr.make_optimizer(lr=lr, warmup_steps=0, grad_clip=1.0)
    jstep = jtr.make_train_step(jpa.ExactOptimalTransportConditionalFlowMatcher(sigma), m.apply,
                                jopt, ema_decay=decay)
    key = jax.random.PRNGKey(8)
    jstate, jmetrics = jstep(jtr.init_train_state(params, jopt), key, jnp.asarray(x0),
                             jnp.asarray(x1))
    mkey = jax.random.split(key, 3)[0]
    plan_key, path_key = jax.random.split(mkey)
    t_key, eps_key = jax.random.split(path_key)
    draws = ttr.StepDraws(*(torch.tensor(np.asarray(a)) for a in (
        jax.random.uniform(t_key, (B,)), jax.random.normal(eps_key, (B, 2)),
        jax.random.uniform(plan_key, (B,)))))

    model = MLP(2, device="cpu")
    model.load_state_dict(mlp_params_from_flax(params["params"]))
    opt = ttr.make_optimizer(lr=lr, warmup_steps=0, grad_clip=1.0)
    state = ttr.init_train_state(model, opt)
    step = ttr.make_train_step(tpa.ExactOptimalTransportConditionalFlowMatcher(sigma), model, opt,
                               ema_decay=decay)
    metrics = step(state, torch.from_numpy(x0), torch.from_numpy(x1), draws=draws)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=1e-5)
    new, ema = (mlp_params_from_flax(p["params"]) for p in (jstate.params, jstate.ema_params))
    for (name, p), e in zip(model.named_parameters(), state.ema_params):
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), atol=1e-6, err_msg=name)
        np.testing.assert_allclose(e.numpy(), ema[name].numpy(), atol=1e-6, err_msg=name)


def test_2d_sf2m_step_matches_jax_make_train_step():
    """One ``2d_sf2m`` step with the entropic coupling at batch 128 (the dense
    Sinkhorn route in both packages on the CPU) and a score head, against
    JAX's ``make_train_step(score_apply_fn=...)`` on the converted
    ``{"flow", "score"}`` pair: the plan uniforms, t and eps are JAX's
    draws; loss, flow and score loss within 1e-5 relative, both heads'
    updated parameters and the EMA within 1e-6. The clip, Adam and EMA span
    both heads."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu import paths as jpa
    from cfm_tpu import train as jtr
    from cfm_tpu_torch import train as ttr
    from cfm_tpu_torch.models.convert import mlp_pair_params_from_flax

    B, lr, decay, sigma = 128, 2e-3, 0.99, 1.0
    rng = np.random.default_rng(16)
    x0 = rng.standard_normal((B, 2)).astype(np.float32) * 2
    x1 = (rng.standard_normal((B, 2)) * 0.5 + 1).astype(np.float32)
    m, flow = _flax_mlp(2, seed=17)
    _, score = _flax_mlp(2, seed=18)
    params = {"flow": flow, "score": score}
    jopt = jtr.make_optimizer(lr=lr, warmup_steps=0, grad_clip=1.0)
    jstep = jtr.make_train_step(jpa.SchrodingerBridgeConditionalFlowMatcher(
        sigma, ot_method="sinkhorn"), m.apply, jopt, ema_decay=decay, score_apply_fn=m.apply)
    key = jax.random.PRNGKey(19)
    jstate, jmetrics = jstep(jtr.init_train_state(params, jopt), key, jnp.asarray(x0),
                             jnp.asarray(x1))
    mkey = jax.random.split(key, 3)[0]
    plan_key, path_key = jax.random.split(mkey)
    t_key, eps_key = jax.random.split(path_key)
    draws = ttr.StepDraws(*(torch.tensor(np.asarray(a)) for a in (
        jax.random.uniform(t_key, (B,)), jax.random.normal(eps_key, (B, 2)),
        jax.random.uniform(plan_key, (B,)))))

    flow_sd, score_sd = mlp_pair_params_from_flax(params)
    model, score_model = MLP(2, device="cpu"), MLP(2, device="cpu")
    model.load_state_dict(flow_sd)
    score_model.load_state_dict(score_sd)
    opt = ttr.make_optimizer(lr=lr, warmup_steps=0, grad_clip=1.0)
    state = ttr.init_train_state(model, opt, score_model)
    matcher = tpa.SchrodingerBridgeConditionalFlowMatcher(sigma, ot_method="sinkhorn")
    assert not matcher.ot_sampler._use_flash(torch.from_numpy(x0), torch.from_numpy(x1))
    step = ttr.make_train_step(matcher, model, opt, ema_decay=decay, score_model=score_model)
    metrics = step(state, torch.from_numpy(x0), torch.from_numpy(x1), draws=draws)
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "flow_loss", "score_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert float(metrics["coupling_degenerate"]) == float(jmetrics["coupling_degenerate"]) == 0.0
    new = mlp_pair_params_from_flax(jstate.params)
    ema = mlp_pair_params_from_flax(jstate.ema_params)
    names = [("flow", n) for n, _ in model.named_parameters()] + [
        ("score", n) for n, _ in score_model.named_parameters()]
    assert len(names) == len(state.params) == len(state.ema_params) == 16
    for (head, name), p, e in zip(names, state.params, state.ema_params):
        i = 0 if head == "flow" else 1
        np.testing.assert_allclose(p.detach().numpy(), new[i][name].numpy(), atol=1e-6,
                                   err_msg=f"{head} {name}")
        np.testing.assert_allclose(e.numpy(), ema[i][name].numpy(), atol=1e-6,
                                   err_msg=f"{head} {name}")


def test_2d_sf2m_trainer_seeds_the_score_head_apart_and_generates_from_the_flow(tmp_path):
    """The score MLP has flax's init statistics but not the flow MLP's
    weights; the optimizer state spans both heads; ``generate`` integrates
    the flow head's EMA parameters alone."""
    trainer = ttrn.Trainer(tcfg.load_config("2d_sf2m", ["trainer.total_steps=2",
                                                        "trainer.ckpt_interval=0",
                                                        "data.batch_size=32"] + iso(tmp_path)),
                           device="cpu", log_dir=str(tmp_path))
    flow, score = trainer.model, trainer.score_model
    assert isinstance(score, MLP) and score.w == flow.w == 64
    assert not torch.equal(flow.Dense_1.weight, score.Dense_1.weight)
    std = score.Dense_1.weight.std().item() * 8  # fan_in 64: lecun std 1/8
    assert abs(std - 1) < 0.05, std
    assert len(trainer.state.params) == len(trainer.state.opt_state.mu) == 16
    trainer.fit()
    with torch.no_grad():
        for p, e in zip(score.parameters(), trainer.state.ema_params[8:]):
            p.copy_(e + 1e3)  # a score head that would wreck any sample it touched
    g = torch.Generator().manual_seed(0)
    a = trainer.generate(16, n_steps=2, generator=g).samples
    ema_flow = MLP(2, device="cpu")
    for p, e in zip(ema_flow.parameters(), trainer.state.ema_params[:8]):
        p.data.copy_(e)
    from cfm_tpu_torch.integrate import odeint, vector_field_from_model

    x0 = trainer._source(torch.Generator().manual_seed(0), 16, "cpu")
    ref = odeint(vector_field_from_model(ema_flow), x0, np.linspace(0, 1, 3, dtype=np.float32),
                 method="euler", return_trajectory=False).final
    assert torch.allclose(a, ref, atol=1e-6)


# tests/test_quality_band.py's _run: lr 1e-3, EMA 0.999, sigma 0.1, euler-100,
# W2 on 1024 points.
BAND = ["optim.lr=1e-3", "optim.ema_decay=0.999", "matcher.sigma=0.1", "trainer.eval_interval=0",
        "trainer.ckpt_interval=0", "trainer.log_interval=100000", "eval.ode_method=euler",
        "eval.ode_steps=100", "eval.num_eval_samples=1024"]


def test_short_2d_icfm_run_passes_the_jax_gate(tmp_path):
    """800 steps of ``2d_icfm`` on the CPU: W2 < 1.1, JAX's gate for the same
    protocol. One seed's W2 at 800 steps is noisy in both packages (JAX,
    seeds 0 and 1: 1.04 and 1.22; the port, seeds 0 to 3: 1.34, 1.06, 0.95,
    1.12), so the gate holds the median of three seeds. The untrained
    source-vs-moons W2 is about 1.64."""
    w2 = []
    for seed in range(3):
        cfg = tcfg.load_config("2d_icfm", BAND + ["trainer.total_steps=800",
                                                  f"trainer.seed={seed}"] + iso(tmp_path / str(seed)))
        trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
        trainer.fit()
        ev = trainer.evaluate()
        assert ev["nfe"] == 100 and ev["w1"] <= ev["w2"] * (1 + 1e-6)
        w2.append(ev["w2"])
    assert np.median(w2) < 1.1, w2


def test_2d_trainer_evaluates_every_interval_and_stops_early(capsys, tmp_path):
    cfg = tcfg.load_config("2d_otcfm", ["trainer.total_steps=6", "trainer.eval_interval=2",
                                        "trainer.ckpt_interval=0", "trainer.log_interval=2",
                                        "eval.num_eval_samples=64", "eval.ode_steps=4",
                                        "data.batch_size=32", "trainer.early_stop_metric=eval/w2",
                                        "trainer.early_stop_patience=1",
                                        "trainer.early_stop_min_delta=100.0"] + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    assert isinstance(trainer.model, MLP) and trainer.model.w == 64
    assert isinstance(trainer.matcher, tpa.ExactOptimalTransportConditionalFlowMatcher)
    state = trainer.fit()
    # min_delta 100: the second evaluation cannot improve, so the run stops at step 4.
    assert state.step == 4 and [e["step"] for e in trainer.eval_log] == [2, 4]
    assert all(e["nfe"] == 4 and e["seconds"] > 0 and np.isfinite(e["w2"])
               for e in trainer.eval_log)
    assert "early stop at step 4" in capsys.readouterr().out
    gen = trainer.generate(10, method="midpoint", n_steps=3)
    assert tuple(gen.samples.shape) == (10, 2) and gen.samples.dtype == torch.float32
    assert gen.nfe == 6
    cfg.trainer.early_stop_metric = "fid"
    with pytest.raises(ValueError, match="not an eval metric"):
        trainer.fit(8)
    cfg.trainer.eval_interval = 0
    with pytest.raises(ValueError, match="requires eval_interval"):
        trainer.fit(8)


@pytest.mark.parametrize("kind", ["icfm", "fm", "sbcfm", "vpcfm", "sf2m"])
def test_2d_presets_match_jax_and_train(kind, tmp_path):
    from cfm_tpu.config import load_config as jload
    from cfm_tpu.trainer import build_matcher as jbuild

    cfg, ref = tcfg.load_config(f"2d_{kind}"), jload(f"2d_{kind}")
    for group in ("model", "matcher", "data", "optim", "trainer", "eval"):
        for field, value in getattr(cfg, group).__dict__.items():
            assert value == getattr(getattr(ref, group), field), (kind, group, field)
    assert type(ttrn.build_matcher(cfg)).__name__ == type(jbuild(ref)).__name__
    trainer = ttrn.Trainer(tcfg.load_config(f"2d_{kind}", [
        "trainer.total_steps=3", "trainer.ckpt_interval=0", "data.batch_size=16"] + iso(tmp_path)),
        device="cpu", log_dir=str(tmp_path))
    assert trainer.fit().step == 3
    assert torch.isfinite(trainer.generate(8, n_steps=2).samples).all()


def test_2d_sf2m_and_unported_pieces_refuse(tmp_path):
    """``2d_sf2m``, the score head and the entropic coupling, refused before
    the entropic branch was ported, now load and train; so does
    ``eval.sde`` (SDE generation), refused before. The preset's checkpoint, refused
    before the harness was ported, is saved when it falls due (at 5000 of
    5000 steps in the preset; here at 3 of 3) and a new Trainer resumes there."""
    from cfm_tpu.config import load_config as jload

    cfg = tcfg.load_config("2d_sf2m")
    assert cfg.matcher == tcfg.MatcherConfig(**jload("2d_sf2m").matcher.__dict__)
    for i, override in enumerate((["matcher.score_head=True"], ["matcher.ot_method='sinkhorn'"])):
        trainer = ttrn.Trainer(tcfg.load_config("2d_sbcfm", override + [
            "trainer.total_steps=2", "trainer.ckpt_interval=0", "data.batch_size=16"]
            + iso(tmp_path / str(i))), device="cpu", log_dir=str(tmp_path))
        assert trainer.fit().step == 2
    assert trainer.matcher.ot_sampler.method == "sinkhorn" and trainer.score_model is None
    sde = ttrn.Trainer(tcfg.load_config("2d_sf2m", ["eval.sde=True"] + iso(tmp_path / "sde")),
                       device="cpu", log_dir=str(tmp_path))
    assert sde.cfg.eval.sde and sde.score_model is not None
    assert tcfg.load_config("2d_otcfm").trainer.ckpt_interval == 5000
    cfg = tcfg.load_config("2d_otcfm", ["trainer.total_steps=3", "trainer.ckpt_interval=3",
                                        "trainer.eval_interval=0", "data.batch_size=16"]
                           + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    trainer.fit()
    assert trainer.ckpt.all_steps() == [3]
    resumed = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    assert resumed.state.step == 3 and resumed.fit().step == 3
    assert all(torch.equal(a, b) for a, b in zip(resumed.state.params, trainer.state.params))
    with pytest.raises(ValueError, match="Unknown 2D dataset"):
        ttrn.Trainer(tcfg.load_config("2d_otcfm", ["data.dataset='nope'"] + iso(tmp_path / "x")),
                     device="cpu", log_dir=str(tmp_path))


def test_funnel_target_gets_a_gaussian_source_of_its_dimension(tmp_path):
    cfg = tcfg.load_config("2d_icfm", ["data.dataset='funnel'", "trainer.total_steps=2",
                                       "trainer.ckpt_interval=0", "data.batch_size=8"]
                           + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    assert trainer.model.dim == 10
    assert trainer.fit().step == 2
    assert tuple(trainer.generate(4, n_steps=2).samples.shape) == (4, 10)


def test_cli_trains_evaluates_and_lists_presets(capsys, tmp_path):
    """``cli train`` prints the config tree, trains, saves and ends with the
    final evaluation; ``cli eval``, refused before checkpoints were ported,
    restores the latest checkpoint and evaluates, and without one prints
    JAX's line and returns 1."""
    assert tcli.main(["presets"]) == 0
    listed = capsys.readouterr().out.split()
    assert "2d_otcfm" in listed and "cifar10_fm" in listed and "2d_sf2m" in listed
    run = ["trainer.total_steps=4", "trainer.ckpt_interval=0", "eval.num_eval_samples=32",
           "eval.ode_steps=2", "trainer.log_interval=2", "--log_dir", str(tmp_path)] + iso(tmp_path)
    assert tcli.main(["train", "2d_vpcfm", "--device", "cpu"] + run) == 0
    out = capsys.readouterr().out
    assert "step       4" in out and "final eval: {'w1'" in out and "device: cpu" in out
    assert "config: 2d_vpcfm\n|-- model\n" in out
    assert tcli.main(["eval", "2d_vpcfm", "--device=cpu"] + run) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "eval: {'w1'" in out
    assert tcli.main(["eval", "2d_otcfm", "--device", "cpu"] + run) == 1
    assert "no checkpoint to evaluate; run train first" in capsys.readouterr().out
    assert tcli.main(["bogus"]) == 2


def test_cli_trains_2d_sf2m_with_the_entropic_coupling(capsys, tmp_path):
    assert tcli.main(["train", "2d_sf2m", "matcher.ot_method=sinkhorn", "trainer.total_steps=4",
                      "trainer.ckpt_interval=0", "data.batch_size=64", "eval.num_eval_samples=32",
                      "eval.ode_steps=2", "trainer.log_interval=2", "--device", "cpu",
                      "--log_dir", str(tmp_path)] + iso(tmp_path)) == 0
    out = capsys.readouterr().out
    assert "config: 2d_sbcfm" in out and "params: 17,412" in out and "final eval: {'w1'" in out


def test_2d_trainer_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrn.Trainer(tcfg.load_config("2d_otcfm", iso(tmp_path)), log_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["train", "2d_otcfm", "--log_dir", str(tmp_path)] + iso(tmp_path))
