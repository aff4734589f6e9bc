"""SDE generation in the port's harness (cfm_tpu_torch/trainer.py
``generate_sde``, the ``eval.sde`` metrics, ``train_mnist --sde``) against the
JAX package, on the CPU.

- ``Trainer.generate_sde`` equals JAX's ``FlowSolver`` over both converted
  EMA heads, given the same x0 and JAX's normals (``keys = split(key,
  n_steps)``, ``normal(keys[i], x.shape)``): on ``2d_sf2m``'s MLP pair and on
  a narrow MNIST-shaped UNet pair, the final states within 1e-5 and the KL
  within 1e-5 relative, the same NFE.
- ``evaluate`` with ``eval.sde`` logs JAX's keys, measures ``sde_w2`` on the
  same target points as ``w2`` and gives a finite ``sde_kl``.
- ``train_mnist --sde`` trains [SF]2M at a narrow width and saves its 64 SDE
  samples as the ODE route saves its own.
- tsit5 takes the dense grid in ``Trainer.generate`` and the two-point span
  in ``generate``, as in the JAX package.

Every Trainer writes its checkpoints and logs under the test's own
temporary directory.
"""

import numpy as np
import pytest
import torch

from cfm_tpu_torch import config as tcfg
from cfm_tpu_torch import trainer as ttrn

# A narrow MNIST-shaped UNet pair: 16 and 32 channels, one res block,
# attention at 14x14 (the plain composition in both packages), float32.
NARROW_MNIST = dict(dim=(28, 28, 1), num_channels=16, num_res_blocks=1, channel_mult=(1, 2),
                    num_heads=1, num_head_channels=-1, attention_resolutions="14")
NARROW_OVERRIDES = ["model.num_channels=16", "model.channel_mult=(1, 2)", "model.bf16=False",
                    "data.batch_size=4", "trainer.log_interval=1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU models: the suite runs
    six workers on the machine's cores, and torch's OpenMP pool of one
    thread a core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def iso(tmp_path):
    return [f"trainer.ckpt_dir={tmp_path / 'ckpt'}"]


def _load_ema(trainer, flow_sd, score_sd):
    """Put the converted flax weights into the trainer's EMA list (flow
    head's entries first, then the score head's)."""
    names = [n for n, _ in trainer.model.named_parameters()]
    values = [flow_sd[n] for n in names] + [score_sd[n] for n in names]
    assert len(values) == len(trainer.state.ema_params)
    for e, v in zip(trainer.state.ema_params, values):
        e.copy_(v)


def _jax_sde(apply_fn, flow, score, x0, key, n_steps, sigma):
    """JAX's ``Trainer.generate_sde`` body from a given x0 and Brownian key."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.integrate import FlowSolver, vector_field_from_model

    @jax.jit
    def run(flow, score, x0, key):
        solver = FlowSolver(drift=vector_field_from_model(apply_fn, flow),
                            score=vector_field_from_model(apply_fn, score), sigma=sigma)
        return solver.sdeint(key, x0, jnp.linspace(0.0, 1.0, n_steps + 1), logqp=True,
                             return_trajectory=False)

    return run(flow, score, jnp.asarray(x0), key)


def _normals(key, n_steps, shape):
    import jax

    return [torch.tensor(np.asarray(jax.random.normal(k, shape))) for k in
            jax.random.split(key, n_steps)]


def _check_sde(trainer, ref, x0, key, n_steps):
    sol = trainer.generate_sde(x0.shape[0], n_steps=n_steps, logqp=True,
                               x0=torch.from_numpy(x0), noise=_normals(key, n_steps, x0.shape))
    assert sol.nfe == int(ref.nfe) == n_steps
    assert sol.ys.shape == (2,) + x0.shape and sol.logqp.shape == (x0.shape[0],)
    np.testing.assert_allclose(sol.final.numpy(), np.asarray(ref.final), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sol.logqp.numpy(), np.asarray(ref.logqp), rtol=1e-5)
    return sol


def test_generate_sde_matches_jax_flow_solver_on_2d_sf2m(tmp_path):
    """``2d_sf2m`` (sigma 1): 64 points, 100 Euler-Maruyama steps."""
    import jax

    from cfm_tpu.models.mlp import MLP as JMLP
    from cfm_tpu_torch.models.convert import mlp_params_from_flax

    trainer = ttrn.Trainer(tcfg.load_config("2d_sf2m", ["data.batch_size=16"] + iso(tmp_path)),
                           device="cpu", log_dir=str(tmp_path))
    m = JMLP(dim=2, w=64)
    flow, score = (m.init(jax.random.PRNGKey(s), np.zeros((2,), np.float32),
                          np.zeros((2, 2), np.float32)) for s in (21, 22))
    _load_ema(trainer, *(mlp_params_from_flax(p["params"]) for p in (flow, score)))
    x0 = np.random.default_rng(23).standard_normal((64, 2)).astype(np.float32) * 2
    key = jax.random.PRNGKey(24)
    ref = _jax_sde(m.apply, flow, score, x0, key, 100, 1.0)
    sol = _check_sde(trainer, ref, x0, key, 100)
    assert np.isfinite(sol.final.numpy()).all() and float(sol.logqp.min()) > 0


def test_generate_sde_matches_jax_flow_solver_on_a_unet_pair(tmp_path):
    """An MNIST-shaped UNet pair (``mnist_sbcfm`` with a score head at 16 and
    32 channels, float32) with random converted weights, sigma 0.5: 2
    images, 3 steps."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.models import unet as junet
    from cfm_tpu_torch.models.convert import unet_params_from_flax
    from test_torch_unet import random_flax_params

    cfg = tcfg.load_config("mnist_sbcfm", NARROW_OVERRIDES + [
        "matcher.score_head=True", "matcher.sigma=0.5"] + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    m = junet.UNetModelWrapper(**NARROW_MNIST)
    args = (jnp.zeros((1,)), jnp.zeros((1, 28, 28, 1)))
    flow, score = (random_flax_params(m, *args, seed=s) for s in (31, 32))
    _load_ema(trainer, unet_params_from_flax(flow), unet_params_from_flax(score))
    x0 = np.random.default_rng(33).standard_normal((2, 28, 28, 1)).astype(np.float32)
    key = jax.random.PRNGKey(34)
    ref = _jax_sde(lambda p, t, x: m.apply({"params": p}, t, x), flow, score, x0, key, 3, 0.5)
    _check_sde(trainer, ref, x0, key, 3)


def test_evaluate_with_eval_sde_logs_jax_keys_on_shared_targets(tmp_path, monkeypatch):
    """The 2-D evaluation adds ``sde_kl`` (finite, the mean of the rollout's
    KL) and ``sde_w2``, measured against the very target points of ``w2``
    (JAX draws both from one key, ``cfm_tpu/trainer.py:772-777``); without a
    score head ``eval.sde`` adds nothing; the image branch adds ``sde_kl``
    alone, as JAX's does. ``eval.sde``, refused before, runs in ``fit``."""
    calls = []
    real = ttrn.wasserstein

    def recording(x, y, **kw):
        calls.append((x, y, kw.get("power")))
        return real(x, y, **kw)

    monkeypatch.setattr(ttrn, "wasserstein", recording)
    cfg = tcfg.load_config("2d_sf2m", ["eval.sde=True", "eval.num_eval_samples=64",
                                       "eval.ode_steps=4", "data.batch_size=16",
                                       "trainer.eval_interval=2", "trainer.total_steps=2"]
                           + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    trainer.fit()
    ev = trainer.eval_log[-1]
    assert set(ev) == {"step", "w1", "w2", "nfe", "sde_kl", "sde_w2", "seconds"}
    assert np.isfinite(ev["sde_kl"]) and ev["sde_kl"] > 0 and np.isfinite(ev["sde_w2"])
    (g1, t1, p1), (g2, t2, p2), (g3, t3, p3) = calls
    assert (p1, p2, p3) == (1, 2, 2) and t1 is t2 is t3 and g1 is g2 and g3 is not g1
    assert ev["sde_w2"] == pytest.approx(float(real(g3, t3, power=2)))

    plain = ttrn.Trainer(tcfg.load_config("2d_sbcfm", [
        "eval.sde=True", "eval.num_eval_samples=16", "eval.ode_steps=2",
        "data.batch_size=16"] + iso(tmp_path / "plain")), device="cpu", log_dir=str(tmp_path))
    assert set(plain.evaluate()) == {"w1", "w2", "nfe"}

    image = ttrn.Trainer(tcfg.load_config("mnist_sbcfm", NARROW_OVERRIDES + [
        "matcher.score_head=True", "eval.sde=True", "eval.ode_steps=2",
        "eval.num_eval_samples=4"] + iso(tmp_path / "image")), device="cpu",
        log_dir=str(tmp_path))
    ev = image.evaluate()
    assert set(ev) == {"gen_mean", "gen_std", "nfe", "tracking_fid", "sde_kl"}
    assert np.isfinite(ev["sde_kl"])


def test_train_mnist_sde_entry_point(tmp_path, capsys):
    """``train_mnist --sde --synthetic`` at a narrow width: the JAX CLI's
    overrides (SB-CFM, sigma 1, a score head, ``eval.sde``), 2 steps, then
    64 samples by the SDE (``eval.ode_steps`` Euler-Maruyama steps: 100 in
    the preset, 2 here) saved as the uint8 array and the PNG grid."""
    from cfm_tpu_torch import train_mnist

    args = ["--sde", "--synthetic", "--steps", "2", "--batch_size", "4", "--device", "cpu",
            "--output_dir", str(tmp_path)] + [
        a for o in NARROW_OVERRIDES[:3] + ["eval.ode_steps=2"] for a in ("--override", o)]
    trainer = train_mnist.main(args)
    cfg = trainer.cfg
    assert trainer.state.step == 2 and cfg.name == "mnist_otcfm"
    assert (cfg.matcher.kind, cfg.matcher.sigma, cfg.matcher.score_head, cfg.eval.sde) == (
        "sbcfm", 1.0, True, True)
    assert trainer.score_model is not None
    samples = np.load(tmp_path / "mnist_samples.npy")
    assert samples.shape == (64, 28, 28, 1) and samples.dtype == np.uint8
    assert "saved 64 samples (NFE 2)" in capsys.readouterr().out
    assert (tmp_path / "mnist_samples.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_tsit5_grids_in_trainer_generate_and_generate(tmp_path):
    """``Trainer.generate`` integrates tsit5 over the n_steps-interval grid
    (it lands on every point: at least 6 NFE an interval, as JAX's
    ``Trainer.generate`` does), ``generate`` over the two-point span (as
    JAX's sample function does); both finish with the same images to a few
    levels, and tsit5 is accepted where it raised before."""
    from cfm_tpu_torch.generate import generate

    cfg = tcfg.load_config("mnist_otcfm", NARROW_OVERRIDES + ["eval.ode_method=tsit5",
                                                              "eval.ode_steps=4"] + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    with torch.no_grad():
        for p in trainer.state.ema_params:
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    dense = trainer.generate(4, generator=torch.Generator().manual_seed(3))
    assert dense.nfe >= 2 + 6 * 4
    span = generate(trainer._ema(), 4, x_shape=(28, 28, 1), method="tsit5",
                    generator=torch.Generator().manual_seed(3), device="cpu")
    assert span.nfe < dense.nfe and (span.nfe - 2) % 6 == 0
    assert (dense.images.int() - span.images.int()).abs().max() <= 2
    sol = trainer.generate(4, return_solution=True)
    assert sol.nfe == dense.nfe and torch.isfinite(sol.final).all()


@pytest.mark.cuda
def test_sde_rollout_through_the_kernels_matches_the_plain_versions_on_cuda(monkeypatch):
    """The MNIST preset's UNet pair (bf16, random seeded weights) through
    ``FlowSolver.sdeint`` on the card: 16 images, 20 Euler-Maruyama steps,
    the same noise, through the GroupNorm kernels (#8, 2 x 27 launches a
    step, nothing else) and through the plain versions: the final states
    within 2e-2 of their max-abs, the KL within 2e-2 relative."""
    if not torch.cuda.is_available():
        pytest.skip("the kernels run only on a CUDA device")
    from cfm_tpu_torch.integrate import FlowSolver, vector_field_from_model
    from cfm_tpu_torch.models import unet as tunet
    from cfm_tpu_torch.ops import groupnorm as tgn

    cfg = dict(dim=(28, 28, 1), num_channels=32, num_res_blocks=1, num_heads=1,
               num_head_channels=-1, attention_resolutions="14")
    heads = []
    for seed in (51, 52):
        m = tunet.UNetModelWrapper(**cfg, dtype=torch.bfloat16, seed=seed, device="cpu")
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        heads.append(m.cuda())
    solver = FlowSolver(drift=vector_field_from_model(heads[0]),
                        score=vector_field_from_model(heads[1]), sigma=1.0)
    g = torch.Generator().manual_seed(53)
    x0 = torch.randn((16, 28, 28, 1), generator=g).cuda()
    noise = [torch.randn((16, 28, 28, 1), generator=g).cuda() for _ in range(20)]
    ts = np.linspace(0.0, 1.0, 21, dtype=np.float32)
    before = tgn.fused_group_norm_silu.launches
    with torch.inference_mode():
        kern = solver.sdeint(None, x0, ts, noise=noise, logqp=True, return_trajectory=False)
    assert tgn.fused_group_norm_silu.launches - before == 2 * 27 * 20
    monkeypatch.setattr(tunet, "fused_group_norm_silu", tgn.gn_silu_reference)
    with torch.inference_mode():
        plain = solver.sdeint(None, x0, ts, noise=noise, logqp=True, return_trajectory=False)
    scale = plain.final.abs().max().item()
    assert (kern.final - plain.final).abs().max().item() <= 2e-2 * scale
    assert ((kern.logqp - plain.logqp).abs().max() / plain.logqp.abs().max()).item() <= 2e-2
