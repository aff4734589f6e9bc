"""The port's train step, optimizer recipe and image data (cfm_tpu_torch/train.py,
data/images.py) against JAX.

- The warmup schedule equals JAX's; twenty optimizer updates on fixed
  gradients, one set below and one above the clip, match the optax chain.
- One full train step of a small UNet in f32, with its draws (t, eps and the
  plan uniforms) handed to both sides and dropout off, matches the same step
  composed from the JAX package's pieces: ``get_map`` and the inverse-CDF
  plan sampling, ``model.apply``, ``jax.value_and_grad``,
  ``make_optimizer(...).update``, ``optax.apply_updates`` and ``ema_update``,
  with ``pallas_attn_block.INTERPRET = True`` so that JAX runs kernels #1
  and #2.
- One class-conditional OT-CFM step of a small MNIST-shaped UNet in f32
  matches the JAX step composed from ``guided_sample_location_and_conditional_flow``
  (its plan uniforms, t and path noise handed to the port), ``model.apply``
  with the re-paired labels, ``jax.value_and_grad``, the optax chain and
  ``ema_update``.
- The synthetic sets are byte-equal, ``normalize_images`` and
  ``random_hflip`` (given the same flip bits) equal.
"""

import numpy as np
import pytest
import torch

from cfm_tpu_torch import train as ttr
from cfm_tpu_torch.data import images as tim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# A UNet small enough for interpret mode whose 8x8 attention (C=128, 2 heads
# of 64) passes the fused-block gate, so both kernels are on its path.
TINY = dict(dim=(16, 16, 3), num_channels=32, num_res_blocks=1, channel_mult=(1, 4),
            num_heads=2, num_head_channels=64, attention_resolutions="8")


def test_warmup_lr_schedule_matches_jax():
    from cfm_tpu.train import warmup_lr_schedule

    for warmup in (5, 0):
        ref, out = warmup_lr_schedule(2e-4, warmup), ttr.warmup_lr_schedule(2e-4, warmup)
        for step in range(12):
            assert out(step) == float(ref(step)), (warmup, step)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax(grad_scale, weight_decay):
    """Twenty updates on fixed gradients whose global norm is below (1e-3)
    or above (10) the clip, to 1e-6 (relative to 1 for the parameters,
    which move by about lr per update)."""
    import jax.numpy as jnp
    import optax

    from cfm_tpu.train import make_optimizer

    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = [(grad_scale * rng.standard_normal(s) / 3).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, warmup_steps=5, grad_clip=1.0, weight_decay=weight_decay)
    jopt = make_optimizer(**kw)
    jp = [jnp.asarray(a) for a in p0]
    jstate = jopt.init(jp)
    topt = ttr.make_optimizer(**kw)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tstate = topt.init(tp)
    for _ in range(20):
        upd, jstate = jopt.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.apply(tp, [torch.from_numpy(a) for a in g], tstate)
    np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(a) for a in g])),
                               rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    assert tstate.count == 20


def _jax_step(params, m, x0, x1, t, plan_u, lr, warmup, decay):
    """The JAX package's step, composed from its pieces, with given draws."""
    import jax
    import jax.numpy as jnp
    import optax

    from cfm_tpu.coupling import OTPlanSampler
    from cfm_tpu.train import make_optimizer
    from cfm_tpu.utils import ema_update

    n = x0.shape[0]
    pi = OTPlanSampler("exact").get_map(jnp.asarray(x0), jnp.asarray(x1))
    cdf = jnp.cumsum(pi.reshape(-1))
    choices = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(plan_u) * cdf[-1], side="right"),
                       0, n * n - 1)
    a, b = jnp.asarray(x0)[choices // n], jnp.asarray(x1)[choices % n]
    tj = jnp.asarray(t)[:, None, None, None]
    xt, ut = tj * b + (1 - tj) * a, b - a

    def loss_fn(p):
        return jnp.mean(jnp.square(m.apply({"params": p}, jnp.asarray(t), xt) - ut))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    opt = make_optimizer(lr=lr, warmup_steps=warmup, grad_clip=1.0)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, updates)
    return (float(loss), float(optax.global_norm(grads)), grads, new,
            ema_update(params, new, decay))


def test_train_step_matches_jax_step(monkeypatch):
    """Loss and grad norm to 1e-5 relative; parameters and EMA after the
    step to 1e-5 absolute (they are O(1), and the first Adam step moves each
    by about lr/warmup = 2e-4).

    Adam's first step moves an element by lr/warmup * g / (|g| + 1e-8),
    about +-lr/warmup whatever |g| is, so where a gradient is at the level of
    f32 rounding noise the two sides may step either way. Such elements, with
    |g| below 1e-5 of their tensor's max-abs or in a tensor whose max-abs is
    below 1e-6 (biases that feed a GroupNorm that removes them, true gradient
    0), are held only to that bound on the move; they must be under 1% of
    the parameters."""
    from test_torch_unet import random_flax_params

    import jax.numpy as jnp

    from cfm_tpu.models import unet as junet
    from cfm_tpu.ops import pallas_attn_block as pab
    from cfm_tpu_torch.models.convert import unet_params_from_flax
    from cfm_tpu_torch.models.unet import UNetModelWrapper
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher

    monkeypatch.setattr(pab, "INTERPRET", True)
    B, lr, warmup, decay = 4, 1e-3, 5, 0.99
    m = junet.UNetModelWrapper(**TINY)
    params = random_flax_params(m, jnp.zeros((1,)), jnp.zeros((1,) + TINY["dim"]), seed=11)
    rng = np.random.default_rng(12)
    x0 = rng.standard_normal((B,) + TINY["dim"]).astype(np.float32)
    x1 = np.tanh(rng.standard_normal((B,) + TINY["dim"])).astype(np.float32)
    t, plan_u = rng.uniform(size=B).astype(np.float32), rng.uniform(size=B).astype(np.float32)
    loss_ref, gnorm_ref, g_ref, new_ref, ema_ref = _jax_step(params, m, x0, x1, t, plan_u, lr,
                                                             warmup, decay)

    model = UNetModelWrapper(**TINY, device="cpu")
    model.load_state_dict(unet_params_from_flax(params))
    opt = ttr.make_optimizer(lr=lr, warmup_steps=warmup, grad_clip=1.0)
    state = ttr.init_train_state(model, opt)
    step = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(), model, opt,
                               ema_decay=decay)
    draws = ttr.StepDraws(torch.from_numpy(t), torch.zeros(x0.shape), torch.from_numpy(plan_u))
    metrics = step(state, torch.from_numpy(x0), torch.from_numpy(x1), draws=draws)
    assert set(metrics) == {"loss", "flow_loss", "coupling_degenerate", "grad_norm"}
    assert float(metrics["coupling_degenerate"]) == 0.0 and state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), loss_ref, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), gnorm_ref, rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    old_sd, g_sd = unet_params_from_flax(params), unet_params_from_flax(g_ref)
    new_sd, ema_sd = unet_params_from_flax(new_ref), unet_params_from_flax(ema_ref)
    n_noise = 0
    for name, p, e in zip(names, state.params, state.ema_params):
        g = g_sd[name].abs()
        noise = (g < 1e-5 * g.max()) | (g.max() < 1e-6)
        n_noise += int(noise.sum())
        move = (p.detach() - old_sd[name]).abs()
        assert bool((move[noise] <= lr / warmup * (1 + 1e-5)).all()), name
        for got, ref in ((p.detach(), new_sd[name]), (e, ema_sd[name])):
            np.testing.assert_allclose(got[~noise].numpy(), ref[~noise].numpy(), atol=1e-5,
                                       err_msg=name)
    assert n_noise < 0.01 * sum(p.numel() for p in state.params)


# The MNIST preset's UNet one level shallower (28x28x1, 32 and 64 channels,
# attention at 14x14 on the composition path) with the 10-class embedding.
MNIST = dict(dim=(28, 28, 1), num_channels=32, num_res_blocks=1, channel_mult=(1, 2),
             num_heads=1, num_head_channels=-1, attention_resolutions="14", class_cond=True,
             num_classes=10)


def test_class_conditional_step_matches_jax_step():
    """Loss and grad norm to 1e-5 relative, parameters and EMA to 1e-5, at
    sigma = 0.1 so the path noise counts. The labels differ between x0 and
    x1, so the step must carry y1 by the plan's column index.

    As in :func:`test_train_step_matches_jax_step`, elements whose gradient
    is at f32 noise level are held to Adam's bound on the move. Inside
    tensors that carry a gradient (max-abs 1e-6 or more) they must be under
    1% of the parameters; whole tensors at noise level are structural here
    (the time-and-class projections into GroupNorms of one channel per
    group, which remove a per-channel shift: true gradient 0)."""
    _class_conditional_step_case(MNIST, seed=13)


# chip_smoke.py's phase-5 model: the ImageNet-64 UNet's routing at a small
# width (kernels #3 and #4 at 16x16, #1 and #2 at 8x8, the plain composition
# at 4x4), with scale-shift norm and ResBlock up/down sampling.
IMAGENET_SMALL = dict(dim=(16, 16, 3), num_channels=64, channel_mult=(1, 2, 3), num_res_blocks=1,
                      num_head_channels=64, attention_resolutions="16,8,4",
                      use_scale_shift_norm=True, resblock_updown=True, class_cond=True,
                      num_classes=10)


def test_imagenet64_like_class_conditional_step_matches_jax_step(monkeypatch):
    """The step of :func:`test_class_conditional_step_matches_jax_step`, at
    the same tolerances and noise-level rule, on a model whose gradients run
    through kernels #4 and #2: the JAX side runs ``_bwd_kernel`` of both
    Pallas modules in interpret mode, the port their plain transcriptions."""
    from cfm_tpu.ops import pallas_attention as pa
    from cfm_tpu.ops import pallas_attn_block as pab

    monkeypatch.setattr(pa, "INTERPRET", True)
    monkeypatch.setattr(pab, "INTERPRET", True)
    _class_conditional_step_case(IMAGENET_SMALL, seed=16)


def _class_conditional_step_case(cfg, seed):
    import jax
    import jax.numpy as jnp
    import optax

    from cfm_tpu.models import unet as junet
    from cfm_tpu.paths import ExactOptimalTransportConditionalFlowMatcher as JOT
    from cfm_tpu.train import make_optimizer
    from cfm_tpu.utils import ema_update
    from cfm_tpu_torch.models.convert import unet_params_from_flax
    from cfm_tpu_torch.models.unet import UNetModelWrapper
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher
    from test_torch_unet import random_flax_params

    B, lr, warmup, decay, sigma = 4, 1e-3, 5, 0.99, 0.1
    m = junet.UNetModelWrapper(**cfg)
    params = random_flax_params(m, jnp.zeros((1,)), jnp.zeros((1,) + cfg["dim"]),
                                jnp.zeros((1,), jnp.int32), seed=seed)
    rng = np.random.default_rng(seed + 1)
    x0 = rng.standard_normal((B,) + cfg["dim"]).astype(np.float32)
    x1 = np.tanh(rng.standard_normal((B,) + cfg["dim"])).astype(np.float32)
    y0, y1 = np.array([1, 2, 3, 4]), np.array([7, 0, 9, 5])
    t = rng.uniform(size=B).astype(np.float32)
    key = jax.random.PRNGKey(seed + 2)
    tj, xt, ut, _, y1_, eps, bad = JOT(sigma=sigma).guided_sample_location_and_conditional_flow(
        key, *(jnp.asarray(a) for a in (x0, x1, y0, y1)), t=jnp.asarray(t), return_noise=True,
        return_coupling_status=True)
    plan_u = np.asarray(jax.random.uniform(jax.random.split(key)[0], (B,)))

    opt = make_optimizer(lr=lr, warmup_steps=warmup, grad_clip=1.0)

    @jax.jit  # one compiled program: the eager JAX step takes minutes on the CPU
    def jax_step(p):
        loss, grads = jax.value_and_grad(
            lambda q: jnp.mean(jnp.square(m.apply({"params": q}, tj, xt, y1_) - ut)))(p)
        new = optax.apply_updates(p, opt.update(grads, opt.init(p), p)[0])
        return loss, optax.global_norm(grads), grads, new, ema_update(p, new, decay)

    loss_ref, gnorm_ref, g_ref, new_ref, ema_ref = jax_step(params)

    model = UNetModelWrapper(**cfg, device="cpu")
    model.load_state_dict(unet_params_from_flax(params))
    topt = ttr.make_optimizer(lr=lr, warmup_steps=warmup, grad_clip=1.0)
    state = ttr.init_train_state(model, topt)
    step = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(sigma=sigma), model,
                               topt, ema_decay=decay, class_conditional=True)
    draws = ttr.StepDraws(torch.from_numpy(t), torch.from_numpy(np.asarray(eps)),
                          torch.from_numpy(plan_u))
    metrics = step(state, torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(y0),
                   torch.from_numpy(y1), draws=draws)
    assert not bool(bad) and float(metrics["coupling_degenerate"]) == 0.0
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(gnorm_ref), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    old_sd, g_sd = unet_params_from_flax(params), unet_params_from_flax(g_ref)
    new_sd, ema_sd = unet_params_from_flax(new_ref), unet_params_from_flax(ema_ref)
    n_noise = 0
    for name, p, e in zip(names, state.params, state.ema_params):
        g = g_sd[name].abs()
        noise = (g < 1e-5 * g.max()) | (g.max() < 1e-6)
        n_noise += int(noise.sum()) if g.max() >= 1e-6 else 0
        move = (p.detach() - old_sd[name]).abs()
        assert bool((move[noise] <= lr / warmup * (1 + 1e-5)).all()), name
        for got, ref in ((p.detach(), new_sd[name]), (e, ema_sd[name])):
            np.testing.assert_allclose(got[~noise].numpy(), ref[~noise].numpy(), atol=1e-5,
                                       err_msg=name)
    assert n_noise < 0.01 * sum(p.numel() for p in state.params)


def test_train_step_draws_from_the_generator_and_runs_dropout():
    """With a generator and dropout the step runs on the CPU, its draws come
    from the generator in a fixed order (two runs from the same seed agree),
    and the metrics stay device tensors."""
    from cfm_tpu_torch.models.unet import UNetModelWrapper
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher

    cfg = dict(TINY, num_channels=16, num_head_channels=32, channel_mult=(1, 2))
    rng = np.random.default_rng(13)
    x0, x1 = (torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
              for _ in range(2))
    out = []
    for _ in range(2):
        model = UNetModelWrapper(**cfg, dropout=0.1, device="cpu", seed=1)
        opt = ttr.make_optimizer(lr=1e-3, warmup_steps=2)
        state = ttr.init_train_state(model, opt)
        step = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(), model, opt,
                                   train_mode=True)
        g = torch.Generator().manual_seed(3)
        metrics = [step(state, x0, x1, generator=g) for _ in range(2)]
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in metrics[-1].values())
        out.append((metrics, [p.detach().clone() for p in state.params]))
    for a, b in zip(out[0][0], out[1][0]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert not torch.equal(out[0][0][0]["loss"], out[0][0][1]["loss"])


def test_ema_starts_as_a_copy():
    model = torch.nn.Linear(3, 2)
    state = ttr.init_train_state(model, ttr.make_optimizer())
    assert all(torch.equal(e, p) and e.data_ptr() != p.data_ptr()
               for e, p in zip(state.ema_params, state.params))


@pytest.mark.parametrize("name", ["cifar10", "mnist"])
def test_synthetic_sets_are_byte_equal(name):
    from cfm_tpu.data import images as jim

    for seed in (0, 3):
        x, y = getattr(tim, f"load_{name}")(synthetic=True, seed=seed)
        xr, yr = getattr(jim, f"load_{name}")(synthetic=True, seed=seed)
        assert x.dtype == np.uint8 and x.tobytes() == xr.tobytes()
        np.testing.assert_array_equal(y, yr)
    with pytest.raises(FileNotFoundError):
        getattr(tim, f"load_{name}")("no_such_dir")


def test_normalize_and_flip_match_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from cfm_tpu.data import images as jim

    x, _ = tim.load_cifar10(synthetic=True)
    x = x[:8]
    ref = np.asarray(jim.normalize_images(jnp.asarray(x)))
    out = tim.normalize_images(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    flip = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(flip))
    ref_f = np.asarray(jim.random_hflip(jax.random.PRNGKey(0), jnp.asarray(ref)))
    out_f = tim.random_hflip(None, out, flip=torch.from_numpy(flip))
    np.testing.assert_array_equal(out_f.numpy(), ref_f)
    g = torch.Generator().manual_seed(0)
    drawn = tim.random_hflip(g, out)
    assert all(torch.equal(drawn[i], out[i]) or torch.equal(drawn[i], out[i].flip(1))
               for i in range(8))


def test_infinite_batches_cover_the_set_each_epoch():
    data = np.arange(10, dtype=np.uint8)[:, None]
    it = tim.infinite_batches(data, None, 5, seed=0)
    epoch = np.concatenate([next(it), next(it)])
    assert sorted(epoch[:, 0].tolist()) == list(range(10))
    with pytest.raises(ValueError, match="exceeds"):
        next(tim.infinite_batches(data, None, 11))
