"""UNet activation checkpointing in the port (``use_checkpoint``,
``checkpoint_policy``; cfm_tpu_torch/models/unet.py) on the CPU.

- One train step with dropout 0.1 (masks from an explicit generator) under
  each policy JAX accepts (None, "dots", "dots_no_batch") equals the
  unwrapped step bit for bit: the loss, every gradient, the updated
  parameters and the generator's state after the step. Two models: one
  that routes like the CIFAR-10 recipe (the fused attention block at 8x8,
  the composition at 4x4), one like ImageNet-64 (the multi-head attention
  Function at 16x16, the fused block at 8x8, the composition at 4x4,
  scale-shift norm, ResBlock up/down, class labels), in bfloat16 (and the
  first in float32).
- The backward does recompute: the GroupNorm forward runs again for every
  GroupNorm inside a wrapped block, and the dropout masks are drawn again
  from the generator's state at each block's start.
- The ``state_dict`` keys do not change, so checkpoints and ``convert.py``
  serve both settings; a JAX UNet built with ``use_checkpoint=True`` (and
  each policy) gives the port's forward.
- A ``Trainer`` with ``model.use_checkpoint=True`` trains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu_torch import train as ttr
from cfm_tpu_torch.models import unet as tunet
from cfm_tpu_torch.ops import groupnorm as tgn
from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher

POLICIES = [None, "dots", "dots_no_batch"]
CIFAR_LIKE = dict(dim=(16, 16, 3), num_channels=64, num_res_blocks=1, channel_mult=(1, 2, 2),
                  num_heads=4, num_head_channels=64, attention_resolutions="8")
IMAGENET_LIKE = dict(dim=(16, 16, 3), num_channels=64, channel_mult=(1, 2, 3), num_res_blocks=1,
                     num_head_channels=64, attention_resolutions="16,8,4",
                     use_scale_shift_norm=True, resblock_updown=True, class_cond=True,
                     num_classes=10)
CONFIGS = {"cifar_like": CIFAR_LIKE, "imagenet_like": IMAGENET_LIKE}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU models: the suite runs
    six workers on the machine's cores, and torch's OpenMP pool of one
    thread a core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(cfg, dtype, device="cpu", **kw):
    """The configuration with dropout 0.1 and every parameter randomised
    (the zero-initialised output layers included), from fixed seeds."""
    model = tunet.UNetModelWrapper(**cfg, dropout=0.1, dtype=dtype, seed=4, device="cpu", **kw)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model.to(device)


def _step(cfg, dtype, device="cpu", batch=2, **kw):
    """One OT-CFM train step with fixed inputs and draws; returns the loss,
    the gradients, the updated parameters, the dropout generator's state
    after the step, the state_dict keys and the model."""
    model = _model(cfg, dtype, device, **kw)
    rng = np.random.default_rng(6)
    x0, x1, eps = (torch.from_numpy(rng.standard_normal((batch,) + cfg["dim"]).astype(
        np.float32)).to(device) for _ in range(3))
    t, u = (torch.from_numpy(rng.uniform(size=batch).astype(np.float32)).to(device)
            for _ in range(2))
    labels = ((torch.arange(batch, device=device) % 10,) * 2 if cfg.get("class_cond") else ())
    opt = ttr.make_optimizer(lr=1e-3, warmup_steps=1)
    state = ttr.init_train_state(model, opt)
    step = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(solver="pallas"
                                                                           if device == "cuda"
                                                                           else "auto"),
                               model, opt, train_mode=True, class_conditional=bool(labels))
    g = torch.Generator(device=device).manual_seed(8)
    metrics = step(state, x0, x1, *labels, draws=ttr.StepDraws(t, eps, u, g))
    return dict(loss=metrics["loss"], grads=[p.grad for p in state.params],
                params=[p.detach() for p in state.params], generator=g.get_state(),
                keys=list(model.state_dict()), model=model)


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("config,dtype", [("cifar_like", "float32"), ("cifar_like", "bfloat16"),
                                          ("imagenet_like", "bfloat16")])
def test_checkpointed_step_equals_the_plain_step_bit_for_bit(config, dtype):
    cfg, dt = CONFIGS[config], getattr(torch, dtype)
    plain = _step(cfg, dt)
    assert not plain["model"].use_checkpoint
    for policy in POLICIES:
        run = _step(cfg, dt, use_checkpoint=True, checkpoint_policy=policy)
        assert run["model"].use_checkpoint and run["model"].checkpoint_policy == policy
        assert run["keys"] == plain["keys"], policy
        assert torch.equal(_bits(run["loss"]), _bits(plain["loss"])), policy
        assert torch.equal(run["generator"], plain["generator"]), policy
        for what in ("grads", "params"):
            for i, (a, b) in enumerate(zip(run[what], plain[what])):
                assert torch.equal(_bits(a), _bits(b)), (policy, what, plain["keys"][i])


@pytest.mark.parametrize("policy", POLICIES)
def test_backward_recomputes_the_blocks_and_replays_their_dropout(policy, monkeypatch):
    """Counting the GroupNorm forward (the plain version's calls on the CPU)
    and the dropout draws: an unwrapped step runs each once; a checkpointed
    one runs every GroupNorm inside a ResBlock or a composed attention block
    once more in the backward (all but the output GroupNorm), and redraws
    every ResBlock's mask from the state the forward drew it from, then puts
    the generator back."""
    calls = []
    real_gn = tgn.gn_silu_fwd_reference
    real_drop = tunet.FastDropout.forward

    def counting_gn(x, *a, **kw):
        calls.append(("gn", torch.is_grad_enabled()))
        return real_gn(x, *a, **kw)

    def counting_drop(self, x, train=False, generator=None):
        if train and generator is not None:
            calls.append(("drop", generator.get_state().sum().item()))
        return real_drop(self, x, train, generator)

    monkeypatch.setattr(tgn, "gn_silu_fwd_reference", counting_gn)
    monkeypatch.setattr(tunet.FastDropout, "forward", counting_drop)
    counts = {}
    for checkpointed in (False, True):
        calls.clear()
        _step(CIFAR_LIKE, torch.float32, use_checkpoint=checkpointed, checkpoint_policy=policy)
        counts[checkpointed] = list(calls)
    model = _model(CIFAR_LIKE, torch.float32)
    n_res = sum(isinstance(m, tunet.ResBlock) for m in model.modules())
    plain_gn = [c for c in counts[False] if c[0] == "gn"]
    plain_drop = [c for c in counts[False] if c[0] == "drop"]
    assert len(plain_drop) == n_res
    # Each ResBlock's two GroupNorms, the composed mid_attn's and the
    # output's (the fused blocks' GroupNorm is part of their Function).
    assert len(plain_gn) == 2 * n_res + 2
    ck_gn = [c for c in counts[True] if c[0] == "gn"]
    ck_drop = [c for c in counts[True] if c[0] == "drop"]
    assert len(ck_gn) == len(plain_gn) + len(plain_gn) - 1
    assert len(ck_drop) == 2 * n_res
    # The recompute's draws start from the forward's states, in reverse order.
    assert sorted(ck_drop[n_res:]) == sorted(ck_drop[:n_res]) == sorted(plain_drop)


def test_checkpoint_policy_is_checked():
    with pytest.raises(ValueError, match="Unknown checkpoint_policy"):
        tunet.UNetModelWrapper(**CIFAR_LIKE, use_checkpoint=True, checkpoint_policy="all",
                               device="cpu")


# A tiny UNet whose attention takes the composition in both packages (no
# Pallas interpret run), with scale-shift norm and ResBlock up/down.
TINY = dict(dim=(8, 8, 3), num_channels=16, num_res_blocks=1, channel_mult=(1, 2),
            num_head_channels=8, attention_resolutions="4", use_scale_shift_norm=True,
            resblock_updown=True)


@pytest.mark.parametrize("policy", POLICIES)
def test_forward_matches_a_checkpointed_flax_unet(policy):
    """A JAX ``UNetModelWrapper(use_checkpoint=True, checkpoint_policy=...)``
    (``nn.remat`` around each block, its scopes named for interchangeable
    checkpoints) takes the same converted parameters and gives the port's
    checkpointed forward, f32 at 1e-4 of the output's scale (summation
    order), with a gradient wanted so that the port's blocks are wrapped."""
    from cfm_tpu.models import unet as junet
    from cfm_tpu_torch.models.convert import unet_params_from_flax
    from test_torch_unet import random_flax_params

    m = junet.UNetModelWrapper(**TINY, use_checkpoint=True, checkpoint_policy=policy)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([0.2, 0.7], np.float32)
    params = random_flax_params(m, jnp.asarray(t), jnp.asarray(x), seed=3)
    ref = np.asarray(jax.jit(m.apply)({"params": params}, jnp.asarray(t), jnp.asarray(x)))
    model = tunet.UNetModelWrapper(**TINY, use_checkpoint=True, checkpoint_policy=policy,
                                   device="cpu")
    model.load_state_dict(unet_params_from_flax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = model(torch.from_numpy(t), xt)
    assert y.requires_grad
    scale = np.abs(ref).max()
    np.testing.assert_allclose(y.detach().numpy() / scale, ref / scale, atol=1e-4, rtol=1e-4)


def test_trainer_trains_with_use_checkpoint(tmp_path):
    """``model.use_checkpoint=True``, refused before, builds a checkpointed
    UNet under every policy; two steps of ``cifar10_otcfm`` (dropout 0.1)
    from the same seed give the unwrapped run's parameters bit for bit."""
    from cfm_tpu_torch import config as tcfg
    from cfm_tpu_torch import trainer as ttrn

    tiny = ["model.num_channels=16", "model.channel_mult=(1, 2)", "model.num_res_blocks=1",
            "model.num_head_channels=32", "data.batch_size=4", "trainer.log_interval=1",
            "model.bf16=False", "trainer.ckpt_interval=0"]
    runs = {}
    for policy in ("off",) + tuple(POLICIES):
        extra = [] if policy == "off" else ["model.use_checkpoint=True",
                                            f"model.checkpoint_policy={policy!r}"]
        cfg = tcfg.load_config("cifar10_otcfm", tiny + extra
                               + [f"trainer.ckpt_dir={tmp_path / str(policy)}"])
        trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
        assert trainer.model.use_checkpoint == (policy != "off")
        trainer.fit(2)
        runs[policy] = [p.detach().clone() for p in trainer.state.params]
    for policy in POLICIES:
        assert all(torch.equal(a, b) for a, b in zip(runs[policy], runs["off"])), policy


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_checkpointed_step_on_cuda_equals_the_plain_step_bit_for_bit(config):
    """On the card, bf16, batch 8, under ``cudnn.deterministic``: every
    policy's step gives the unwrapped step's loss, gradients, parameters
    and generator state bit for bit, and launches each forward kernel of a
    wrapped block twice (#1 and #3 twice, #8 twice but for the output
    GroupNorm) and each backward kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("the kernels run only on a CUDA device")
    from cfm_tpu_torch.ops import attention as tat
    from cfm_tpu_torch.ops import attn_block as tab

    fns = (tab.fused_attention_block, tab.fused_attention_block_bwd, tat.attention_t,
           tat.attention_t_bwd, tgn.fused_group_norm_silu, tgn.fused_group_norm_silu_bwd)
    cfg, prev = CONFIGS[config], torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts = {}
        for policy in ("off",) + tuple(POLICIES):
            kw = {} if policy == "off" else dict(use_checkpoint=True, checkpoint_policy=policy)
            before = [f.launches for f in fns]
            run = _step(cfg, torch.bfloat16, "cuda", batch=8, **kw)
            torch.cuda.synchronize()
            counts[policy] = [f.launches - b for f, b in zip(fns, before)]
            if policy == "off":
                plain = run
                continue
            assert torch.equal(_bits(run["loss"]), _bits(plain["loss"])), policy
            assert torch.equal(run["generator"], plain["generator"]), policy
            for what in ("grads", "params"):
                for i, (a, b) in enumerate(zip(run[what], plain[what])):
                    assert torch.equal(_bits(a), _bits(b)), (policy, what, plain["keys"][i])
    finally:
        torch.backends.cudnn.deterministic = prev
    ab_f, ab_b, at_f, at_b, gn_f, gn_b = counts["off"]
    assert ab_f == ab_b > 0 and at_f == at_b and gn_f == gn_b > 0
    assert config == "cifar_like" or at_f > 0
    for policy in POLICIES:
        assert counts[policy] == [2 * ab_f, ab_b, 2 * at_f, at_b, 2 * gn_f - 1, gn_b], policy
