"""The port's harness (cfm_tpu_torch/config.py, trainer.py, train_cifar10.py,
train_mnist.py) on the CPU, at a tiny configuration: it trains with finite
losses, unconditionally and class-conditionally, generates from the EMA
parameters, refuses what is not ported yet (the mesh, checkpoints,
evaluation, other presets and matchers), and nothing runs on the CPU unless
asked for.
"""

import numpy as np
import pytest
import torch

from cfm_tpu_torch import config as tcfg
from cfm_tpu_torch import trainer as ttrn
from cfm_tpu_torch.device import resolve_device

TINY = ["model.num_channels=16", "model.channel_mult=(1, 2)", "model.num_res_blocks=1",
        "model.num_head_channels=32", "data.batch_size=4", "trainer.log_interval=1"]
# The MNIST preset's UNet one level shallower: 32 and 64 channels, 1 and 2
# per group (with one channel per group, GroupNorm removes the per-channel
# time and class embedding, so the label acts only from 64 channels on).
TINY_MNIST = ["model.num_channels=32", "model.channel_mult=(1, 2)", "data.batch_size=4",
              "trainer.log_interval=1", "model.bf16=False"]


def test_config_presets_and_overrides_match_jax():
    from cfm_tpu.config import load_config as jload

    for name in ("cifar10_icfm", "cifar10_otcfm", "mnist_icfm", "mnist_otcfm",
                 "mnist_otcfm_cond"):
        cfg, ref = tcfg.load_config(name), jload(name)
        assert cfg.name == ref.name
        for group in ("model", "matcher", "data", "optim", "trainer", "eval"):
            for field, value in getattr(cfg, group).__dict__.items():
                assert value == getattr(getattr(ref, group), field), (name, group, field)
    cfg = tcfg.load_config("cifar10_otcfm", ["optim.lr=1", "model.channel_mult=[1, 2]",
                                             "model.bf16=false", "data.data_dir=elsewhere"])
    assert cfg.optim.lr == 1.0 and isinstance(cfg.optim.lr, float)
    assert cfg.model.channel_mult == (1, 2) and cfg.model.bf16 is False
    assert cfg.data.data_dir == "elsewhere"
    with pytest.raises(AttributeError):
        tcfg.load_config("cifar10_otcfm", ["model.no_such_field=1"])
    with pytest.raises(ValueError):
        tcfg.load_config("cifar10_otcfm", ["optim.lr"])
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tcfg.load_config("2d_otcfm")
    for name in ("mnist_fm", "mnist_sbcfm", "mnist_vpcfm"):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            tcfg.load_config(name)


@pytest.mark.parametrize("matcher", ["otcfm", "icfm"])
def test_trainer_runs_two_steps_on_the_cpu(matcher, capsys):
    cfg = tcfg.load_config(f"cifar10_{matcher}", TINY + ["model.bf16=False"])
    trainer = ttrn.Trainer(cfg, device="cpu")
    before = [p.detach().clone() for p in trainer.state.params]
    state = trainer.fit(2)
    assert state.step == 2 and state.opt_state.count == 2
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params))
    assert all(not torch.equal(a, b) for a, b in zip(state.ema_params, state.params)
               if a.numel() > 1 and not torch.equal(a, b))


def test_trainer_streams_host_batches():
    cfg = tcfg.load_config("cifar10_otcfm", TINY + ["data.on_device=False", "model.dropout=0.0"])
    trainer = ttrn.Trainer(cfg, device="cpu")
    assert trainer._device_data is None
    assert trainer.fit(1).step == 1


def test_trainer_refuses_what_is_not_ported(monkeypatch):
    cfg = tcfg.load_config("cifar10_otcfm", TINY + ["trainer.ckpt_interval=2"])
    trainer = ttrn.Trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint falls due at step 2"):
        trainer.fit(3)
    assert trainer.state.step == 0
    trainer.fit(1)
    cfg.trainer.ckpt_interval, cfg.trainer.eval_interval = 0, 3
    with pytest.raises(NotImplementedError, match="evaluation falls due at step 3"):
        trainer.fit(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="data-parallel mesh"):
        ttrn.Trainer(tcfg.load_config("cifar10_otcfm", TINY), device="cpu")
    for override, error, match in (
            (["matcher.kind='fm'"], NotImplementedError, "queue 1 item 6"),
            (["model.class_cond=True", "matcher.kind='icfm'"], ValueError,
             "class-conditional training needs a coupled matcher"),
            (["data.dataset='moons'"], NotImplementedError, "2-D branch")):
        cfg = tcfg.load_config("cifar10_otcfm", TINY + ["trainer.data_parallel=False"] + override)
        with pytest.raises(error, match=match):
            ttrn.Trainer(cfg, device="cpu")


def test_resolve_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrn.Trainer(tcfg.load_config("cifar10_otcfm", TINY + ["trainer.data_parallel=False"]))
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_cifar10_entry_point(capsys):
    from cfm_tpu_torch import train_cifar10

    args = ["--model", "otcfm", "--synthetic", "--total_steps", "2", "--batch_size", "4",
            "--device", "cpu", "--no_bf16"] + [a for o in TINY[:4] for a in ("--override", o)]
    trainer = train_cifar10.main(args)
    assert trainer.state.step == 2 and trainer.cfg.name == "cifar10_otcfm"
    assert "using synthetic data" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        train_cifar10.main(["--model", "fm", "--device", "cpu"])


@pytest.mark.parametrize("on_device", [True, False])
def test_trainer_runs_mnist_otcfm_cond_and_generates_by_label(on_device, capsys):
    """Two class-conditional OT-CFM steps with finite losses, the labels
    gathered with the images on the device or streamed with them; then
    generation from the EMA parameters gives other images for other labels
    from the same noise, and the same images for the same ones. (A large
    step and EMA decay 0, so that two steps move the zero-initialised
    output conv away from 0.)"""
    cfg = tcfg.load_config("mnist_otcfm_cond", TINY_MNIST + [
        f"data.on_device={on_device}", "optim.lr=1e-2", "optim.warmup_steps=1",
        "optim.ema_decay=0.0"])
    trainer = ttrn.Trainer(cfg, device="cpu")
    assert trainer.model.num_classes == 10 and cfg.eval.ode_method == "euler"
    assert (trainer._device_labels is not None) == on_device
    state = trainer.fit(2)
    losses = [float(line.split()[3]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("step")]
    assert state.step == 2 and len(losses) == 2 and all(np.isfinite(losses))
    out = {}
    for label in (0, 3, 3):
        gen = torch.Generator().manual_seed(5)
        out.setdefault(label, []).append(trainer.generate(
            4, n_steps=2, y=torch.full((4,), label), generator=gen))
    a, b, c = out[0][0], out[3][0], out[3][1]
    assert a.images.shape == (4, 28, 28, 1) and a.images.dtype == torch.uint8 and a.nfe == 2
    assert torch.equal(b.images, c.images) and not torch.equal(a.images, b.images)
    ema = [p for p in trainer._ema_model.parameters()]
    assert all(torch.equal(p, e) for p, e in zip(ema, state.ema_params))


def test_train_mnist_entry_point(tmp_path, capsys):
    """``train_mnist.py --conditional --synthetic`` at a tiny size: trains,
    then saves 80 uint8 samples, 8 per class; --sde and the matchers that
    are not ported raise."""
    from cfm_tpu_torch import train_mnist

    args = ["--conditional", "--synthetic", "--steps", "2", "--batch_size", "4", "--device",
            "cpu", "--output_dir", str(tmp_path)] + [
        a for o in TINY_MNIST[:2] + ["model.bf16=False", "eval.ode_steps=2"]
        for a in ("--override", o)]
    trainer = train_mnist.main(args)
    assert trainer.state.step == 2 and trainer.cfg.name == "mnist_otcfm_cond"
    samples = np.load(tmp_path / "mnist_samples.npy")
    assert samples.shape == (80, 28, 28, 1) and samples.dtype == np.uint8
    assert "saved 80 samples (NFE 2)" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        train_mnist.main(["--sde", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        train_mnist.main(["--matcher", "sbcfm", "--device", "cpu"])
