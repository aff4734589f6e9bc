"""The port's harness (cfm_tpu_torch/config.py, trainer.py, train_cifar10.py,
train_mnist.py) on the CPU, at a tiny configuration: it trains with finite
losses, unconditionally and class-conditionally, generates from the EMA
parameters, saves checkpoints and evaluates when they fall due, refuses
what is not ported yet (the mesh) and unknown sets, and nothing runs on the
CPU unless asked for. Every Trainer
writes its checkpoints and logs under the test's own temporary directory.
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
    """The test's own checkpoint directory, as an override."""
    return [f"trainer.ckpt_dir={tmp_path / 'ckpt'}"]


def test_config_presets_and_overrides_match_jax():
    from cfm_tpu.config import available_presets
    from cfm_tpu.config import load_config as jload

    assert tcfg.available_presets() == available_presets()
    for name in tcfg.available_presets():
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
    # YAML files, refused before the harness was ported, load as JAX's do.
    for path in ("configs/experiment/2d_icfm_quick.yaml", "configs/experiment/mnist_cond.yaml"):
        assert tcfg.load_config(path, ["optim.lr=1e-3"]).to_dict() == jload(
            path, ["optim.lr=1e-3"]).to_dict()
    with pytest.raises(FileNotFoundError):
        tcfg.load_config("configs/2d_otcfm.yaml")
    # 2d_sf2m, refused before the score head was ported, loads as JAX's does,
    # and takes the entropic coupling at batch 2048 by override.
    cfg = tcfg.load_config("2d_sf2m", ["matcher.ot_method=sinkhorn", "data.batch_size=2048"])
    ref = jload("2d_sf2m", ["matcher.ot_method=sinkhorn", "data.batch_size=2048"])
    assert cfg.matcher.__dict__ == ref.matcher.__dict__ and cfg.data.__dict__ == ref.data.__dict__
    assert cfg.eval.sde is ref.eval.sde is False


@pytest.mark.parametrize("matcher", ["otcfm", "icfm"])
def test_trainer_runs_two_steps_on_the_cpu(matcher, capsys, tmp_path):
    cfg = tcfg.load_config(f"cifar10_{matcher}", TINY + ["model.bf16=False"] + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    before = [p.detach().clone() for p in trainer.state.params]
    state = trainer.fit(2)
    assert state.step == 2 and state.opt_state.count == 2
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    assert any(not torch.equal(a, b) for a, b in zip(before, state.params))
    assert all(not torch.equal(a, b) for a, b in zip(state.ema_params, state.params)
               if a.numel() > 1 and not torch.equal(a, b))


def test_trainer_streams_host_batches(tmp_path):
    cfg = tcfg.load_config("cifar10_otcfm", TINY + ["data.on_device=False", "model.dropout=0.0"]
                           + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    assert trainer._device_data is None
    assert trainer.fit(1).step == 1


def test_trainer_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """A checkpoint and an evaluation falling due, refused before the harness
    and the image evaluation were ported, now run, and so do SDE evaluation,
    activation checkpointing and ``trainer.data_parallel`` with several
    cards (without a process group of more than one rank, one process
    trains alone; tests/test_torch_parallel.py runs two ranks);
    class-conditional I-CFM still refuses."""
    cfg = tcfg.load_config("cifar10_otcfm", TINY + ["trainer.ckpt_interval=2",
                                                    "eval.num_eval_samples=8",
                                                    "eval.ode_method=euler",
                                                    "eval.ode_steps=2"] + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    assert trainer.fit(3).step == 3
    assert trainer.ckpt.all_steps() == [2, 3]  # due at 2, the final save at 3
    cfg.trainer.ckpt_interval, cfg.trainer.eval_interval = 0, 4
    trainer.fit(4)
    assert [e["step"] for e in trainer.eval_log] == [4]
    assert set(trainer.eval_log[0]) == {"step", "gen_mean", "gen_std", "nfe", "tracking_fid",
                                        "seconds"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    alone = ttrn.Trainer(tcfg.load_config("cifar10_otcfm", TINY + iso(tmp_path / "alone")),
                         device="cpu", log_dir=str(tmp_path))
    assert alone.cfg.trainer.data_parallel and alone.mesh is None and alone.is_main
    for override in (["matcher.score_head=True", "eval.sde=True"],
                     ["model.use_checkpoint=True", "model.checkpoint_policy='dots'"]):
        cfg = tcfg.load_config("cifar10_otcfm", TINY + ["trainer.data_parallel=False"] + override
                               + iso(tmp_path / "lifted"))
        lifted = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
        assert lifted.cfg.eval.sde or lifted.model.use_checkpoint
    for override, error, match in (
            (["model.class_cond=True", "matcher.kind='icfm'"], ValueError,
             "class-conditional training needs a coupled matcher"),
            (["data.dataset='nope'"], ValueError, "Unknown 2D dataset")):
        cfg = tcfg.load_config("cifar10_otcfm", TINY + ["trainer.data_parallel=False"] + override
                               + iso(tmp_path / "refused"))
        with pytest.raises(error, match=match):
            ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))


def test_trainer_trains_a_unet_score_head(tmp_path):
    """With ``matcher.score_head`` on the image branch the score model is a
    second UNet of the same configuration with weights of its own; one step
    reports the score loss and moves both heads."""
    cfg = tcfg.load_config("cifar10_sbcfm", TINY + ["matcher.score_head=True", "model.bf16=False",
                                                    "model.dropout=0.0", "matcher.sigma=0.5"]
                           + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    n_flow = len(list(trainer.model.parameters()))
    assert len(trainer.state.params) == 2 * n_flow
    before = [p.detach().clone() for p in trainer.state.params]
    assert not all(torch.equal(a, b) for a, b in zip(before[:n_flow], before[n_flow:]))
    x0, x1 = trainer._prep(trainer._batch()[0])
    metrics = trainer.step_fn(trainer.state, x0, x1, generator=trainer.generator)
    assert {"loss", "flow_loss", "score_loss", "grad_norm"} <= set(metrics)
    assert torch.isclose(metrics["loss"], metrics["flow_loss"] + metrics["score_loss"])
    moved = [not torch.equal(a, b) for a, b in zip(before, trainer.state.params)]
    assert any(moved[:n_flow]) and any(moved[n_flow:])


def test_resolve_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrn.Trainer(tcfg.load_config("cifar10_otcfm", TINY + ["trainer.data_parallel=False"]
                                      + iso(tmp_path)), log_dir=str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_cifar10_entry_point(capsys, tmp_path):
    """``train_cifar10.py`` trains, and writes its checkpoints and logs under
    ``--output_dir`` as ``examples/train_cifar10.py`` does."""
    from cfm_tpu_torch import train_cifar10

    args = ["--model", "otcfm", "--synthetic", "--total_steps", "2", "--batch_size", "4",
            "--device", "cpu", "--no_bf16", "--output_dir", str(tmp_path)] + [
        a for o in TINY[:4] for a in ("--override", o)]
    trainer = train_cifar10.main(args)
    assert trainer.state.step == 2 and trainer.cfg.name == "cifar10_otcfm"
    assert "using synthetic data" in capsys.readouterr().out
    assert (tmp_path / "checkpoints" / "cifar10_otcfm" / "torch_step_2.pt").exists()
    assert (tmp_path / "logs" / "cifar10_otcfm_metrics.jsonl").exists()
    trainer = train_cifar10.main(["--model", "si", "--synthetic", "--total_steps", "1"] + args[5:])
    assert trainer.state.step == 1 and trainer.cfg.matcher.kind == "vpcfm"


@pytest.mark.parametrize("on_device", [True, False])
def test_trainer_runs_mnist_otcfm_cond_and_generates_by_label(on_device, capsys, tmp_path):
    """Two class-conditional OT-CFM steps with finite losses, the labels
    gathered with the images on the device or streamed with them; then
    generation from the EMA parameters gives other images for other labels
    from the same noise, and the same images for the same ones. (A large
    step and EMA decay 0, so that two steps move the zero-initialised
    output conv away from 0.)"""
    cfg = tcfg.load_config("mnist_otcfm_cond", TINY_MNIST + [
        f"data.on_device={on_device}", "optim.lr=1e-2", "optim.warmup_steps=1",
        "optim.ema_decay=0.0"] + iso(tmp_path))
    trainer = ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path))
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
    then saves 80 uint8 samples, 8 per class, as an array and as a PNG grid
    of 8 a row; another matcher trains. (``--sde``, refused before, is
    driven in ``test_torch_sde.py``.)"""
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
    assert (tmp_path / "mnist_samples.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "checkpoints" / "mnist_otcfm_cond" / "torch_step_2.pt").exists()
    trainer = train_mnist.main(["--matcher", "sbcfm", "--synthetic", "--steps", "1"] + args[4:])
    assert trainer.state.step == 1 and trainer.cfg.name == "mnist_sbcfm"
