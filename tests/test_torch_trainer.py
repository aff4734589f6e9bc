"""The port's harness (cfm_tpu_torch/config.py, trainer.py, train_cifar10.py)
on the CPU, at a tiny configuration: it trains with finite losses, it
refuses what is not ported yet (the mesh, checkpoints, evaluation, other
presets and matchers), and nothing runs on the CPU unless asked for.
"""

import pytest
import torch

from cfm_tpu_torch import config as tcfg
from cfm_tpu_torch import trainer as ttrn
from cfm_tpu_torch.device import resolve_device

TINY = ["model.num_channels=16", "model.channel_mult=(1, 2)", "model.num_res_blocks=1",
        "model.num_head_channels=32", "data.batch_size=4", "trainer.log_interval=1"]


def test_config_presets_and_overrides_match_jax():
    from cfm_tpu.config import load_config as jload

    for name in ("cifar10_icfm", "cifar10_otcfm"):
        cfg, ref = tcfg.load_config(name), jload(name)
        for group in ("model", "matcher", "data", "optim", "trainer"):
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
    for override, match in ((["matcher.kind='fm'"], "queue 1 item 6"),
                            (["model.class_cond=True"], "class-conditional"),
                            (["data.dataset='moons'"], "2-D branch")):
        cfg = tcfg.load_config("cifar10_otcfm", TINY + ["trainer.data_parallel=False"] + override)
        with pytest.raises(NotImplementedError, match=match):
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
