"""The port's harness (cfm_tpu_torch/config.py, checkpoint.py, trainer.py's
logs, resumption, debug hooks and image evaluation, tb_events.py, cli.py,
compute_fid.py, sweep.py, profiling.py) on the CPU, against the JAX package
where both have the piece.

- Every preset, every ``configs/experiment/*.yaml`` and every debug overlay
  gives JAX's ``to_dict()`` and ``tree_str()``.
- Checkpoints restore bit for bit (params, EMA, Adam's mu, nu and count,
  the step); a resumed Trainer's next step equals the uninterrupted one's
  bit for bit given the same ``StepDraws``.
- The image evaluation's ``gen_mean``/``gen_std``/``nfe`` equal JAX's given
  the same EMA parameters and noise (1e-5), over the float samples.
- ``expand_grid``, ``run_sweep``, ``random_search`` and ``tpe_search`` give
  JAX's records for a deterministic ``run_fn``.

Every Trainer writes its checkpoints and logs under the test's temporary
directory.
"""

import glob
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from cfm_tpu_torch import checkpoint as tck
from cfm_tpu_torch import config as tcfg
from cfm_tpu_torch import trainer as ttrn
from cfm_tpu_torch.train import StepDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "experiment", "*.yaml")))
# A CIFAR-10 UNet two levels deep, f32, batch 4: the recipe's code paths
# (attention at 16x16, dropout) at a CPU size.
TINY = ["model.num_channels=16", "model.channel_mult=(1, 2)", "model.num_res_blocks=1",
        "model.num_head_channels=32", "model.bf16=False", "data.batch_size=4",
        "trainer.log_interval=1", "trainer.data_parallel=False"]
# The MNIST preset's UNet at 8 channels, one res block.
TINY_MNIST = ["model.num_channels=8", "model.num_res_blocks=1", "model.bf16=False",
              "trainer.data_parallel=False"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tiny CPU models: the suite runs
    six workers on the machine's cores, and torch's OpenMP pool of one
    thread a core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def iso(tmp_path, sub="ckpt"):
    return [f"trainer.ckpt_dir={tmp_path / sub}"]


def _trainer(preset, overrides, tmp_path, **kw):
    cfg = tcfg.load_config(preset, overrides + iso(tmp_path))
    return ttrn.Trainer(cfg, device="cpu", log_dir=str(tmp_path / "logs"), **kw)


# -- configs -----------------------------------------------------------------


@pytest.mark.parametrize("preset", tcfg.available_presets())
def test_preset_matches_jax(preset):
    from cfm_tpu.config import load_config as jload

    cfg, ref = tcfg.load_config(preset), jload(preset)
    assert cfg.to_dict() == ref.to_dict()
    assert cfg.tree_str() == ref.tree_str()


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_experiment_yaml_matches_jax(path):
    from cfm_tpu.config import load_config as jload

    assert tcfg.load_config(path).to_dict() == jload(path).to_dict()
    over = ["optim.lr=5e-4", "trainer.total_steps=7"]
    assert tcfg.load_config(path, over).tree_str() == jload(path, over).tree_str()


@pytest.mark.parametrize("mode", tcfg.DEBUG_MODES)
def test_debug_overlay_matches_jax(mode):
    """``debug=`` applies before the other overrides and ``name=`` before it,
    whatever their order on the command line."""
    from cfm_tpu.config import apply_debug as japply
    from cfm_tpu.config import load_config as jload

    over = ["trainer.log_interval=7", f"debug={mode}", "name=myrun"]
    cfg, ref = tcfg.load_config("cifar10_otcfm", over), jload("cifar10_otcfm", over)
    assert cfg.to_dict() == ref.to_dict() and cfg.name == "debug_myrun"
    assert tcfg.apply_debug(tcfg.load_config("2d_otcfm"), mode).to_dict() == japply(
        jload("2d_otcfm"), mode).to_dict()


def test_yaml_round_trip_and_errors_match_jax(tmp_path):
    from cfm_tpu.config import load_config as jload

    cfg = tcfg.load_config("mnist_otcfm_cond", ["trainer.total_steps=77", "model.width=3"])
    out = tmp_path / "saved.yaml"
    tcfg.save_config(cfg, str(out))
    assert tcfg.load_config(str(out)).to_dict() == cfg.to_dict() == jload(str(out)).to_dict()
    bad = tmp_path / "bad.yaml"
    bad.write_text("optim:\n  nonexistent_knob: 3\n")
    for load in (tcfg.load_config, jload):
        with pytest.raises(AttributeError):
            load(str(bad))
    (tmp_path / "list.yaml").write_text("- 1\n- 2\n")
    with pytest.raises(ValueError, match="must be a mapping"):
        tcfg.load_config(str(tmp_path / "list.yaml"))
    with pytest.raises(ValueError, match="Unknown debug mode"):
        tcfg.load_config("2d_otcfm", ["debug=nope"])
    with pytest.raises(KeyError):
        tcfg.load_config("no_such_preset")


# -- checkpoints ---------------------------------------------------------------


def _random_state(tmp_path, seed=0):
    """A small Trainer's state with every tensor and count made non-trivial."""
    trainer = _trainer("2d_otcfm", ["data.batch_size=16"], tmp_path / f"s{seed}")
    g = torch.Generator().manual_seed(seed)
    st = trainer.state
    with torch.no_grad():
        for lst in (st.params, st.ema_params, st.opt_state.mu, st.opt_state.nu):
            for t in lst:
                t.copy_(torch.randn(t.shape, generator=g))
    st.step, st.opt_state.count = 17 + seed, 13 + seed
    return trainer


def _tensors(state):
    return [t.detach().clone() for lst in (state.params, state.ema_params, state.opt_state.mu,
                                           state.opt_state.nu) for t in lst]


def _assert_same_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_checkpoint_round_trips_bit_for_bit(tmp_path):
    """Through the manager and one-shot, into a state of other values: every
    tensor, the step and Adam's count come back; saving again at a saved
    step writes nothing; ``latest_step`` and ``restore(step=)`` pick files."""
    src = _random_state(tmp_path, 0)
    dst = _random_state(tmp_path, 1)
    want = _tensors(src.state)
    mgr = tck.CheckpointManager(str(tmp_path / "m"), save_interval=10)
    assert mgr.latest_step() is None
    assert not mgr.save(src.state, step=15)              # not due
    assert mgr.save(src.state, step=20)                  # due
    assert not mgr.save(src.state, step=20, force=True)  # saved already
    assert mgr.save(src.state, force=True)               # state.step 17
    assert mgr.all_steps() == [17, 20] and mgr.latest_step() == 20
    mgr.restore(dst.state, step=17)
    _assert_same_bits(_tensors(dst.state), want)
    assert dst.state.step == 17 and dst.state.opt_state.count == 13
    path = str(tmp_path / "one" / "state.pt")
    tck.save_train_state(path, src.state)
    other = _random_state(tmp_path, 2)
    assert tck.restore_train_state(path, other.state) is other.state
    _assert_same_bits(_tensors(other.state), want)
    payload = torch.load(path, weights_only=True)
    assert payload["shapes"] == [list(p.shape) for p in src.state.params]
    assert not [f for f in os.listdir(tmp_path / "one") if f.endswith(".tmp")]
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tck.CheckpointManager(str(tmp_path / "empty")).restore(dst.state)


def test_checkpoint_manager_keeps_the_latest(tmp_path):
    trainer = _random_state(tmp_path)
    mgr = tck.CheckpointManager(str(tmp_path / "k"), save_interval=1, max_to_keep=3)
    for step in range(1, 8):
        assert mgr.save(trainer.state, step=step)
    assert mgr.all_steps() == [5, 6, 7]
    keep_all = tck.CheckpointManager(str(tmp_path / "all"), save_interval=1, max_to_keep=0)
    for step in range(1, 8):
        keep_all.save(trainer.state, step=step)
    assert keep_all.all_steps() == list(range(1, 8))


def test_checkpoint_of_another_model_raises(tmp_path):
    """A state of other shapes or counts raises ValueError; the Trainer
    raises it with JAX's message rather than training over it."""
    small = _trainer("2d_otcfm", ["data.batch_size=16"], tmp_path)
    small.fit(1)
    path = small.ckpt.path(1)
    wide = _trainer("2d_otcfm", ["data.batch_size=16", "model.width=32"], tmp_path / "w")
    with pytest.raises(ValueError, match="is torch.float32"):
        tck.restore_train_state(path, wide.state)
    sf2m = _trainer("2d_sf2m", ["data.batch_size=16"], tmp_path / "s")
    with pytest.raises(ValueError, match="params tensors"):
        tck.restore_train_state(path, sf2m.state)
    with pytest.raises(ValueError, match="does not match the current model's parameter tree"):
        _trainer("2d_otcfm", ["data.batch_size=16", "model.width=32"], tmp_path)


def test_orbax_directory_beside_the_checkpoints_is_ignored(tmp_path):
    """JAX's orbax step directories in the same folder are not the port's:
    ``latest_step`` counts only ``torch_step_<n>.pt`` files."""
    import jax
    import jax.numpy as jnp

    from cfm_tpu.checkpoint import CheckpointManager as JManager
    from cfm_tpu.models import MLP as JMLP
    from cfm_tpu.train import init_train_state, make_optimizer

    jmodel = JMLP(dim=2, w=8)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2,)), jnp.zeros((2, 2)))
    jstate = init_train_state(params, make_optimizer(lr=1e-3, warmup_steps=0))
    directory = tmp_path / "ckpt" / "2d_otcfm"
    JManager(str(directory)).save(jstate._replace(step=jnp.asarray(9)), force=True)
    assert os.path.isdir(directory / "9")
    trainer = _trainer("2d_otcfm", ["data.batch_size=16"], tmp_path)
    assert trainer.state.step == 0 and trainer.ckpt.latest_step() is None
    trainer.fit(2)
    assert trainer.ckpt.all_steps() == [2] and os.path.isdir(directory / "9")


# -- resumption ----------------------------------------------------------------


def _draws(x0, seed=5):
    g = torch.Generator().manual_seed(seed)
    return StepDraws(t=torch.rand(x0.shape[0], generator=g),
                     eps=torch.randn(x0.shape, generator=g),
                     plan_u=torch.rand(x0.shape[0], generator=g),
                     dropout=torch.Generator().manual_seed(seed + 1))


def test_resume_reproduces_the_next_step_bit_for_bit(tmp_path, capsys):
    """Fit 5 steps (checkpoint at 5), build a new Trainer on the same
    directory: it resumes at 5 with the same bits, and one step from it
    equals one step from the uninterrupted state, given the same draws
    (dropout included), in every bit. Then it fits on to 8."""
    over = TINY + ["trainer.total_steps=5", "trainer.ckpt_interval=5"]
    first = _trainer("cifar10_otcfm", over, tmp_path)
    first.fit()
    resumed = _trainer("cifar10_otcfm", over, tmp_path)
    assert "resumed from step 5" in capsys.readouterr().out
    assert resumed.state.step == 5 and resumed.state.opt_state.count == 5
    _assert_same_bits(_tensors(resumed.state), _tensors(first.state))
    x0, x1 = first._prep(first._batch()[0])
    for t in (first, resumed):
        m = t.step_fn(t.state, x0, x1, draws=_draws(x0))
        assert np.isfinite(float(m["loss"]))
    assert first.state.step == resumed.state.step == 6
    _assert_same_bits(_tensors(resumed.state), _tensors(first.state))
    assert resumed.fit(8).step == 8 and resumed.ckpt.latest_step() == 8


# -- the metric log and its siblings -------------------------------------------


def _read_tb_records(path):
    """The TFRecord frames of an event file, each length and payload held to
    its masked CRC32C; returns the payloads."""
    from cfm_tpu_torch.tb_events import masked_crc32c

    data, out, i = open(path, "rb").read(), [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == masked_crc32c(header)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == masked_crc32c(payload)
        out.append(payload)
        i += 16 + n
    return out


def test_metric_logs_lr_exec_time_hparams_and_tensorboard(tmp_path, monkeypatch):
    """CSV and JSONL rows with the loss, ``steps_per_s`` and the warmup's lr
    (JAX's schedule at count step - 1), an ``exec_time.log`` line per fit,
    ``<name>_hparams.json`` with the parameter count, and with
    ``CFM_TPU_TB=1`` a TensorBoard event file that frames correctly."""
    from cfm_tpu.train import warmup_lr_schedule as jsched
    from cfm_tpu_torch.tb_events import encode_scalar_event

    monkeypatch.setenv("CFM_TPU_TB", "1")
    trainer = _trainer("2d_otcfm", ["data.batch_size=16", "optim.lr=1e-3",
                                    "optim.warmup_steps=10", "trainer.log_interval=1"], tmp_path)
    trainer.fit(5)
    trainer.logger.close()
    logs = tmp_path / "logs"
    rows = [json.loads(line) for line in open(logs / "2d_otcfm_metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    for r in rows:
        assert r["lr"] == float(jsched(1e-3, 10)(r["step"] - 1)) and r["steps_per_s"] > 0
    np.testing.assert_allclose(rows[-1]["lr"], 1e-3 * 5 / 10, rtol=1e-6)
    with open(logs / "2d_otcfm_metrics.csv") as fh:
        header, *lines = fh.read().splitlines()
    assert header.split(",")[:2] == ["step", "flow_loss"] and len(lines) == 5
    assert "lr" in header.split(",") and "loss" in header.split(",")
    assert open(logs / "exec_time.log").read().startswith("2d_otcfm: 5 steps in ")
    hp = json.load(open(logs / "2d_otcfm_hparams.json"))
    assert hp["model/params/total"] == trainer.n_params == 8706
    assert hp["config"] == json.loads(json.dumps(trainer.cfg.to_dict()))
    (events,) = glob.glob(str(logs / "tensorboard" / "2d_otcfm" / "events.out.tfevents.*"))
    records = _read_tb_records(events)
    assert b"brain.Event:2" in records[0] and len(records) == 1 + 5 * (len(rows[0]) - 1)
    want = encode_scalar_event("lr", rows[-1]["lr"], 5, 0.0)
    assert any(r[9:] == want[9:] for r in records)  # equal past the wall time


def test_model_summary_and_param_count(tmp_path, capsys, monkeypatch):
    from cfm_tpu_torch.utils import count_params, param_summary

    monkeypatch.setenv("CFM_TPU_MODEL_SUMMARY", "1")
    trainer = _trainer("2d_sf2m", [], tmp_path)
    out = capsys.readouterr().out
    assert "params: 17,412" in out and "flow.Dense_0" in out and "score.Dense_3" in out
    rows = param_summary(trainer.model, max_depth=1).splitlines()
    assert rows[-1].split()[0] == "TOTAL"
    assert int(rows[-1].split()[-1].replace(",", "")) == count_params(trainer.model) == 8706
    assert sum(int(r.split()[-1].replace(",", "")) for r in rows[:-1]) == 8706


def _data_sums(trainer, steps=3):
    """Run ``fit`` with the step function replaced by one that records the
    sums of each step's x0 and x1 (the uint8 batch before the flip on the
    image branch, with random_flip off)."""
    sums = []

    def probe(state, x0, x1, *rest, generator=None):
        sums.append((float(x0.sum()), float(x1.sum())))
        state.step += 1
        return {"loss": torch.tensor(0.0)}

    trainer.step_fn = probe
    trainer.fit(steps)
    return sums


@pytest.mark.parametrize("preset,extra", [
    ("2d_icfm", ["data.batch_size=16"]),
    ("mnist_icfm", TINY_MNIST + ["data.batch_size=8", "data.random_flip=False"]),
    ("mnist_icfm", TINY_MNIST + ["data.batch_size=8", "data.random_flip=False",
                                 "data.on_device=False"]),
], ids=["2d", "image", "image-streamed"])
def test_overfit_batches_repeat_the_data_only(preset, extra, tmp_path):
    """``overfit_batches=1``: the same data every step, while the image
    branch's noise x0 stays fresh; without it the data changes each step."""
    ov = _data_sums(_trainer(preset, extra + ["trainer.overfit_batches=1"], tmp_path / "ov"))
    iid = _data_sums(_trainer(preset, extra, tmp_path / "iid"))
    assert ov[0][1] == ov[1][1] == ov[2][1] and len({s[1] for s in iid}) == 3
    if preset == "2d_icfm":
        assert ov[0][0] == ov[1][0] == ov[2][0]
    else:
        assert len({s[0] for s in ov}) == 3
    two = [s[1] for s in _data_sums(_trainer(preset, extra + ["trainer.overfit_batches=2"],
                                             tmp_path / "2"), 4)]
    assert two[0] == two[2] and two[1] == two[3] and two[0] != two[1]


def test_debug_nans_is_anomaly_mode_scoped_to_fit(tmp_path):
    """``debug=fdr`` trains 1 step and evaluates once with autograd's anomaly
    mode on inside ``fit`` (the UNet's GroupNorm autograd Function runs
    under it) and restores it after, also when fit raises."""
    seen = []
    trainer = _trainer("mnist_otcfm", TINY_MNIST + ["debug=fdr", "data.batch_size=4",
                                                    "eval.num_eval_samples=8",
                                                    "eval.ode_steps=2"], tmp_path)
    assert trainer.cfg.name == "debug_mnist_otcfm" and trainer.cfg.trainer.debug_nans
    step_fn = trainer.step_fn

    def spying(*a, **k):
        seen.append(torch.is_anomaly_enabled())
        return step_fn(*a, **k)

    trainer.step_fn = spying
    assert not torch.is_anomaly_enabled()
    trainer.fit()
    assert seen == [True] and not torch.is_anomaly_enabled()
    assert trainer.state.step == 1 and len(trainer.eval_log) == 1

    def failing(*a, **k):
        raise RuntimeError("boom")

    trainer.step_fn = failing
    with pytest.raises(RuntimeError, match="boom"):
        trainer.fit(2)
    assert not torch.is_anomaly_enabled()


def test_profile_dir_writes_a_trace_of_the_fit(tmp_path):
    prof = tmp_path / "prof"
    trainer = _trainer("2d_otcfm", ["data.batch_size=16", f"trainer.profile_dir={prof}"],
                       tmp_path)
    trainer.fit(2)
    trace = json.load(open(prof / "2d_otcfm.pt.trace.json"))
    assert trace["traceEvents"]


def test_sample_grid_png_decodes_to_the_grid(tmp_path):
    """The fit's sample grid is a PNG of the tiled images; the writer's
    bytes decode (zlib, filter 0) to ``image_grid``'s array, grey and RGB."""
    from cfm_tpu_torch.eval.plotting import image_grid

    def decode(path):
        data = open(path, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        i, chunks = 8, {}
        while i < len(data):
            (n,) = struct.unpack(">I", data[i:i + 4])
            kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
            assert struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0] == zlib.crc32(kind + body)
            chunks[kind] = chunks.get(kind, b"") + body
            i += 12 + n
        w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
        c = {0: 1, 2: 3}[color]
        raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * c)
        assert depth == 8 and not raw[:, 0].any()
        return raw[:, 1:].reshape(h, w, c)

    rng = np.random.default_rng(0)
    for c in (1, 3):
        imgs = rng.integers(0, 256, (11, 5, 4, c)).astype(np.uint8)
        grid = image_grid(imgs, nrow=4)
        assert grid.shape == (15, 16, c) and np.array_equal(grid[5:10, 4:8], imgs[5])
        assert np.array_equal(decode(image_grid(imgs, nrow=4, save_path=str(tmp_path / "g.png"))),
                              grid)
    floats = image_grid(torch.tensor([[[[-1.0], [1.0]]]]), nrow=1)
    assert floats[..., 0].tolist() == [[0, 255]]
    trainer = _trainer("mnist_otcfm", TINY_MNIST + [
        "data.batch_size=4", "trainer.sample_grid_interval=2", "trainer.sample_grid_n=10",
        "eval.ode_steps=2"], tmp_path)
    trainer.fit(2)
    grid = decode(tmp_path / "ckpt" / "mnist_otcfm" / "samples_2.png")
    assert grid.shape == (2 * 28, 8 * 28, 1)


# -- the image evaluation --------------------------------------------------------


def test_image_evaluation_tracking_fid_falls_and_is_logged(tmp_path):
    """``evaluate`` on a tiny MNIST UNet: finite gen_mean, gen_std, NFE and
    tracking FID; the tracking FID falls with training (40 steps at lr 1e-3
    without warmup and EMA 0.9, so that the EMA field moves away from the
    zero-initialised output); the in-loop evaluation lands in the JSONL as
    ``eval/tracking_fid``."""
    trainer = _trainer("mnist_otcfm", TINY_MNIST + [
        "data.batch_size=16", "trainer.total_steps=40", "trainer.log_interval=20",
        "trainer.eval_interval=20", "eval.num_eval_samples=128", "eval.ode_steps=5",
        "optim.lr=1e-3", "optim.warmup_steps=1", "optim.ema_decay=0.9"], tmp_path)
    ev0 = trainer.evaluate()
    assert set(ev0) == {"gen_mean", "gen_std", "nfe", "tracking_fid"} and ev0["nfe"] == 5
    assert all(np.isfinite(v) for v in ev0.values())
    trainer.fit()
    ev1 = trainer.evaluate()
    assert np.isfinite(ev1["tracking_fid"]) and ev1["tracking_fid"] < ev0["tracking_fid"], (ev0, ev1)
    rows = [json.loads(line) for line in open(trainer.logger.jsonl_path)]
    assert [r["step"] for r in rows if "eval/tracking_fid" in r] == [20, 40]


def test_image_gen_mean_and_std_match_jax(tmp_path, monkeypatch):
    """Given the same EMA parameters and the same noise, the JAX Trainer's
    and the port's ``evaluate`` give the same ``gen_mean``, ``gen_std`` and
    ``nfe``, over the float samples (1e-5). The noise is handed to both by
    replacing their normal draws of that shape."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from cfm_tpu.config import load_config as jload
    from cfm_tpu.trainer import Trainer as JTrainer
    from cfm_tpu.trainer import build_model as jbuild
    from cfm_tpu_torch.models.convert import unet_params_from_flax
    from test_torch_unet import random_flax_params

    over = TINY_MNIST + ["eval.num_eval_samples=16", "eval.ode_steps=3", "data.batch_size=4"]
    # JAX's evaluate and generate, on a Trainer holding only what they read
    # (its constructor would also load data and build the optimizer and an
    # orbax manager, none of which they use).
    jtrainer = object.__new__(JTrainer)
    jtrainer.cfg = jload("mnist_otcfm", over)
    jtrainer.is_image, jtrainer.score_model = True, None
    jtrainer.model = jbuild(jtrainer.cfg)
    jtrainer.key = jax.random.PRNGKey(0)
    params = random_flax_params(jtrainer.model, jnp.zeros((1,)), jnp.zeros((1, 28, 28, 1)),
                                seed=3)
    jtrainer.state = SimpleNamespace(ema_params={"params": params})
    trainer = _trainer("mnist_otcfm", over, tmp_path)
    sd = unet_params_from_flax(params)
    names = [n for n, _ in trainer.model.named_parameters()]
    with torch.no_grad():
        for name, e in zip(names, trainer.state.ema_params):
            e.copy_(sd[name])
    x0 = np.random.default_rng(4).standard_normal((16, 28, 28, 1)).astype(np.float32)
    normal, randn = jax.random.normal, torch.randn
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), *a, **k: (
        jnp.asarray(x0) if tuple(shape) == x0.shape else normal(key, shape, *a, **k)))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: (
        torch.from_numpy(x0.copy()) if tuple(a[0]) == x0.shape else randn(*a, **k)))
    # The tracking FIDs (other kernels in each package) are not compared here.
    monkeypatch.setattr(trainer, "tracking_fid", lambda gen: None)
    monkeypatch.setattr(jtrainer, "tracking_fid", lambda gen: None)
    ev, jev = trainer.evaluate(), jtrainer.evaluate()
    assert ev["nfe"] == jev["nfe"] == 3
    for key in ("gen_mean", "gen_std"):
        np.testing.assert_allclose(ev[key], jev[key], rtol=1e-5, atol=1e-6, err_msg=key)
    assert abs(ev["gen_std"] - 1.0) > 1e-3  # the field moved the noise


# -- entry points ------------------------------------------------------------------


def test_cli_eval_restores_and_evaluates_an_image_preset(tmp_path, capsys):
    from cfm_tpu_torch import cli

    run = TINY_MNIST + ["data.batch_size=4", "trainer.total_steps=2",
                        "eval.num_eval_samples=8", "eval.ode_steps=2", "--device", "cpu",
                        "--log_dir", str(tmp_path / "logs")] + iso(tmp_path)
    assert cli.main(["eval", "mnist_otcfm"] + run) == 1
    assert "no checkpoint to evaluate; run train first" in capsys.readouterr().out
    assert cli.main(["train", "mnist_otcfm"] + run) == 0
    out = capsys.readouterr().out
    assert out.startswith("config: mnist_otcfm\n") and "final eval: {'gen_mean'" in out
    assert "'tracking_fid'" in out
    assert cli.main(["eval", "mnist_otcfm"] + run) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "eval: {'gen_mean'" in out


def test_compute_fid_synthetic_through_the_tracking_features(tmp_path, capsys, monkeypatch):
    """``compute_fid --synthetic`` from a tiny checkpoint: EMA weights, euler
    generation in batches, the tracking features when no Inception weights
    are set, JAX's ``FID[...]`` line; ``--step`` picks a checkpoint and a
    directory without one exits."""
    from cfm_tpu_torch import compute_fid, train_cifar10

    monkeypatch.delenv("CFM_TPU_INCEPTION_WEIGHTS", raising=False)
    tiny = [a for o in TINY[:4] for a in ("--override", o)]
    common = ["--synthetic", "--device", "cpu", "--output_dir", str(tmp_path)] + tiny
    train_cifar10.main(["--total_steps", "3", "--save_step", "2", "--batch_size", "4",
                        "--no_bf16"] + common)
    capsys.readouterr()
    fid = compute_fid.main(["--num_gen", "16", "--batch_size_fid", "8", "--num_ref", "64",
                            "--integration_method", "euler", "--integration_steps", "2",
                            "--step", "2"] + common)
    out = capsys.readouterr().out
    assert "evaluating checkpoint at step 2" in out and "generated 16/16 (nfe/batch 2)" in out
    assert "FID[tracking (NOT comparable to published FID)] = " in out and np.isfinite(fid)
    assert f"= {fid:.4f}  (num_gen=16, method=euler, mean NFE/batch=2)" in out
    with pytest.raises(SystemExit, match="no checkpoint found"):
        compute_fid.main(["--num_gen", "4"] + common[:3] + ["--output_dir", str(tmp_path / "x")]
                         + tiny)


# -- sweeps and profiling ----------------------------------------------------------


def _records(recs):
    return [{k: v for k, v in r.items() if k != "traceback"} for r in recs]


def test_sweeps_give_jax_records():
    """For a deterministic ``run_fn`` (failing on some configs), the grid,
    random and TPE searches give JAX's records: overrides, names, metrics,
    objectives, errors, trials and parameters."""
    import math

    from cfm_tpu import sweep as jsweep
    from cfm_tpu_torch import sweep as tsweep

    def run_fn(cfg):
        if cfg.matcher.kind == "sbcfm":
            raise RuntimeError("boom")
        penalty = 0.0 if cfg.matcher.kind == "otcfm" else 1.0
        return {"w2": (math.log10(cfg.optim.lr) + 3.0) ** 2 + penalty, "name": len(cfg.name)}

    grid = ["matcher.kind=icfm,otcfm,sbcfm", "optim.lr=0.001,0.01"]
    assert tsweep.expand_grid(grid) == jsweep.expand_grid(grid)
    assert _records(tsweep.run_sweep("2d_icfm", grid, run_fn=run_fn)) == _records(
        jsweep.run_sweep("2d_icfm", grid, run_fn=run_fn))
    space = {"optim.lr": tsweep.log_uniform(1e-4, 1e-2), "matcher.kind": tsweep.choice(
        "icfm", "otcfm", "sbcfm")}
    jspace = {"optim.lr": jsweep.log_uniform(1e-4, 1e-2), "matcher.kind": jsweep.choice(
        "icfm", "otcfm", "sbcfm")}
    best, trials = tsweep.random_search("2d_icfm", space, 8, run_fn=run_fn, seed=3)
    jbest, jtrials = jsweep.random_search("2d_icfm", jspace, 8, run_fn=run_fn, seed=3)
    assert _records(trials) == _records(jtrials) and best == jbest
    tspace = {"optim.lr": tsweep.Float(1e-5, 1e-1, log=True),
              "matcher.kind": tsweep.Categorical("icfm", "otcfm", "sbcfm")}
    jtspace = {"optim.lr": jsweep.Float(1e-5, 1e-1, log=True),
               "matcher.kind": jsweep.Categorical("icfm", "otcfm", "sbcfm")}
    best, trials = tsweep.tpe_search("2d_icfm", tspace, 16, run_fn=run_fn, n_startup=5, seed=0)
    jbest, jtrials = jsweep.tpe_search("2d_icfm", jtspace, 16, run_fn=run_fn, n_startup=5,
                                       seed=0)
    assert _records(trials) == _records(jtrials)
    assert _records([best]) == _records([jbest]) and best["params"]["matcher.kind"] == "otcfm"
    with pytest.raises(ValueError, match="comma"):
        tsweep.Categorical("a,b")


def test_profiling_helpers_on_the_cpu(tmp_path):
    from cfm_tpu_torch import profiling
    from cfm_tpu_torch.version import __version__

    x = torch.ones((64, 64))
    dt = profiling.time_fn(lambda a: a @ a, x, iters=5, warmup=1)
    assert 0.0 < dt < 1.0
    assert profiling.hard_sync({"a": [x * 3]}) == 3.0
    assert 0.0 <= profiling.measure_sync_overhead(device="cpu") < 1.0
    with profiling.trace(str(tmp_path / "tr")):
        (x @ x).sum()
    assert json.load(open(tmp_path / "tr" / "trace.pt.trace.json"))["traceEvents"]
    assert __version__ == "0.1.0"
