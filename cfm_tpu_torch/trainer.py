"""Experiment harness on one device (counterpart of ``cfm_tpu/trainer.py``):
config -> model, matcher, data -> ``fit``, ``generate``, ``evaluate``, with
checkpoints, resumption and metric logs.

The 2-D branch (the ``2d_*`` presets): each step draws x0 from the source
and x1 from the target generator on the device, then runs the train step
(its draws from the same generator, seeded from ``trainer.seed``). Its
evaluation: points generated from the EMA parameters against fresh target
points by the exact W1 and W2 (two assignment solves, the row-tiled auction
kernel on the card, scipy on the CPU).

The image branch: the uint8 set goes to the device once
(``data.on_device``, the default) and each step draws batch indices there;
the step's prep (normalise, flip, draw x0) and the train step run on the
device. With ``model.class_cond`` the labels are gathered with the same
indices (y0 = y1 = the batch's labels) and ride through the coupling into
the model's class embedding. Its evaluation: ``eval.num_eval_samples``
images integrated from N(0, I) with the EMA parameters, their mean, std and
NFE, and the tracking FID against the first 4096 training images.

With ``matcher.score_head`` ([SF]2M) a second model of the same kind, its
weights from seed + 1, learns the score: one optimizer, clip and EMA span
both heads; ODE generation uses the flow head's EMA parameters, and
``generate_sde`` both heads' (dx = [v + s] dt + sigma dW, sigma the
matcher's or 1). With ``eval.sde`` an evaluation adds ``sde_kl``, the mean
Girsanov KL of such a rollout, and on the 2-D branch ``sde_w2``, its W2
against the same target points as ``w2``.

``model.use_checkpoint`` recomputes each UNet ResBlock and attention block
in the backward (``model.checkpoint_policy``: None saves nothing, "dots"
the convolutions' and matmuls' outputs, "dots_no_batch" the matmuls
without batch dimensions); the parameters keep their names.

Checkpoints go to ``<trainer.ckpt_dir>/<name>`` every ``ckpt_interval``
steps and at the end of every ``fit``; with ``trainer.resume`` (the
default) a new ``Trainer`` restores the latest one. The random generator is
seeded from ``trainer.seed`` again on resumption, as the JAX package re-keys
from it: its state is not in the checkpoint. Metrics go to
``<log_dir>/<name>_metrics.csv`` and ``.jsonl`` and to stdout (TensorBoard
with ``CFM_TPU_TB=1``, wandb with ``CFM_TPU_WANDB=1``); ``<name>_hparams.json``
holds the parameter count and the config, ``exec_time.log`` each fit's steps
and seconds. The loss is read back only at ``log_interval``.

Data parallelism: with ``trainer.data_parallel`` (the default) and an
initialised process group of more than one rank (``torchrun``, see
``cfm_tpu_torch.parallel.initialize_distributed``), the JAX Trainer's
mesh branch. Every rank streams the same batch from the same seed, prepares
and couples it identically, and trains on its rows with the
replicated-coupling step (``train.make_replicated_coupling_shard_fn``: one
all-reduce of the gradients a step). Rank 0 alone writes logs, checkpoints
and sample grids, and evaluates, its generator's state restored after an
evaluation or a grid so that the ranks' streams stay equal; every rank
restores the same checkpoint, and the ranks meet at a barrier after the
final save.
Class-conditional I-CFM is refused as the JAX package fails on it: its
matcher carries no labels.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from cfm_tpu_torch.checkpoint import CheckpointManager
from cfm_tpu_torch.config import Config
from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.data.images import (infinite_batches, load_cifar10, load_mnist,
                                       normalize_images, random_hflip)
from cfm_tpu_torch.data.toy import _DIM_AWARE, two_dim_data
from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.generate import Generated, generate
from cfm_tpu_torch.integrate import (FlowSolver, ODESolution, SDESolution, odeint,
                                    vector_field_from_model)
from cfm_tpu_torch.models.mlp import MLP
from cfm_tpu_torch.models.unet import UNetModelWrapper
from cfm_tpu_torch.paths import (ConditionalFlowMatcher,
                                 ExactOptimalTransportConditionalFlowMatcher,
                                 SchrodingerBridgeConditionalFlowMatcher,
                                 TargetConditionalFlowMatcher,
                                 VariancePreservingConditionalFlowMatcher)
from cfm_tpu_torch.train import (TrainState, init_train_state, make_mesh, make_optimizer,
                                 make_replicated_coupling_shard_fn, make_train_step,
                                 warmup_lr_schedule)
from cfm_tpu_torch.utils import count_params, param_summary

_2D_SETS = {"moons", "moon", "8gaussians", "pinwheel", "checkerboard", "checker",
            "circles", "circle", "2spirals", "swiss", "swissroll", "scurve",
            "mixture", "gaussian", "funnel"}


class Samples(NamedTuple):
    samples: torch.Tensor  # (n, dim) float32 on the trainer's device
    nfe: int               # vector-field evaluations


def build_matcher(cfg: Config):
    kind, sigma = cfg.matcher.kind, cfg.matcher.sigma
    if kind == "icfm":
        return ConditionalFlowMatcher(sigma=sigma)
    if kind == "otcfm":
        return ExactOptimalTransportConditionalFlowMatcher(sigma=sigma)
    if kind == "fm":
        return TargetConditionalFlowMatcher(sigma=sigma)
    if kind == "sbcfm":
        return SchrodingerBridgeConditionalFlowMatcher(sigma=sigma if sigma > 0 else 1.0,
                                                       ot_method=cfg.matcher.ot_method)
    if kind == "vpcfm":
        return VariancePreservingConditionalFlowMatcher(sigma=sigma)
    raise ValueError(f"Unknown matcher kind: {kind}")


def _vector_dim(cfg: Config) -> int:
    """The vector branch's sample dimension: data.dim if set, else funnel's
    10, else 0 (the generator's default, 2-D). Source and target alike."""
    if cfg.data.dim:
        return cfg.data.dim
    return 10 if cfg.data.dataset == "funnel" else 0


def _source_gen(cfg: Config):
    """The source generator at the vector dimension; a 2-D-only source under
    a target of more dimensions becomes the standard normal, as in JAX."""
    dim = _vector_dim(cfg)
    if dim > 2 and cfg.data.source not in _DIM_AWARE:
        return two_dim_data("gaussian", dim)
    return two_dim_data(cfg.data.source, dim)


def build_model(cfg: Config, device: DeviceLike = None, seed: Optional[int] = None):
    """The configured model, its initial weights drawn from ``seed``
    (default ``trainer.seed``)."""
    m = cfg.model
    seed = cfg.trainer.seed if seed is None else seed
    if m.kind == "mlp":
        dim = (_vector_dim(cfg) or 2) if cfg.data.dataset in _2D_SETS else int(np.prod(m.image_dim))
        return MLP(dim=dim, w=m.width, seed=seed, device=device)
    if m.kind != "unet":
        raise ValueError(f"Unknown model kind: {m.kind}")
    return UNetModelWrapper(
        dim=m.image_dim, num_channels=m.num_channels, num_res_blocks=m.num_res_blocks,
        channel_mult=m.channel_mult, num_heads=m.num_heads,
        num_head_channels=m.num_head_channels, attention_resolutions=m.attention_resolutions,
        dropout=m.dropout, use_scale_shift_norm=m.use_scale_shift_norm,
        resblock_updown=m.resblock_updown, class_cond=m.class_cond, num_classes=m.num_classes,
        use_checkpoint=m.use_checkpoint, checkpoint_policy=m.checkpoint_policy,
        dtype=torch.bfloat16 if m.bf16 else torch.float32, seed=seed, device=device)


TRACKING_REF_IMAGES = 4096  # the training set's first images: tracking FID's reference


def _overfit_generator(seed: int, salt: int, step: int, n_batches: int,
                       device: torch.device) -> torch.Generator:
    """The generator of a data draw that repeats with period ``n_batches``
    (``trainer.overfit_batches``): step k draws batch k mod n again. The
    salt keeps the draws of x0, x1 and the image indices apart."""
    seed = int(np.random.SeedSequence([seed, salt, step % n_batches]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


class MetricLogger:
    """Metrics as CSV, JSONL and (through the caller) stdout, as the JAX
    package logs them; TensorBoard event files with ``CFM_TPU_TB=1`` (the
    dependency-free writer of ``tb_events``) and wandb with
    ``CFM_TPU_WANDB=1`` where it imports.

    The CSV's columns are the first row's: a row with other keys (an
    evaluation's) goes to the JSONL only."""

    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, f"{name}_metrics.csv")
        self.jsonl_path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._file = self._writer = self._wandb = self._tb = None
        if os.environ.get("CFM_TPU_TB") == "1":
            from cfm_tpu_torch.tb_events import TBEventWriter

            self._tb = TBEventWriter(os.path.join(log_dir, "tensorboard", name))
        if os.environ.get("CFM_TPU_WANDB") == "1":
            try:
                import wandb
            except ImportError:
                print("WARNING: CFM_TPU_WANDB=1 but wandb does not import; not logging to it")
            else:
                self._wandb = wandb
                wandb.init(project="cfm_tpu", name=name, dir=log_dir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self._writer is None:
            self._file = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=list(row))
            if self._file.tell() == 0:
                self._writer.writeheader()
        try:
            self._writer.writerow(row)
        except ValueError:  # keys the CSV's columns do not have
            pass
        self._file.flush()
        with open(self.jsonl_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(row, step=step)
        if self._tb is not None:
            for k, v in row.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
            self._tb.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()


class _NoLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """Config-driven training of the 2-D and image branches on one device,
    or one rank's device of a data-parallel run."""

    def __init__(self, cfg: Config, device: DeviceLike = None, log_dir: str = "logs"):
        self.cfg = cfg
        self.is_image = cfg.data.dataset in ("cifar10", "mnist")
        self.device = resolve_device(device)
        # The JAX Trainer's mesh branch takes more than one device; here more
        # than one rank of an initialised process group.
        parallel = (cfg.trainer.data_parallel and dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1)
        self.mesh = make_mesh() if parallel else None
        self.is_main = not parallel or dist.get_rank() == 0
        self.log_dir = log_dir
        self.matcher = build_matcher(cfg)
        self.model = build_model(cfg, self.device)
        self.logger = MetricLogger(log_dir, cfg.name) if self.is_main else _NoLogger()
        # The score head's weights come from a seed of their own, as JAX folds
        # 1 into the flow head's init key.
        self.score_model = (build_model(cfg, self.device, seed=cfg.trainer.seed + 1)
                            if cfg.matcher.score_head else None)
        self.optimizer = make_optimizer(lr=cfg.optim.lr, warmup_steps=cfg.optim.warmup_steps,
                                        grad_clip=cfg.optim.grad_clip,
                                        weight_decay=cfg.optim.weight_decay)
        self.state: TrainState = init_train_state(self.model, self.optimizer, self.score_model)
        dropout = cfg.model.kind == "unet" and cfg.model.dropout > 0  # the MLP has none
        step_kwargs = dict(ema_decay=cfg.optim.ema_decay, train_mode=dropout,
                           class_conditional=cfg.model.class_cond, score_model=self.score_model)
        if self.mesh is not None:
            self.step_fn = make_replicated_coupling_shard_fn(self.matcher, self.model,
                                                             self.optimizer, self.mesh,
                                                             **step_kwargs)
        else:
            self.step_fn = make_train_step(self.matcher, self.model, self.optimizer,
                                           **step_kwargs)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.trainer.seed)

        self.ckpt = CheckpointManager(os.path.join(cfg.trainer.ckpt_dir, cfg.name),
                                      save_interval=cfg.trainer.ckpt_interval)
        if cfg.trainer.resume and self.ckpt.latest_step() is not None:
            try:
                self.ckpt.restore(self.state)
            except ValueError as e:
                raise ValueError(
                    f"Checkpoint under {cfg.trainer.ckpt_dir}/{cfg.name} does not match the "
                    "current model's parameter tree (it likely predates a model change). "
                    "Delete the stale directory or point trainer.ckpt_dir elsewhere to start "
                    "fresh.") from e
            self._print(f"resumed from step {self.state.step}")

        self.n_params = count_params(self.state.params)
        ranks = "" if self.mesh is None else f"  ranks: {dist.get_world_size()}"
        self._print(f"model: {cfg.model.kind}  params: {self.n_params:,}  device: "
                    f"{self.device}{ranks}")
        if os.environ.get("CFM_TPU_MODEL_SUMMARY") == "1":
            self._print(param_summary(self._named_params(),
                                      max_depth=2 if self.score_model else 1))
        if self.is_main:
            with open(os.path.join(log_dir, f"{cfg.name}_hparams.json"), "w") as fh:
                json.dump({"model/params/total": self.n_params,
                           "config": dataclasses.asdict(cfg)}, fh, indent=1, default=str)

        self._ema_model: Optional[torch.nn.Module] = None        # the flow head's EMA copy
        self._ema_score_model: Optional[torch.nn.Module] = None  # the score head's
        self._tracking = None  # (feature function, reference features), made at first use
        self.eval_log: List[Dict[str, float]] = []  # step, the metrics and the seconds taken
        if not self.is_image:
            self._target = two_dim_data(cfg.data.dataset, _vector_dim(cfg))
            self._source = _source_gen(cfg)
            return

        loader = load_cifar10 if cfg.data.dataset == "cifar10" else load_mnist
        try:
            data, labels = loader(cfg.data.data_dir, train=True)
        except FileNotFoundError:
            if not cfg.data.synthetic_fallback:
                raise
            data, labels = loader(cfg.data.data_dir, train=True, synthetic=True)
            print(f"WARNING: {cfg.data.dataset} not found on disk; using synthetic data")
        self._ref_images_u8 = np.ascontiguousarray(data[:TRACKING_REF_IMAGES])
        labels = labels.astype(np.int64) if cfg.model.class_cond else None
        if cfg.data.on_device:
            self._device_data = torch.from_numpy(data).to(self.device)
            self._device_labels = None if labels is None else torch.from_numpy(labels).to(
                self.device)
            self._batches = None
        else:
            self._device_data = self._device_labels = None
            self._batches = infinite_batches(data, labels, cfg.data.batch_size,
                                             seed=cfg.trainer.seed)
            if cfg.trainer.overfit_batches:  # replay the first N batches
                pool = [next(self._batches) for _ in range(cfg.trainer.overfit_batches)]
                self._batches = itertools.cycle(pool)

    def _print(self, *a) -> None:
        if self.is_main:
            print(*a)

    def _on_main(self, fn):
        """``fn()`` on rank 0 alone (every process where there is one),
        the trainer's generator restored after it in a data-parallel run so
        that every rank's stream stays the same; None elsewhere."""
        if self.mesh is None:
            return fn()
        if not self.is_main:
            return None
        saved = self.generator.get_state()
        try:
            return fn()
        finally:
            self.generator.set_state(saved)

    def _agreed(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a broadcast in a data-parallel run)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def _named_params(self) -> Iterator[Tuple[str, torch.Tensor]]:
        if self.score_model is None:
            return self.model.named_parameters()
        return itertools.chain(
            (("flow." + n, p) for n, p in self.model.named_parameters()),
            (("score." + n, p) for n, p in self.score_model.named_parameters()))

    def _data_generator(self, salt: int, step: int) -> torch.Generator:
        """The generator of a data draw at ``step``: the trainer's, or with
        ``overfit_batches`` one that repeats with that period."""
        n = self.cfg.trainer.overfit_batches
        if not n:
            return self.generator
        return _overfit_generator(self.cfg.trainer.seed, salt, step, n, self.device)

    def _batch(self, step: Optional[int] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The next uint8 batch on the device, and its labels when the model
        is class-conditional (else None)."""
        if self._device_data is not None:
            g = self.generator if step is None else self._data_generator(2, step)
            idx = torch.randint(0, self._device_data.shape[0], (self.cfg.data.batch_size,),
                                generator=g, device=self.device)
            y = None if self._device_labels is None else self._device_labels[idx]
            return self._device_data[idx], y
        batch = next(self._batches)
        if self.cfg.model.class_cond:
            x, y = batch
            return torch.from_numpy(x).to(self.device), torch.from_numpy(y).to(self.device)
        return torch.from_numpy(batch).to(self.device), None

    def _prep(self, x1_u8: torch.Tensor):
        """Normalise to [-1, 1], flip, and draw the source x0 ~ N(0, I)."""
        x1 = normalize_images(x1_u8)
        if self.cfg.data.random_flip:
            x1 = random_hflip(self.generator, x1)
        x0 = torch.randn(x1.shape, generator=self.generator, device=self.device)
        return x0, x1

    def _vectors(self, step: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x0 from the source and x1 from the target, drawn on the device."""
        bs = self.cfg.data.batch_size
        g0 = self.generator if step is None else self._data_generator(0, step)
        g1 = self.generator if step is None else self._data_generator(1, step)
        return self._source(g0, bs, self.device), self._target(g1, bs, self.device)

    def _step(self, i: int) -> Dict[str, torch.Tensor]:
        """Train step ``i`` (0-based): its data, prep and the step function."""
        if self.is_image:
            x1_u8, y = self._batch(i)
            x0, x1 = self._prep(x1_u8)
            labels = (y, y) if y is not None else ()
        else:
            (x0, x1), labels = self._vectors(i), ()
        return self.step_fn(self.state, x0, x1, *labels, generator=self.generator)

    def fit(self, max_steps: Optional[int] = None) -> TrainState:
        """Train to ``max_steps`` (default ``trainer.total_steps``) from the
        state's step: log every ``log_interval`` steps, evaluate every
        ``eval_interval``, save a sample grid every ``sample_grid_interval``
        (image runs) and a checkpoint when due, then a final checkpoint."""
        cfg, t = self.cfg, self.cfg.trainer
        total = t.total_steps if max_steps is None else max_steps
        start = self.state.step
        if t.early_stop_metric and not t.eval_interval:
            raise ValueError("early_stop_metric requires eval_interval > 0")
        # The debug hooks are scoped to this fit: anomaly mode restored, the
        # profiler stopped, in the finally below.
        anomaly = None
        if t.debug_nans:
            anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
            torch.autograd.set_detect_anomaly(True, check_nan=True)
        prof = None
        if t.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        last_t, last_step, step = t0, start, start
        es_best, es_bad = float("inf"), 0
        try:
            for i in range(start, total):
                metrics = self._step(i)
                step = i + 1
                if step % t.log_interval == 0 or step == total:
                    out = {k: float(v) for k, v in metrics.items()}  # the one host read
                    now = time.perf_counter()
                    sps = (step - last_step) / max(now - last_t, 1e-9)
                    last_t, last_step = now, step
                    out["steps_per_s"] = sps
                    # The lr of this step's update: the schedule at count step - 1.
                    out["lr"] = warmup_lr_schedule(cfg.optim.lr, cfg.optim.warmup_steps)(step - 1)
                    self.logger.log(step, out)
                    self._print(f"step {step:7d}  loss {out['loss']:.4f}  {sps:.2f} steps/s")
                    if not np.isfinite(out["loss"]):  # the mean loss: alike on every rank
                        raise ValueError(f"Loss Not Finite at step {step}: {out['loss']}")
                if t.eval_interval and step % t.eval_interval == 0:
                    t_ev = time.perf_counter()
                    ev = self._on_main(self.evaluate)
                    stop = False
                    if ev is not None:
                        self.eval_log.append({"step": step, **ev,
                                              "seconds": time.perf_counter() - t_ev})
                        self.logger.log(step, {f"eval/{k}": v for k, v in ev.items()})
                        print("  eval:", {k: round(v, 4) for k, v in self.eval_log[-1].items()})
                        if t.early_stop_metric:  # mode min, patience counted in evaluations
                            cur = ev[self._early_stop_key(ev)]
                            if cur < es_best - t.early_stop_min_delta:
                                es_best, es_bad = cur, 0
                            else:
                                es_bad += 1
                                stop = es_bad >= t.early_stop_patience
                                if stop:
                                    print(f"early stop at step {step}: {t.early_stop_metric} "
                                          f"did not improve past {es_best:.4f} for {es_bad} "
                                          "evals")
                    if t.early_stop_metric and self._agreed(stop):
                        break
                if self.is_image and t.sample_grid_interval and step % t.sample_grid_interval == 0:
                    self._on_main(lambda: self._save_sample_grid(step))
                # The host's step count; the save reads the device only when due.
                if self.is_main:
                    self.ckpt.save(self.state, step=step)
        finally:
            if prof is not None:
                prof.stop()
                os.makedirs(t.profile_dir, exist_ok=True)
                path = os.path.join(t.profile_dir, f"{cfg.name}.pt.trace.json")
                prof.export_chrome_trace(path)
                print(f"torch profiler trace written to {path}")
            if anomaly is not None:
                torch.autograd.set_detect_anomaly(anomaly[0], check_nan=anomaly[1])
            # The steps actually executed, also after an early exit.
            if self.is_main:
                with open(os.path.join(self.log_dir, "exec_time.log"), "a") as fh:
                    fh.write(f"{cfg.name}: {max(step - start, 0)} steps in "
                             f"{time.perf_counter() - t0:.1f}s\n")
        if self.is_main:
            self.ckpt.save(self.state, force=True)
        if self.mesh is not None:  # the checkpoint is whole before any rank reads it
            dist.barrier()
        return self.state

    def _save_sample_grid(self, step: int) -> None:
        from cfm_tpu_torch.eval.plotting import image_grid

        cfg = self.cfg
        out = self.generate(cfg.trainer.sample_grid_n, method="euler", n_steps=cfg.eval.ode_steps,
                            generator=self.generator)
        path = image_grid(out.images, nrow=8, save_path=os.path.join(
            cfg.trainer.ckpt_dir, cfg.name, f"samples_{step}.png"))
        print(f"  saved sample grid: {path}")

    def _early_stop_key(self, ev: Dict[str, float]) -> str:
        """The metric's key in ``ev``; the logged "eval/" spelling is accepted."""
        es = self.cfg.trainer.early_stop_metric
        key = es[5:] if es.startswith("eval/") else es
        if key not in ev:
            raise ValueError(f"early_stop_metric {es!r} is not an eval metric; available: "
                             f"{sorted(ev)}")
        return key

    def _ema(self, head: str = "flow") -> torch.nn.Module:
        """The flow model with its EMA parameters, the first entries of the
        state's EMA list, or with ``head="score"`` the score model with the
        entries after them (a copy of each kept across calls)."""
        attr = "_ema_model" if head == "flow" else "_ema_score_model"
        if getattr(self, attr) is None:
            model = self.model if head == "flow" else self.score_model
            setattr(self, attr, copy.deepcopy(model).requires_grad_(False))
            getattr(self, attr).zero_grad(set_to_none=True)
        ema = getattr(self, attr)
        start = 0 if head == "flow" else len(list(self.model.parameters()))
        with torch.no_grad():
            for i, p in enumerate(ema.parameters()):
                p.copy_(self.state.ema_params[start + i])
        return ema

    def generate(self, n: int, method: Optional[str] = None, n_steps: Optional[int] = None,
                 y: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                 return_solution: bool = False) -> Union[Generated, Samples, ODESolution]:
        """Sample ``n`` points from the EMA parameters by ODE integration, with
        the preset's ``eval.ode_method`` and ``eval.ode_steps`` unless given.

        2-D branch: from the source distribution (drawn from ``generator``,
        default the trainer's); returns the float samples and the NFE. Image
        branch: from N(0, I) (``generator``, default seed 0); returns the
        uint8 images and the NFE. ``y`` (n,) are the class labels of a
        class-conditional model. ``return_solution=True`` returns the
        solver's ``ODESolution`` instead (float ``final`` and ``nfe``), and
        the image branch's noise then comes from the trainer's generator
        unless one is given.
        """
        cfg = self.cfg
        method, n_steps = method or cfg.eval.ode_method, n_steps or cfg.eval.ode_steps
        model = self._ema()
        if y is not None:
            y = torch.as_tensor(y, device=self.device)
        # dopri5 writes grid points by dense output and takes the two-point
        # span; tsit5 lands on every point of the n_steps-interval grid, as
        # the JAX Trainer gives it.
        ts = ([0.0, 1.0] if method == "dopri5"
              else np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32))
        if self.is_image and not return_solution:
            return generate(model, n, x_shape=tuple(cfg.model.image_dim), method=method,
                            n_steps=n_steps, y=y, generator=generator, device=self.device,
                            grid=ts if method == "tsit5" else None)
        g = generator or self.generator
        x0 = self._x0(n, g)
        with torch.inference_mode():
            sol = odeint(vector_field_from_model(model, y), x0, ts, method=method,
                         return_trajectory=False)
        return sol if return_solution else Samples(sol.final, sol.nfe)

    def _x0(self, n: int, g: torch.Generator) -> torch.Tensor:
        """n source points: N(0, I) images, or the 2-D branch's source."""
        if self.is_image:
            return torch.randn((n, *self.cfg.model.image_dim), generator=g, device=self.device)
        return self._source(g, n, self.device)

    def generate_sde(self, n: int, n_steps: Optional[int] = None, logqp: bool = False,
                     generator: Optional[torch.Generator] = None, method: str = "euler",
                     x0: Optional[torch.Tensor] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None) -> SDESolution:
        """Sample ``n`` points by the SDE dx = [v + s] dt + sigma dW of both
        heads' EMA parameters ([SF]2M), sigma ``matcher.sigma`` or 1 where it
        is 0, over ``n_steps`` (default ``eval.ode_steps``) intervals of
        [0, 1] with ``method`` ("euler" or "heun"). x0 and each step's
        normals come from ``generator`` (default the trainer's), or are
        given as ``x0`` and ``noise``. Returns the ``SDESolution`` (initial
        and final states, NFE, with ``logqp`` the KL of each sample)."""
        if self.score_model is None:
            raise ValueError("SDE generation requires a score head (matcher.score_head)")
        cfg = self.cfg
        n_steps = n_steps or cfg.eval.ode_steps
        g = generator or self.generator
        x0 = self._x0(n, g) if x0 is None else x0.to(self.device)
        sigma = cfg.matcher.sigma if cfg.matcher.sigma > 0 else 1.0
        solver = FlowSolver(drift=vector_field_from_model(self._ema("flow")),
                            score=vector_field_from_model(self._ema("score")), sigma=sigma)
        with torch.inference_mode():
            return solver.sdeint(None if noise is not None else g, x0,
                                 np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32),
                                 logqp=logqp, return_trajectory=False, method=method,
                                 noise=noise)

    def tracking_fid(self, gen: torch.Tensor) -> Optional[float]:
        """FID under the tracking features (``eval/fid.py``) between generated
        samples (floats in [-1, 1]) and the first 4096 training images; None
        without reference images. Its scale is not Inception FID's; only its
        trend means something. The samples become uint8 as JAX's
        ``tracking_fid`` makes them: ``(gen + 1) * 127.5``, clipped,
        truncated (not ``quantize_to_uint8``'s + 128)."""
        ref = getattr(self, "_ref_images_u8", None)
        if ref is None:
            return None
        from cfm_tpu_torch.eval.fid import (batched_features, fid_from_features,
                                            make_tracking_feature_fn)

        if self._tracking is None:
            fn = make_tracking_feature_fn(self.cfg.model.image_dim, device=self.device)
            self._tracking = (fn, batched_features(fn, ref, device=self.device))
        fn, ref_feats = self._tracking
        gen_u8 = torch.clamp((gen + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return fid_from_features(batched_features(fn, gen_u8, device=self.device), ref_feats)

    def evaluate(self, n: Optional[int] = None) -> Dict[str, float]:
        """``n`` samples (``eval.num_eval_samples``) generated from the EMA
        parameters with the configured method. 2-D branch: against ``n``
        fresh target points, the exact W1 and W2 and the NFE. Image branch:
        the float samples' mean and std, the NFE and the tracking FID. With
        a score head and ``eval.sde``, also ``sde_kl``, the mean KL of an
        SDE rollout of ``n`` samples (``generate_sde``), and on the 2-D
        branch ``sde_w2``, its W2 against the same target points."""
        cfg = self.cfg
        n = n or cfg.eval.num_eval_samples
        sol = self.generate(n, return_solution=True)
        gen, nfe = sol.final, float(sol.nfe)
        target = None
        if self.is_image:
            out = {"gen_mean": float(gen.mean()), "gen_std": float(gen.std(correction=0)),
                   "nfe": nfe}
            tfid = self.tracking_fid(gen)
            if tfid is not None:
                out["tracking_fid"] = tfid
        else:
            target = self._target(self.generator, n, self.device)
            out = {"w1": float(wasserstein(gen, target, power=1)),
                   "w2": float(wasserstein(gen, target, power=2)),
                   "nfe": nfe}
        if self.score_model is not None and cfg.eval.sde:
            sde = self.generate_sde(n, logqp=True)
            out["sde_kl"] = float(sde.logqp.mean())
            if target is not None:
                out["sde_w2"] = float(wasserstein(sde.final, target, power=2))
        return out
