"""Experiment harness on one device (counterpart of ``cfm_tpu/trainer.py``):
config -> model, matcher, data -> ``fit``, ``generate``, ``evaluate``.

The 2-D branch (the ``2d_*`` presets): each step draws x0 from the source
and x1 from the target generator on the device, then runs the train step
(its draws from the same generator, seeded from ``trainer.seed``). Every
``eval_interval`` steps ``fit`` calls ``evaluate``: 2048 points generated
from the EMA parameters (euler, 100 steps in the presets) against fresh
target points by the exact W1 and W2 (two assignment solves at n = 2048,
the row-tiled auction kernel on the card, scipy on the CPU), with early
stopping on an evaluation metric.

The image branch: the uint8 set goes to the device once
(``data.on_device``, the default) and each step draws batch indices there;
the step's prep (normalise, flip, draw x0) and the train step run on the
device. With ``model.class_cond`` the labels go to the device beside the
images and are gathered with the same indices (y0 = y1 = the batch's
labels), and the step carries them through the coupling into the model's
class embedding. ``generate`` samples from the EMA parameters by ODE
integration. The loss is read back only at ``log_interval``.

Not ported yet, and refused loudly when asked for: checkpointing (``fit``
raises if a checkpoint would fall due), the image branch's evaluation
(tracking FID, ROADMAP.md queue 1 item 4), the score head (item 6), SDE
generation (item 2) and the data-parallel mesh (raises with more than one
card unless ``trainer.data_parallel=False``). Class-conditional I-CFM is
refused as the JAX package fails on it: its matcher carries no labels. The
harness writes no log files; ``eval_log`` keeps the evaluations.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from cfm_tpu_torch.config import Config
from cfm_tpu_torch.coupling import wasserstein
from cfm_tpu_torch.data.images import (infinite_batches, load_cifar10, load_mnist,
                                       normalize_images, random_hflip)
from cfm_tpu_torch.data.toy import _DIM_AWARE, two_dim_data
from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.generate import Generated, generate
from cfm_tpu_torch.integrate import odeint, vector_field_from_model
from cfm_tpu_torch.models.mlp import MLP
from cfm_tpu_torch.models.unet import UNetModelWrapper
from cfm_tpu_torch.paths import (ConditionalFlowMatcher,
                                 ExactOptimalTransportConditionalFlowMatcher,
                                 SchrodingerBridgeConditionalFlowMatcher,
                                 TargetConditionalFlowMatcher,
                                 VariancePreservingConditionalFlowMatcher)
from cfm_tpu_torch.train import TrainState, init_train_state, make_optimizer, make_train_step

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


def build_model(cfg: Config, device: DeviceLike = None):
    m = cfg.model
    if m.kind == "mlp":
        dim = (_vector_dim(cfg) or 2) if cfg.data.dataset in _2D_SETS else int(np.prod(m.image_dim))
        return MLP(dim=dim, w=m.width, seed=cfg.trainer.seed, device=device)
    if m.kind != "unet":
        raise ValueError(f"Unknown model kind: {m.kind}")
    return UNetModelWrapper(
        dim=m.image_dim, num_channels=m.num_channels, num_res_blocks=m.num_res_blocks,
        channel_mult=m.channel_mult, num_heads=m.num_heads,
        num_head_channels=m.num_head_channels, attention_resolutions=m.attention_resolutions,
        dropout=m.dropout, use_scale_shift_norm=m.use_scale_shift_norm,
        resblock_updown=m.resblock_updown, class_cond=m.class_cond, num_classes=m.num_classes,
        dtype=torch.bfloat16 if m.bf16 else torch.float32, seed=cfg.trainer.seed,
        device=device)


class Trainer:
    """Config-driven training of the 2-D and image branches on one device."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.cfg = cfg
        self.is_image = cfg.data.dataset in ("cifar10", "mnist")
        if cfg.matcher.score_head:
            raise NotImplementedError("the score head ([SF]2M) is not ported yet (ROADMAP.md "
                                      "queue 1 item 6)")
        if cfg.trainer.data_parallel and torch.cuda.device_count() > 1:
            raise NotImplementedError(
                "the data-parallel mesh is not ported yet (ROADMAP.md queue 1 item 10); "
                "set trainer.data_parallel=False to train on one card")
        self.device = resolve_device(device)
        self.matcher = build_matcher(cfg)
        self.model = build_model(cfg, self.device)
        self.optimizer = make_optimizer(lr=cfg.optim.lr, warmup_steps=cfg.optim.warmup_steps,
                                        grad_clip=cfg.optim.grad_clip,
                                        weight_decay=cfg.optim.weight_decay)
        self.state: TrainState = init_train_state(self.model, self.optimizer)
        dropout = cfg.model.kind == "unet" and cfg.model.dropout > 0  # the MLP has none
        self.step_fn = make_train_step(self.matcher, self.model, self.optimizer,
                                       ema_decay=cfg.optim.ema_decay, train_mode=dropout,
                                       class_conditional=cfg.model.class_cond)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.trainer.seed)
        print(f"model: {cfg.model.kind}  params: {sum(p.numel() for p in self.state.params):,}"
              f"  device: {self.device}")

        self._ema_model: Optional[torch.nn.Module] = None
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

    def _batch(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The next uint8 batch on the device, and its labels when the model
        is class-conditional (else None)."""
        if self._device_data is not None:
            idx = torch.randint(0, self._device_data.shape[0], (self.cfg.data.batch_size,),
                                generator=self.generator, device=self.device)
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

    def _vectors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """x0 from the source and x1 from the target, drawn on the device."""
        bs = self.cfg.data.batch_size
        return (self._source(self.generator, bs, self.device),
                self._target(self.generator, bs, self.device))

    def _refuse_unported(self, start: int, total: int) -> None:
        t = self.cfg.trainer
        due = [("a checkpoint", t.ckpt_interval, "checkpointing is not ported yet (ROADMAP.md "
                "queue 1 item 9); set trainer.ckpt_interval=0")]
        if self.is_image:
            due.append(("an evaluation", t.eval_interval, "the image branch's evaluation is "
                        "not ported yet (ROADMAP.md queue 1 item 4); set trainer.eval_interval=0"))
        for what, every, why in due:
            if every > 0 and total // every > start // every:
                due_at = (start // every + 1) * every
                raise NotImplementedError(f"{what} falls due at step {due_at} of this fit, and "
                                          f"{why} or fit fewer steps")

    def fit(self, max_steps: Optional[int] = None) -> TrainState:
        t = self.cfg.trainer
        total = t.total_steps if max_steps is None else max_steps
        start = self.state.step
        if t.early_stop_metric and not t.eval_interval:
            raise ValueError("early_stop_metric requires eval_interval > 0")
        self._refuse_unported(start, total)
        last_t, last_step = time.perf_counter(), start
        es_best, es_bad = float("inf"), 0
        for i in range(start, total):
            if self.is_image:
                x1_u8, y = self._batch()
                x0, x1 = self._prep(x1_u8)
                labels = (y, y) if y is not None else ()
            else:
                (x0, x1), labels = self._vectors(), ()
            metrics = self.step_fn(self.state, x0, x1, *labels, generator=self.generator)
            step = i + 1
            if step % t.log_interval == 0 or step == total:
                out = {k: float(v) for k, v in metrics.items()}  # the one host read
                now = time.perf_counter()
                sps = (step - last_step) / max(now - last_t, 1e-9)
                last_t, last_step = now, step
                print(f"step {step:7d}  loss {out['loss']:.4f}  {sps:.2f} steps/s")
                if not np.isfinite(out["loss"]):
                    raise ValueError(f"Loss Not Finite at step {step}: {out['loss']}")
            if t.eval_interval and step % t.eval_interval == 0:
                t0 = time.perf_counter()
                ev = self.evaluate()
                self.eval_log.append({"step": step, **ev, "seconds": time.perf_counter() - t0})
                print("  eval:", {k: round(v, 4) for k, v in self.eval_log[-1].items()})
                if t.early_stop_metric:  # mode min, patience counted in evaluations
                    cur = ev[self._early_stop_key(ev)]
                    if cur < es_best - t.early_stop_min_delta:
                        es_best, es_bad = cur, 0
                    else:
                        es_bad += 1
                        if es_bad >= t.early_stop_patience:
                            print(f"early stop at step {step}: {t.early_stop_metric} did not "
                                  f"improve past {es_best:.4f} for {es_bad} evals")
                            break
        return self.state

    def _early_stop_key(self, ev: Dict[str, float]) -> str:
        """The metric's key in ``ev``; the logged "eval/" spelling is accepted."""
        es = self.cfg.trainer.early_stop_metric
        key = es[5:] if es.startswith("eval/") else es
        if key not in ev:
            raise ValueError(f"early_stop_metric {es!r} is not an eval metric; available: "
                             f"{sorted(ev)}")
        return key

    def _ema(self) -> torch.nn.Module:
        """The model with the EMA parameters (a copy kept across calls)."""
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.model).requires_grad_(False)
            self._ema_model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, e in zip(self._ema_model.parameters(), self.state.ema_params):
                p.copy_(e)
        return self._ema_model

    def generate(self, n: int, method: Optional[str] = None, n_steps: Optional[int] = None,
                 y: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Union[Generated, Samples]:
        """Sample ``n`` points from the EMA parameters by ODE integration, with
        the preset's ``eval.ode_method`` and ``eval.ode_steps`` unless given.

        2-D branch: from the source distribution (drawn from ``generator``,
        default the trainer's), returns the float samples and the NFE. Image
        branch: from N(0, I), returns the uint8 images and the NFE; ``y``
        (n,) are the class labels of a class-conditional model.
        """
        cfg = self.cfg
        method, n_steps = method or cfg.eval.ode_method, n_steps or cfg.eval.ode_steps
        model = self._ema()
        if not self.is_image:
            x0 = self._source(generator or self.generator, n, self.device)
            ts = ([0.0, 1.0] if method == "dopri5"
                  else np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32))
            with torch.inference_mode():
                sol = odeint(vector_field_from_model(model), x0, ts, method=method,
                             return_trajectory=False)
            return Samples(sol.final, sol.nfe)
        if y is not None:
            y = torch.as_tensor(y, device=self.device)
        return generate(model, n, x_shape=tuple(cfg.model.image_dim), method=method,
                        n_steps=n_steps, y=y, generator=generator, device=self.device)

    def evaluate(self, n: Optional[int] = None) -> Dict[str, float]:
        """2-D branch: ``n`` points (``eval.num_eval_samples``) generated from
        the EMA parameters against ``n`` fresh target points: the exact W1
        and W2 and the NFE."""
        if self.is_image:
            raise NotImplementedError("the image branch's evaluation (tracking FID) is not "
                                      "ported yet (ROADMAP.md queue 1 item 4)")
        n = n or self.cfg.eval.num_eval_samples
        gen = self.generate(n)
        target = self._target(self.generator, n, self.device)
        return {"w1": float(wasserstein(gen.samples, target, power=1)),
                "w2": float(wasserstein(gen.samples, target, power=2)),
                "nfe": float(gen.nfe)}
