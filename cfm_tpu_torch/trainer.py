"""Experiment harness, image branch on one device (counterpart of
``cfm_tpu/trainer.py``): config -> model, matcher, data -> ``fit``.

The uint8 set goes to the device once (``data.on_device``, the default) and
each step draws batch indices there; the step's prep (normalise, flip, draw
x0) and the train step run on the device with one generator seeded from
``trainer.seed``. The loss is read back only at ``log_interval``. With
``model.class_cond`` the labels go to the device beside the images and are
gathered with the same indices (y0 = y1 = the batch's labels), and the step
carries them through the coupling into the model's class embedding.
``generate`` samples from the EMA parameters by ODE integration.

Not ported yet, and refused loudly when asked for: checkpointing and
evaluation (``fit`` raises if a checkpoint or an evaluation would fall due),
SDE generation (ROADMAP.md queue 1 item 2), the data-parallel mesh (raises
with more than one card unless ``trainer.data_parallel=False``) and the 2-D
branch. Class-conditional I-CFM is refused as the JAX package fails on it:
its matcher carries no labels. The harness writes no log files.
"""

from __future__ import annotations

import copy
import time
from typing import Optional, Tuple

import numpy as np
import torch

from cfm_tpu_torch.config import Config
from cfm_tpu_torch.data.images import (infinite_batches, load_cifar10, load_mnist,
                                       normalize_images, random_hflip)
from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.generate import Generated, generate
from cfm_tpu_torch.models.unet import UNetModelWrapper
from cfm_tpu_torch.paths import ConditionalFlowMatcher, ExactOptimalTransportConditionalFlowMatcher
from cfm_tpu_torch.train import TrainState, init_train_state, make_optimizer, make_train_step


def build_matcher(cfg: Config):
    kind, sigma = cfg.matcher.kind, cfg.matcher.sigma
    if kind == "icfm":
        return ConditionalFlowMatcher(sigma=sigma)
    if kind == "otcfm":
        return ExactOptimalTransportConditionalFlowMatcher(sigma=sigma)
    raise NotImplementedError(f"matcher {kind!r} is not ported yet (ROADMAP.md queue 1 "
                              f"item 6); the port has icfm and otcfm")


def build_model(cfg: Config, device: DeviceLike = None):
    m = cfg.model
    if m.kind != "unet":
        raise NotImplementedError(f"model kind {m.kind!r} is not ported yet (ROADMAP.md "
                                  f"queue 1 item 5)")
    return UNetModelWrapper(
        dim=m.image_dim, num_channels=m.num_channels, num_res_blocks=m.num_res_blocks,
        channel_mult=m.channel_mult, num_heads=m.num_heads,
        num_head_channels=m.num_head_channels, attention_resolutions=m.attention_resolutions,
        dropout=m.dropout, use_scale_shift_norm=m.use_scale_shift_norm,
        resblock_updown=m.resblock_updown, class_cond=m.class_cond, num_classes=m.num_classes,
        dtype=torch.bfloat16 if m.bf16 else torch.float32, seed=cfg.trainer.seed,
        device=device)


class Trainer:
    """Config-driven training of the image branch on one device."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        self.cfg = cfg
        if cfg.data.dataset not in ("cifar10", "mnist"):
            raise NotImplementedError(f"dataset {cfg.data.dataset!r}: the 2-D branch is not "
                                      f"ported yet (ROADMAP.md queue 1 item 5)")
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
        self.step_fn = make_train_step(self.matcher, self.model, self.optimizer,
                                       ema_decay=cfg.optim.ema_decay,
                                       train_mode=cfg.model.dropout > 0,
                                       class_conditional=cfg.model.class_cond)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.trainer.seed)
        print(f"model: {cfg.model.kind}  params: {sum(p.numel() for p in self.state.params):,}"
              f"  device: {self.device}")

        self._ema_model: Optional[torch.nn.Module] = None

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

    def _refuse_unported(self, start: int, total: int) -> None:
        t = self.cfg.trainer
        for what, every in (("a checkpoint", t.ckpt_interval), ("an evaluation", t.eval_interval)):
            if every > 0 and total // every > start // every:
                raise NotImplementedError(
                    f"{what} falls due at step {(start // every + 1) * every} of this fit, and "
                    f"checkpointing and evaluation are not ported yet (ROADMAP.md queue 1 "
                    f"items 4 and 9); set trainer.ckpt_interval=0 and trainer.eval_interval=0 "
                    f"or fit fewer steps")

    def fit(self, max_steps: Optional[int] = None) -> TrainState:
        cfg = self.cfg
        total = cfg.trainer.total_steps if max_steps is None else max_steps
        start = self.state.step
        self._refuse_unported(start, total)
        last_t, last_step = time.perf_counter(), start
        for i in range(start, total):
            x1_u8, y = self._batch()
            x0, x1 = self._prep(x1_u8)
            labels = (y, y) if y is not None else ()
            metrics = self.step_fn(self.state, x0, x1, *labels, generator=self.generator)
            step = i + 1
            if step % cfg.trainer.log_interval == 0 or step == total:
                out = {k: float(v) for k, v in metrics.items()}  # the one host read
                now = time.perf_counter()
                sps = (step - last_step) / max(now - last_t, 1e-9)
                last_t, last_step = now, step
                print(f"step {step:7d}  loss {out['loss']:.4f}  {sps:.2f} steps/s")
                if not np.isfinite(out["loss"]):
                    raise ValueError(f"Loss Not Finite at step {step}: {out['loss']}")
        return self.state

    def generate(self, n: int, method: Optional[str] = None, n_steps: Optional[int] = None,
                 y: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Generated:
        """Sample ``n`` images from the EMA parameters by ODE integration from
        N(0, I), with the preset's ``eval.ode_method`` and ``eval.ode_steps``
        unless given; ``y`` (n,) are the class labels of a class-conditional
        model. Returns the uint8 images and the NFE."""
        cfg = self.cfg
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.model).requires_grad_(False)
            self._ema_model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, e in zip(self._ema_model.parameters(), self.state.ema_params):
                p.copy_(e)
        if y is not None:
            y = torch.as_tensor(y, device=self.device)
        return generate(self._ema_model, n, x_shape=tuple(cfg.model.image_dim),
                        method=method or cfg.eval.ode_method,
                        n_steps=n_steps or cfg.eval.ode_steps, y=y, generator=generator,
                        device=self.device)
