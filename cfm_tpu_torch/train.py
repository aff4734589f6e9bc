"""Training: the CFM train step, the optimizer recipe and EMA (counterpart of
``cfm_tpu/train.py``).

The step is the JAX step's arithmetic in eager PyTorch: the coupled path
sample (exact OT through the auction kernel on the card), the UNet forward
and backward (the attention blocks through their forward and backward
kernels), global-norm clip, Adam with the warmup schedule, EMA. It reads
nothing back to the host: the metrics are 0-d device tensors and the
learning rate is a host-side function of the host-side step count.

The random draws are split from the arithmetic (:class:`StepDraws`): with a
generator the step draws them itself, or a test hands in the same numbers it
gives the JAX package. Parameters, moments and EMA are updated in place.

The data-parallel helpers wait for ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cfm_tpu_torch.utils import ema_update


def warmup_lr_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    """Linear warmup then constant, with the JAX package's deliberate shift:
    ``base_lr * min(step + 1, warmup) / warmup`` at the pre-increment count,
    evaluated in float32 as JAX does."""

    def schedule(step: int) -> float:
        if warmup_steps <= 0:
            return base_lr
        f32 = np.float32
        return float(f32(base_lr) * np.minimum(f32(step + 1.0), f32(warmup_steps))
                     / f32(warmup_steps))

    return schedule


@dataclasses.dataclass
class OptState:
    count: int                 # updates applied so far (host-side)
    mu: List[torch.Tensor]     # first moments
    nu: List[torch.Tensor]     # second moments


@dataclasses.dataclass
class Optimizer:
    """Global-norm clip, then Adam (or AdamW) with the warmup schedule: optax's
    ``chain(clip_by_global_norm, adam(warmup_lr_schedule))``.

    The clip follows optax: below ``grad_clip`` the gradients pass unchanged,
    above it they are scaled by ``grad_clip / norm`` (no 1e-6 added to the
    norm, unlike ``torch.nn.utils.clip_grad_norm_``; optax divides by the norm
    and then multiplies, this multiplies once, a difference of one rounding).
    The moments use PyTorch's multi-tensor (``_foreach``) arithmetic.
    """

    lr: float = 2e-4
    warmup_steps: int = 5000
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0
    eps: float = 1e-8

    def init(self, params: List[torch.Tensor]) -> OptState:
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: OptState) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; return the global norm of
        ``grads`` before clipping (a 0-d device tensor)."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip:
            factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                 self.grad_clip / norm)
            grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        state.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(state.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(state.count))
        denom = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(state.mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
        lr = warmup_lr_schedule(self.lr, self.warmup_steps)(state.count - 1)
        torch._foreach_add_(params, updates, alpha=-lr)
        return norm


def make_optimizer(lr: float = 2e-4, warmup_steps: int = 5000, grad_clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.999, weight_decay: float = 0.0) -> Optimizer:
    """Adam + linear warmup + global-norm clip: the CIFAR-10 recipe."""
    return Optimizer(lr, warmup_steps, grad_clip, b1, b2, weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model's parameters (updated in place), their EMA copies, the
    optimizer state and the host-side step count."""

    params: List[torch.nn.Parameter]
    ema_params: List[torch.Tensor]
    opt_state: OptState
    step: int = 0


def init_train_state(model: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    params = list(model.parameters())
    # The EMA starts as a copy of the parameters, not an alias.
    return TrainState(params, [p.detach().clone() for p in params], optimizer.init(params))


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one train step.

    t (B,) and eps (like x0) feed the path; plan_u (B,) are the uniforms of
    the coupling's plan sampling (None for an uncoupled matcher); dropout is
    the generator the UNet draws its uint8 masks from (None without dropout).
    """

    t: torch.Tensor
    eps: torch.Tensor
    plan_u: Optional[torch.Tensor] = None
    dropout: Optional[torch.Generator] = None

    @classmethod
    def draw(cls, generator: torch.Generator, x0: torch.Tensor, coupled: bool,
             dropout: bool) -> "StepDraws":
        """Draw in the matcher's order: plan uniforms, t, then eps."""
        B, dev = x0.shape[0], x0.device
        plan_u = torch.rand(B, generator=generator, device=dev) if coupled else None
        t = torch.rand(B, generator=generator, device=dev, dtype=x0.dtype)
        eps = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
        return cls(t, eps, plan_u, generator if dropout else None)


def _is_coupled(matcher) -> bool:
    return hasattr(matcher, "ot_sampler") and not getattr(matcher, "_skip_coupling", False)


def make_train_step(matcher, model: torch.nn.Module, optimizer: Optimizer,
                    ema_decay: float = 0.9999, train_mode: bool = False,
                    class_conditional: bool = False) -> Callable:
    """Build ``step(state, x0, x1, generator=None, draws=None) -> metrics``,
    or with ``class_conditional`` ``step(state, x0, x1, y0, y1,
    generator=None, draws=None)``: the labels ride through the coupling
    (``guided_sample_location_and_conditional_flow``) and the model is
    called as ``model(t, xt, y1)``, as in the JAX step.

    ``train_mode`` runs the model with dropout (masks from the draws'
    generator). The metrics are 0-d device tensors: ``loss``, ``flow_loss``,
    ``coupling_degenerate`` (1.0 when the plan fell back to the uniform
    coupling) and ``grad_norm`` (before clipping).
    """
    coupled = _is_coupled(matcher)
    if class_conditional and not hasattr(matcher, "guided_sample_location_and_conditional_flow"):
        raise ValueError(f"class-conditional training needs a coupled matcher (otcfm); "
                         f"{type(matcher).__name__} carries no labels, as in the JAX package")

    def flow(draws, x0, x1, y0, y1):
        kw = dict(t=draws.t, eps=draws.eps, return_noise=True, return_coupling_status=True)
        if coupled:
            kw["plan_noise"] = draws.plan_u
        if class_conditional:
            t, xt, ut, _, y1_, _, bad = matcher.guided_sample_location_and_conditional_flow(
                None, x0, x1, y0=y0, y1=y1, **kw)
            return t, xt, ut, (y1_,), bad
        t, xt, ut, _, bad = matcher.sample_location_and_conditional_flow(None, x0, x1, **kw)
        return t, xt, ut, (), bad

    def run(state, x0, x1, y0, y1, generator, draws) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = StepDraws.draw(generator, x0, coupled, train_mode)
        t, xt, ut, cond, bad = flow(draws, x0, x1, y0, y1)
        if train_mode:
            vt = model(t, xt, *cond, train=True, generator=draws.dropout)
        else:
            vt = model(t, xt, *cond)
        flow_loss = torch.mean(torch.square(vt - ut))
        for p in state.params:
            p.grad = None
        flow_loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in state.params]
        grad_norm = optimizer.apply(state.params, grads, state.opt_state)
        ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        loss = flow_loss.detach()
        return {"loss": loss, "flow_loss": loss, "coupling_degenerate": bad.float(),
                "grad_norm": grad_norm}

    if class_conditional:
        def step(state: TrainState, x0: torch.Tensor, x1: torch.Tensor, y0: torch.Tensor,
                 y1: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
            return run(state, x0, x1, y0, y1, generator, draws)
    else:
        def step(state: TrainState, x0: torch.Tensor, x1: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
            return run(state, x0, x1, None, None, generator, draws)
    return step
