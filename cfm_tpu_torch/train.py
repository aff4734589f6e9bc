"""Training: the CFM train step, the optimizer recipe and EMA (counterpart of
``cfm_tpu/train.py``).

The step is the JAX step's arithmetic in eager PyTorch: the coupled path
sample (exact OT through the auction kernel on the card, or the entropic
plan through the flash Sinkhorn kernel at 2048^2), the model's forward and
backward (the UNet's attention blocks through their kernels), optionally a
score head's loss ([SF]2M), global-norm clip, Adam with the warmup
schedule, EMA. It reads nothing back to the host: the metrics are 0-d device
tensors and the learning rate is a host-side function of the host-side step
count.

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
    optimizer state and the host-side step count. With a score head the
    lists hold the flow model's parameters first, then the score model's."""

    params: List[torch.nn.Parameter]
    ema_params: List[torch.Tensor]
    opt_state: OptState
    step: int = 0


def init_train_state(model: torch.nn.Module, optimizer: Optimizer,
                     score_model: Optional[torch.nn.Module] = None) -> TrainState:
    """The state of ``model`` (and ``score_model``: one optimizer, clip and
    EMA span both heads, as optax does over JAX's {"flow", "score"} pair)."""
    params = list(model.parameters())
    if score_model is not None:
        params += list(score_model.parameters())
    # The EMA starts as a copy of the parameters, not an alias.
    return TrainState(params, [p.detach().clone() for p in params], optimizer.init(params))


@dataclasses.dataclass
class StepDraws:
    """The random numbers of one train step.

    t (B,) and eps (like x0) feed the path; plan_u (B,) are the uniforms of
    the coupling's plan sampling (None for an uncoupled matcher); dropout is
    the generator the UNet draws its uint8 masks from (None without dropout).
    On the flash route the coupling draws instead gumbel (B, m), each row's
    Gumbel noise over the m partners, and uniform_j (B,), the partners of
    the uniform fallback.
    """

    t: torch.Tensor
    eps: torch.Tensor
    plan_u: Optional[torch.Tensor] = None
    dropout: Optional[torch.Generator] = None
    gumbel: Optional[torch.Tensor] = None
    uniform_j: Optional[torch.Tensor] = None

    @classmethod
    def draw(cls, generator: torch.Generator, x0: torch.Tensor, coupled: bool,
             dropout: bool, flash_m: Optional[int] = None) -> "StepDraws":
        """Draw in the matcher's order: the coupling's numbers (the plan
        uniforms, or with ``flash_m`` partners on the flash route the Gumbel
        noise and the fallback's partners), t, then eps."""
        B, dev = x0.shape[0], x0.device
        plan_u = gumbel = uniform_j = None
        if flash_m is not None:
            gumbel = -torch.empty((B, flash_m), device=dev).exponential_(
                generator=generator).log()
            uniform_j = torch.randint(0, flash_m, (B,), generator=generator, device=dev)
        elif coupled:
            plan_u = torch.rand(B, generator=generator, device=dev)
        t = torch.rand(B, generator=generator, device=dev, dtype=x0.dtype)
        eps = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
        return cls(t, eps, plan_u, generator if dropout else None, gumbel, uniform_j)


def _is_coupled(matcher) -> bool:
    return hasattr(matcher, "ot_sampler") and not getattr(matcher, "_skip_coupling", False)


def make_train_step(matcher, model: torch.nn.Module, optimizer: Optimizer,
                    ema_decay: float = 0.9999, train_mode: bool = False,
                    class_conditional: bool = False,
                    score_model: Optional[torch.nn.Module] = None) -> Callable:
    """Build ``step(state, x0, x1, generator=None, draws=None) -> metrics``,
    or with ``class_conditional`` ``step(state, x0, x1, y0, y1,
    generator=None, draws=None)``: the labels ride through the coupling
    (``guided_sample_location_and_conditional_flow``) and the model is
    called as ``model(t, xt, y1)``, as in the JAX step.

    ``train_mode`` runs the model with dropout (masks from the draws'
    generator). With ``score_model`` (the [SF]2M score head; the state from
    ``init_train_state(model, optimizer, score_model)``) the loss adds
    mean((lambda_t s + eps)^2), lambda from ``matcher.compute_lambda``. The
    metrics are 0-d device tensors: ``loss``, ``flow_loss`` (and
    ``score_loss``), ``coupling_degenerate`` (1.0 when the plan fell back to
    the uniform coupling) and ``grad_norm`` (before clipping, over every
    parameter of the state).
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
            t, xt, ut, _, y1_, eps, bad = matcher.guided_sample_location_and_conditional_flow(
                None, x0, x1, y0=y0, y1=y1, **kw)
            return t, xt, ut, eps, (y1_,), bad
        if coupled:
            kw.update(gumbel=draws.gumbel, uniform_j=draws.uniform_j)
        t, xt, ut, eps, bad = matcher.sample_location_and_conditional_flow(None, x0, x1, **kw)
        return t, xt, ut, eps, (), bad

    def call(net, t, xt, cond, draws):
        if train_mode:
            return net(t, xt, *cond, train=True, generator=draws.dropout)
        return net(t, xt, *cond)

    def run(state, x0, x1, y0, y1, generator, draws) -> Dict[str, torch.Tensor]:
        if draws is None:
            flash = coupled and not class_conditional and matcher.ot_sampler._use_flash(x0, x1)
            draws = StepDraws.draw(generator, x0, coupled, train_mode,
                                   flash_m=x1.shape[0] if flash else None)
        t, xt, ut, eps, cond, bad = flow(draws, x0, x1, y0, y1)
        flow_loss = torch.mean(torch.square(call(model, t, xt, cond, draws) - ut))
        metrics = {"flow_loss": flow_loss.detach(), "coupling_degenerate": bad.float()}
        loss = flow_loss
        if score_model is not None:
            st = call(score_model, t, xt, cond, draws)
            lam = matcher.compute_lambda(t).reshape(-1, *([1] * (st.dim() - 1)))
            score_loss = torch.mean(torch.square(lam * st + eps))
            metrics["score_loss"] = score_loss.detach()
            loss = flow_loss + score_loss
        for p in state.params:
            p.grad = None
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in state.params]
        metrics["grad_norm"] = optimizer.apply(state.params, grads, state.opt_state)
        ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        metrics["loss"] = loss.detach()
        return metrics

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
