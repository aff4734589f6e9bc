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

Data parallelism runs one process per card under ``torch.distributed``
(``cfm_tpu_torch.parallel``), where JAX runs one SPMD program over a mesh.
A step built with ``data_axis`` all-reduces its gradients and metrics (one
flat buffer, SUM then a division by the ranks, as ``pmean`` does) before
the clip and Adam, so every rank applies the same mean gradient.
:func:`make_data_parallel_train_step` couples the global batch identically
on every rank and trains each rank on its rows;
:func:`make_data_parallel_step` computes the one-process step on the
gathered batch in pieces; :func:`make_data_parallel_sample_fn` integrates
each rank's rows of the global noise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from cfm_tpu_torch.parallel.mesh import (axis_group, axis_index, make_mesh as _make_mesh,
                                         rank_device, rank_streams)
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


def _all_reduce_flat(tensors: List[torch.Tensor], group, scale: float) -> List[torch.Tensor]:
    """The tensors summed over ``group`` in one collective (one flat float32
    buffer) and multiplied by ``scale``; views of that buffer, shaped as
    given."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def make_train_step(matcher, model: torch.nn.Module, optimizer: Optimizer,
                    ema_decay: float = 0.9999, train_mode: bool = False,
                    class_conditional: bool = False,
                    score_model: Optional[torch.nn.Module] = None,
                    data_axis: Optional[Union[str, Tuple[str, ...]]] = None,
                    mesh=None) -> Callable:
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

    ``data_axis`` (a mesh axis name, or a tuple of them; the default process
    group without ``mesh``): each rank runs the step on its own rows, and
    the gradients and metrics are averaged over the axis's ranks (one
    all-reduce of a flat buffer, SUM then / ranks, JAX's ``pmean``) before
    the clip, so the clip and ``grad_norm`` see the mean gradient, as optax
    does after ``pmean``. The step is tagged with the axis
    (``step._data_axis``) for :func:`cfm_tpu_torch.parallel.local_coupling_step`.
    """
    coupled = _is_coupled(matcher)
    group = None if data_axis is None else axis_group(mesh, data_axis)
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

    def run(state, x0, x1, y0, y1, generator, draws, rows=None, weight=1.0, group=None,
            scale=1.0, reduce_status=True) -> Dict[str, torch.Tensor]:
        """The step; ``rows`` (a slice) trains on those rows of the flow's
        batch with the losses times ``weight``; with ``group`` the gradients
        and the metrics (``coupling_degenerate`` only with ``reduce_status``)
        are summed over it in one all-reduce and multiplied by ``scale``."""
        if draws is None:
            flash = coupled and not class_conditional and matcher.ot_sampler._use_flash(x0, x1)
            draws = StepDraws.draw(generator, x0, coupled, train_mode,
                                   flash_m=x1.shape[0] if flash else None)
        t, xt, ut, eps, cond, bad = flow(draws, x0, x1, y0, y1)
        if rows is not None:
            t, xt, ut, eps = t[rows], xt[rows], ut[rows], eps[rows]
            cond = tuple(c[rows] for c in cond)
        scaled = (lambda v: v) if weight == 1.0 else (lambda v: v * weight)
        flow_loss = scaled(torch.mean(torch.square(call(model, t, xt, cond, draws) - ut)))
        metrics = {"flow_loss": flow_loss.detach(), "coupling_degenerate": bad.float()}
        loss = flow_loss
        if score_model is not None:
            st = call(score_model, t, xt, cond, draws)
            lam = matcher.compute_lambda(t).reshape(-1, *([1] * (st.dim() - 1)))
            score_loss = scaled(torch.mean(torch.square(lam * st + eps)))
            metrics["score_loss"] = score_loss.detach()
            loss = flow_loss + score_loss
        metrics["loss"] = loss.detach()
        for p in state.params:
            p.grad = None
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in state.params]
        if group is not None:
            names = [k for k in metrics if reduce_status or k != "coupling_degenerate"]
            out = _all_reduce_flat(grads + [metrics[k] for k in names], group, scale)
            grads = out[:len(grads)]
            metrics.update(zip(names, out[len(grads):]))
        metrics["grad_norm"] = optimizer.apply(state.params, grads, state.opt_state)
        ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        return metrics

    def step_run(state, x0, x1, y0, y1, generator, draws):
        if group is None:
            return run(state, x0, x1, y0, y1, generator, draws)
        return run(state, x0, x1, y0, y1, generator, draws, group=group,
                   scale=1.0 / dist.get_world_size(group))

    if class_conditional:
        def step(state: TrainState, x0: torch.Tensor, x1: torch.Tensor, y0: torch.Tensor,
                 y1: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
            return step_run(state, x0, x1, y0, y1, generator, draws)
    else:
        def step(state: TrainState, x0: torch.Tensor, x1: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
            return step_run(state, x0, x1, None, None, generator, draws)
    step._data_axis = data_axis
    step._run = run
    step._class_conditional = class_conditional
    return step


def _labels(class_conditional: bool, labels) -> Tuple:
    if class_conditional and len(labels) != 2:
        raise ValueError("a class-conditional step takes x0, x1, y0, y1")
    return tuple(labels) if labels else (None, None)


def make_data_parallel_step(train_step: Callable, mesh, data_axis: str = "data") -> Callable:
    """The one-process ``train_step`` (from :func:`make_train_step`, built
    without ``data_axis``) on the batch gathered from the ranks, computed in
    pieces: JAX's jit over a batch-sharded mesh, where XLA partitions the
    step and inserts the gradient psum.

    Returns ``step(state, x0, x1, *labels, generator=None, draws=None)``
    with x0, x1 (and labels) this rank's rows. The rows are all-gathered,
    coupled and drawn identically on every rank (``generator`` seeded alike,
    or ``draws`` of the global batch); each rank trains on its rows with its
    losses weighted by its share of the batch, and the gradients and losses
    are summed over the ranks: the mean over the gathered batch."""
    group = axis_group(mesh, data_axis)
    idx, count = axis_index(mesh, data_axis)
    run = train_step._run

    def gather(t):
        if t is None:
            return None
        parts = [torch.empty_like(t) for _ in range(count)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    def step(state, x0, x1, *labels, generator: Optional[torch.Generator] = None,
             draws: Optional[StepDraws] = None):
        y0, y1 = _labels(train_step._class_conditional, labels)
        b = x0.shape[0]
        return run(state, gather(x0), gather(x1), gather(y0), gather(y1), generator, draws,
                   rows=slice(idx * b, (idx + 1) * b), weight=1.0 / count, group=group,
                   reduce_status=False)

    return step


def make_replicated_coupling_shard_fn(matcher, model: torch.nn.Module, optimizer: Optimizer,
                                      mesh, data_axis="data", **step_kwargs) -> Callable:
    """The per-rank body of :func:`make_data_parallel_train_step`.

    ``shard_fn(state, x0, x1, *labels, generator=None, draws=None,
    plan_noise=None)`` takes the global batch, the same on every rank. It
    couples the whole batch identically on every rank (the plan's uniforms
    ``plan_noise``, or drawn from ``generator``, seeded alike on every
    rank; kernel #5 at n = 128 on the card), slices this rank's rows by its
    row-major index over the ``data_axis`` axes, and runs the uncoupled step
    built with ``data_axis`` on them (gradients and metrics averaged over
    the ranks). The path noise (t, eps, dropout) is the rank's own: from
    its stream (:func:`cfm_tpu_torch.parallel.mesh.rank_streams`), or this
    rank's ``draws``.
    ``coupling_degenerate`` is the global plan's status. A batch that does
    not divide over the ranks raises."""
    coupled = _is_coupled(matcher)
    inner = make_train_step(matcher.without_coupling() if coupled else matcher, model, optimizer,
                            data_axis=data_axis, mesh=mesh, **step_kwargs)
    idx, count = axis_index(mesh, data_axis)
    stream = rank_streams(idx)

    def shard_fn(state, x0, x1, *labels, generator: Optional[torch.Generator] = None,
                 draws: Optional[StepDraws] = None, plan_noise: Optional[torch.Tensor] = None):
        y0, y1 = _labels(inner._class_conditional, labels)
        if x0.shape[0] % count:
            raise ValueError(f"global batch {x0.shape[0]} must divide over {count} devices")
        bad = None
        if coupled:
            sampler = matcher.ot_sampler
            if inner._class_conditional:
                x0, x1, y0, y1, bad = sampler.sample_plan_with_labels(
                    generator, x0, x1, y0, y1, return_status=True, noise=plan_noise)
            else:
                x0, x1, bad = sampler.sample_plan(generator, x0, x1, return_status=True,
                                                  noise=plan_noise)
        shard = x0.shape[0] // count
        rows = [None if t is None else t[idx * shard:(idx + 1) * shard] for t in (x0, x1, y0, y1)]
        if draws is None:
            generator = stream(generator)
        labels = rows[2:] if inner._class_conditional else ()
        metrics = inner(state, rows[0], rows[1], *labels, generator=generator, draws=draws)
        if bad is not None:
            metrics["coupling_degenerate"] = bad.float()
        return metrics

    shard_fn._data_axis = data_axis
    return shard_fn


def make_data_parallel_train_step(matcher, model: torch.nn.Module, optimizer: Optimizer, mesh,
                                  data_axis="data", **step_kwargs) -> Callable:
    """Data-parallel train step with the global OT coupling replicated.

    Every rank solves the same (B, B) coupling of the global batch (at B =
    128 a fraction of a millisecond against the UNet's forward and backward)
    and trains on its rows, so the plan sees the whole batch, as the
    one-process step (``train_cifar10.py``) does, unlike the per-rank plans
    of :func:`cfm_tpu_torch.parallel.local_coupling_step` (the reference
    DDP's). One all-reduce a step: the gradients and metrics in one flat
    buffer. The batch is moved to the rank's device; otherwise this is
    :func:`make_replicated_coupling_shard_fn`."""
    shard_fn = make_replicated_coupling_shard_fn(matcher, model, optimizer, mesh, data_axis,
                                                 **step_kwargs)
    device = rank_device(mesh)

    def step(state, x0, x1, *labels, **kw):
        return shard_fn(state, x0.to(device), x1.to(device), *(t.to(device) for t in labels),
                        **kw)

    step._data_axis = data_axis
    return step


def make_data_parallel_sample_fn(model: torch.nn.Module, mesh, n: int,
                                 x_shape: Tuple[int, ...], method: str = "euler",
                                 n_steps: int = 100, rtol: float = 1e-5, atol: float = 1e-5,
                                 data_axis="data", gather: bool = False) -> Callable:
    """Batch-sharded ODE sampling: the inference counterpart of the
    data-parallel step. ``sample(generator=None, x0=None)`` draws the global
    noise (n, *x_shape) from ``generator`` (seeded alike on every rank; or
    takes it as ``x0``), slices this rank's rows and integrates them from
    ``model`` (this rank's replica): no collectives, so the output equals
    one-process sampling of the same noise row for row. Adaptive methods
    (dopri5, tsit5) get the two-point span. Returns this rank's rows, or
    with ``gather`` all n in rank order."""
    from cfm_tpu_torch.integrate import odeint, vector_field_from_model

    idx, count = axis_index(mesh, data_axis)
    if n % count:
        raise ValueError(f"n={n} must divide over {count} devices")
    shard = n // count
    ts = ([0.0, 1.0] if method in ("dopri5", "tsit5")
          else np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32))
    device = rank_device(mesh)
    group = axis_group(mesh, data_axis)

    def sample(generator: Optional[torch.Generator] = None,
               x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x0 is None:
            x0 = torch.randn((n,) + tuple(x_shape), generator=generator, device=device)
        x0 = x0[idx * shard:(idx + 1) * shard].to(device)
        with torch.inference_mode():
            final = odeint(vector_field_from_model(model), x0, ts, method=method, rtol=rtol,
                           atol=atol, return_trajectory=False).final
        if not gather:
            return final
        parts = [torch.empty_like(final) for _ in range(count)]
        dist.all_gather(parts, final.contiguous(), group=group)
        return torch.cat(parts)

    return sample


def make_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """A 1-D mesh over the process group's ranks (``n_devices``, when given,
    must be their number): :func:`cfm_tpu_torch.parallel.make_mesh`."""
    return _make_mesh((axis,), None if n_devices is None else (n_devices,))
