"""Augmented-ODE regularisation and the CNF log-likelihood (counterpart of
``cfm_tpu/augment.py``).

An augmented field maps (t, AugmentedState(x, logp, regs)) to the state's
rates: the drift, the log-density rate -tr(df/dx) and per-sample
regulariser rates. It integrates with the same ``integrate.odeint`` as a
plain field (the state is a NamedTuple, whose leaves ``odeint`` steps
together).

Per-sample meaning. As JAX vmaps a per-sample field, the traces and
Jacobians here are those of ``f(t, x_i[None])`` for each sample alone:
``torch.func.vmap`` over the samples of ``torch.func.jacrev`` (exact) or
``torch.func.vjp`` (Hutchinson), so a field that couples samples (batch
statistics) is held to JAX's meaning, not to the batch Jacobian's. The
field must therefore compose with ``torch.func``; the GroupNorm kernels'
wrapper does (``ops/groupnorm.py``: the mapped axis folded into N). The
results are differentiable by ordinary autograd, to second order, so a loss
can differentiate through a trace.

Rademacher probes. JAX splits its key per sample and draws (k, d) probes
for each; ``make_cnf_nll_loss`` passes the same key at every field
evaluation, so the probes are fixed along the path. The port draws them
once per call as a (bs, k, d) tensor from an explicit ``torch.Generator``,
or takes them as ``probes=``, and reuses them at every step (and for the
Hutchinson Jacobian regulariser, as JAX reuses the key).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import jacrev, jvp, vjp, vmap

VectorField = Callable[[float, torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# Per-sample regularizer rates r(t, x, dx) -> (bs,)
# --------------------------------------------------------------------------


def _axes(dx: torch.Tensor):
    return tuple(range(1, dx.dim()))


def l1_reg(t, x, dx):
    """mean |dx| per sample."""
    return torch.mean(torch.abs(dx), dim=_axes(dx))


def l2_reg(t, x, dx):
    """||dx||_2 per sample."""
    return torch.sqrt(torch.sum(torch.square(dx), dim=_axes(dx)) + 1e-12)


def squared_l2_reg(t, x, dx):
    """||dx||_2^2 per sample."""
    return torch.sum(torch.square(dx), dim=_axes(dx))


REGULARIZERS = {
    "l1": l1_reg,
    "l2": l2_reg,
    "squared_l2": squared_l2_reg,
}

JACOBIAN_REGULARIZERS = ("jac_frobenius", "jac_diag_frobenius", "jac_offdiag_frobenius")


def rademacher(generator: Optional[torch.Generator], shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """+-1 with equal odds, drawn from ``generator`` (on its device), on ``device``."""
    gdev = generator.device if generator is not None else device
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=gdev)
    return (2 * bits - 1).to(device=device, dtype=dtype)


def _per_sample_field(f: VectorField, t, shape):
    """x_i (d,) -> f(t, x_i as a batch of one).reshape(-1)."""
    return lambda xi: f(t, xi.reshape((1,) + tuple(shape))).reshape(-1)


def hutch_probes(probes: Optional[torch.Tensor], generator: Optional[torch.Generator], bs: int,
                 k: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """``probes`` (bs, k, d) checked and moved to ``like``'s device and dtype,
    or drawn from ``generator`` when None."""
    if probes is None:
        if generator is None:
            raise ValueError("a Hutchinson estimate needs a generator or probes=")
        probes = rademacher(generator, (bs, k, d), like.dtype, like.device)
    probes = probes.to(device=like.device, dtype=like.dtype)
    if probes.dim() != 3 or probes.shape[0] != bs or probes.shape[2] != d:
        raise ValueError(f"probes must be ({bs}, k, {d}), got {tuple(probes.shape)}")
    return probes


def batched_jacobian_regs(f: VectorField, t, x: torch.Tensor, names: Sequence[str],
                          method: str = "exact", generator: Optional[torch.Generator] = None,
                          num_probes: int = 1, probes: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """Per-sample Jacobian-Frobenius rates, x (bs, *dim) -> dict of (bs,):
    "jac_frobenius" ||J||_F^2, "jac_diag_frobenius" sum_i J_ii^2,
    "jac_offdiag_frobenius" their difference. ``method="exact"`` forms each
    sample's Jacobian; "hutch" estimates ||J||_F^2 = E ||J eps||^2 over
    Rademacher probes (bs, k, d) and supports only "jac_frobenius"."""
    unknown = set(names) - set(JACOBIAN_REGULARIZERS)
    if unknown:
        raise ValueError(f"Unknown jacobian regularizers: {sorted(unknown)}")
    bs = x.shape[0]
    flat = x.reshape(bs, -1)
    per = _per_sample_field(f, t, x.shape[1:])
    if method == "exact":
        J = vmap(jacrev(per))(flat)                              # (bs, d, d)
        frob = torch.sum(torch.square(J), dim=(1, 2))
        diag = torch.sum(torch.square(torch.diagonal(J, dim1=1, dim2=2)), dim=1)
        out = {}
        if "jac_frobenius" in names:
            out["jac_frobenius"] = frob
        if "jac_diag_frobenius" in names:
            out["jac_diag_frobenius"] = diag
        if "jac_offdiag_frobenius" in names:
            out["jac_offdiag_frobenius"] = frob - diag
        return out
    if method == "hutch":
        if set(names) != {"jac_frobenius"}:
            raise ValueError("hutch supports only 'jac_frobenius' (no unbiased diag split)")
        eps = hutch_probes(probes, generator, bs, num_probes, flat.shape[1], flat)

        def sample(xi, ei):
            jv = vmap(lambda e: jvp(per, (xi,), (e,))[1])(ei)      # (k, d)
            return torch.mean(torch.sum(torch.square(jv), dim=1))

        return {"jac_frobenius": vmap(sample)(flat, eps)}
    raise ValueError(f"Unknown jacobian reg method: {method}")


# --------------------------------------------------------------------------
# Divergence (trace of the Jacobian) estimators
# --------------------------------------------------------------------------


def exact_trace(f_x: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The exact divergence of a per-sample field ``f_x`` (d,) -> (d,) at x
    (d,), a scalar: the trace of its Jacobian."""
    return torch.trace(jacrev(f_x)(x))


def hutch_trace(f_x: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                probes: torch.Tensor) -> torch.Tensor:
    """Hutchinson's divergence estimate at x (d,) over the (k, d) probes:
    the mean of e^T J e, through one linearisation shared by the probes."""
    _, vjp_fn = vjp(f_x, x)
    return torch.mean(vmap(lambda e: vjp_fn(e)[0] @ e)(probes))


def batched_divergence(f: VectorField, t, x: torch.Tensor, method: str = "exact",
                       generator: Optional[torch.Generator] = None, num_probes: int = 1,
                       probes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The divergence of f(t, .) at each sample, x (bs, *dim) -> (bs,).
    "hutch" takes ``probes`` (bs, k, d) or draws them from ``generator``."""
    bs = x.shape[0]
    flat = x.reshape(bs, -1)
    per = _per_sample_field(f, t, x.shape[1:])
    if method == "exact":
        return vmap(lambda xi: exact_trace(per, xi))(flat)
    if method == "hutch":
        eps = hutch_probes(probes, generator, bs, num_probes, flat.shape[1], flat)
        return vmap(lambda xi, ei: hutch_trace(per, xi, ei))(flat, eps)
    raise ValueError(f"Unknown trace method: {method}")


# --------------------------------------------------------------------------
# Augmented integration
# --------------------------------------------------------------------------


class AugmentedState(NamedTuple):
    x: torch.Tensor
    logp: torch.Tensor               # (bs,) accumulated -int tr J dt
    regs: Dict[str, torch.Tensor]    # name -> (bs,) accumulated regulariser integrals


def make_augmented_field(f: VectorField, reg_names: Sequence[str] = (),
                         divergence: Optional[str] = None,
                         generator: Optional[torch.Generator] = None, num_probes: int = 1,
                         jac_reg_names: Sequence[str] = (), jac_method: str = "exact",
                         probes: Optional[torch.Tensor] = None):
    """Wraps a drift into an augmented field over :class:`AugmentedState`:
    dx once, the named regulariser rates from it, the Jacobian regularisers
    and, with ``divergence`` ("exact" or "hutch"), the log-density rate
    -tr J (else 0). Hutchinson probes are ``probes`` or drawn from
    ``generator`` at the first evaluation, and the same at every later one."""
    fixed = {"probes": probes}
    needs_probes = divergence == "hutch" or (jac_reg_names and jac_method == "hutch")

    def step_probes(x):
        if needs_probes and fixed["probes"] is None:
            d = x[0].numel()
            fixed["probes"] = hutch_probes(None, generator, x.shape[0], num_probes, d, x)
        return fixed["probes"]

    def aug_f(t, state: AugmentedState) -> AugmentedState:
        x = state.x
        eps = step_probes(x)
        dx = f(t, x)
        d_regs = {name: REGULARIZERS[name](t, x, dx) for name in reg_names}
        if jac_reg_names:
            d_regs.update(batched_jacobian_regs(f, t, x, jac_reg_names, method=jac_method,
                                                num_probes=num_probes, probes=eps))
        if divergence is not None:
            d_logp = -batched_divergence(f, t, x, method=divergence, num_probes=num_probes,
                                         probes=eps)
        else:
            d_logp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        return AugmentedState(x=dx, logp=d_logp, regs=d_regs)

    return aug_f


def augmented_odeint(f: VectorField, x0: torch.Tensor, ts, reg_names: Sequence[str] = (),
                     divergence: Optional[str] = None,
                     generator: Optional[torch.Generator] = None, method: str = "euler",
                     num_probes: int = 1, jac_reg_names: Sequence[str] = (),
                     jac_method: str = "exact", probes: Optional[torch.Tensor] = None,
                     **odeint_kw) -> AugmentedState:
    """Integrates the state and its accumulators along ``ts``; returns the
    final :class:`AugmentedState`, whose ``logp`` holds int -tr J dt over
    the path."""
    from cfm_tpu_torch.integrate import odeint

    aug_f = make_augmented_field(f, reg_names=reg_names, divergence=divergence,
                                 generator=generator, num_probes=num_probes,
                                 jac_reg_names=jac_reg_names, jac_method=jac_method,
                                 probes=probes)
    zeros = lambda: torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    init = AugmentedState(x=x0, logp=zeros(),
                          regs={n: zeros() for n in tuple(reg_names) + tuple(jac_reg_names)})
    return odeint(aug_f, init, ts, method=method, return_trajectory=False, **odeint_kw).final


def standard_normal_logprob(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) summed over the feature axes -> (bs,)."""
    flat = z.reshape(z.shape[0], -1)
    d = flat.shape[1]
    return -0.5 * (d * math.log(2 * math.pi) + torch.sum(torch.square(flat), dim=1))


def cnf_log_likelihood(f: VectorField, x1: torch.Tensor, n_steps: int = 100,
                       divergence: str = "exact", generator: Optional[torch.Generator] = None,
                       method: str = "euler", num_probes: int = 1,
                       probes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log p(x1) of a CNF: integrate x1 backward from t = 1 to 0 with the
    trace; log p(x1) = log N(x0; 0, I) - int_0^1 tr J dt (the backward pass
    accumulates that integral into ``logp``)."""
    ts = np.linspace(1.0, 0.0, n_steps + 1, dtype=np.float32)
    final = augmented_odeint(f, x1, ts, divergence=divergence, generator=generator,
                             method=method, num_probes=num_probes, probes=probes)
    return standard_normal_logprob(final.x) - final.logp
