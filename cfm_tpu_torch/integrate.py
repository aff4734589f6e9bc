"""ODE and SDE integration: the generation loop.

Counterpart of ``cfm_tpu/integrate.py``: ``odeint`` with euler, midpoint,
heun, rk4 and the adaptive dopri5 and tsit5, ``sdeint`` (Euler-Maruyama and
stochastic Heun with the Girsanov ``logqp``), ``odeint_adjoint`` (dopri5 you
can differentiate, by the continuous adjoint), ``FlowSolver`` and
``vector_field_from_model``. The loop runs in Python. ``odeint``'s state is
a tensor on any device, or, as JAX's pytree-aware loop takes it, a tuple, a
NamedTuple (the trace-augmented CNF state of ``augment.py``) or a dict of
tensors: each update is applied leaf by leaf, the adaptive error norm is
one RMS over all leaves together, and the trajectory is stacked leaf by
leaf.

dopri5 keeps the JAX package's semantics exactly, so that both take the same
steps and count the same NFE:

- one RMS error norm over the whole state, scale ``atol + rtol * max(|x|,
  |x_new|)``;
- Hairer's initial step with 2 start-up evaluations;
- step factor ``0.9 * e**(-1/5)`` clamped to [1 if accepted else 0.2, 10];
- NFE = 2 + 6 per trial step (FSAL);
- interior grid points from the contd5 dense output of the accepted step
  that covers them; grid points never reached within ``max_steps`` are NaN,
  the final one included.

tsit5 shares that controller but hits each grid point by clamping the step
to it (no dense output); an accepted step's next trial is
``max(|dt|, |dt_c * factor|)``, so a clamped or zero-length landing
(duplicate grid entries) does not shrink it.

The step-control scalars (t, dt, error ratios) live on the host as float32,
as they are float32 scalars in the JAX loop; each trial step reads its error
ratio from the device once.

Spans (``profiling``): ``ode.solve`` an ``odeint`` call; in dopri5 and
tsit5 ``ode.trial`` a trial step's stages and error ratio (attribute
``accepted``), ``ode.read`` each blocking read of an error norm, and
``ode.control`` the step control after a trial's read (the step size, the
output writes, the end test): host time while the card waits. Counters:
``ode.trial_steps`` and ``ode.rejected_steps``.

``sdeint`` draws each step's standard normals from an explicit
``torch.Generator`` (one step at a time, never an (n_steps, *x.shape) block),
or takes them as ``noise``; it reads nothing back to the host.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import dataclasses

import numpy as np
import torch

from cfm_tpu_torch.profiling import count, span

VectorField = Callable[[float, Any], Any]  # (t, x) -> dx/dt
_f32 = np.float32


def tree_map(fn: Callable[..., torch.Tensor], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over a tensor, tuple, NamedTuple, list or
    dict of tensors (nested), the others of the same structure as ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest))) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *z) for z in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *z) for z in zip(tree, *rest))
    raise TypeError(f"an ODE state is a tensor or a tuple, NamedTuple or dict of them, "
                    f"got {type(tree).__name__}")


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in JAX's order (a dict's by sorted key)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    raise TypeError(f"an ODE state is a tensor or a tuple, NamedTuple or dict of them, "
                    f"got {type(tree).__name__}")


def _axpy(x, k, a: float):
    """x + a * k, leaf by leaf."""
    return tree_map(lambda xi, ki: xi + a * ki, x, k)


class ODESolution(NamedTuple):
    """``ys``: (T, *x.shape), ``ys[i]`` the state at ``ts[i]`` (with
    ``return_trajectory=False``: (2, *x.shape), initial and final); for a
    tuple, NamedTuple or dict state the same structure of such tensors.
    ``nfe``: the number of vector-field evaluations."""

    ys: Any
    nfe: int

    @property
    def final(self) -> Any:
        return tree_map(lambda y: y[-1], self.ys)


class SDESolution(NamedTuple):
    """``ys`` and ``nfe`` as in :class:`ODESolution`; ``logqp`` (B,) float32,
    the Girsanov KL of each sample when ``logqp_drift`` was given, else None."""

    ys: torch.Tensor
    nfe: int
    logqp: Optional[torch.Tensor] = None

    @property
    def final(self) -> torch.Tensor:
        return self.ys[-1]


# The steppers take float32 grid times; every scalar is formed in float32
# and handed to torch as the exact Python float of that value.


def _euler_step(f, t0, t1, x):
    dt = t1 - t0
    return _axpy(x, f(float(t0), x), float(dt)), 1


def _midpoint_step(f, t0, t1, x):
    dt = t1 - t0
    h = dt / _f32(2)
    k1 = f(float(t0), x)
    k2 = f(float(t0 + h), _axpy(x, k1, float(h)))
    return _axpy(x, k2, float(dt)), 2


def _heun_step(f, t0, t1, x):
    dt = t1 - t0
    h = float(dt / _f32(2))
    k1 = f(float(t0), x)
    k2 = f(float(t1), _axpy(x, k1, float(dt)))
    return _axpy(_axpy(x, k1, h), k2, h), 2


def _rk4_step(f, t0, t1, x):
    dt = t1 - t0
    h = dt / _f32(2)
    k1 = f(float(t0), x)
    k2 = f(float(t0 + h), _axpy(x, k1, float(h)))
    k3 = f(float(t0 + h), _axpy(x, k2, float(h)))
    k4 = f(float(t1), _axpy(x, k3, float(dt)))
    sixth = float(dt / _f32(6))
    return tree_map(lambda xi, a, b, c, d: xi + sixth * (a + 2 * b + 2 * c + d),
                    x, k1, k2, k3, k4), 4


_FIXED_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}


def odeint(f: VectorField, x0: Any, ts: Union[Sequence[float], np.ndarray, torch.Tensor],
           method: str = "dopri5", rtol: float = 1e-5, atol: float = 1e-5,
           max_steps: int = 16384, return_trajectory: bool = True) -> ODESolution:
    """Integrate dx/dt = f(t, x) along the float32 time grid ``ts``
    (increasing or decreasing). Fixed-step methods take one step per grid
    interval; dopri5 picks its own steps and writes grid points by dense
    output. ``x0`` is a tensor or a tuple, NamedTuple or dict of tensors, and
    ``f`` returns the same structure."""
    with span("ode.solve", method=method):
        return _odeint(f, x0, ts, method, rtol, atol, max_steps, return_trajectory)


def _odeint(f, x0, ts, method, rtol, atol, max_steps, return_trajectory) -> ODESolution:
    ts = _grid(ts)
    if method in _FIXED_STEPPERS:
        stepper = _FIXED_STEPPERS[method]
        x, nfe, ys = x0, 0, [x0]
        for t0, t1 in zip(ts[:-1], ts[1:]):
            x, n = stepper(f, t0, t1, x)
            nfe += n
            if return_trajectory:
                ys.append(x)
        return ODESolution(tree_map(lambda *ls: torch.stack(ls),
                                    *(ys if return_trajectory else [x0, x])), nfe)
    if method in _ADAPTIVE:
        return _ADAPTIVE[method](f, x0, ts, _f32(rtol), _f32(atol), max_steps, return_trajectory)
    raise ValueError(f"Unknown ODE method: {method}")


# Dormand-Prince 5(4) tableau and the contd5 dense-output weights, as float32
# (the JAX loop multiplies them into float32 step sizes).
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], dtype=_f32)
_DP_D = np.array([
    -12715105075 / 11282082432,
    0.0,
    87487479700 / 32700410799,
    -10690763975 / 1880347072,
    701980252875 / 199316789632,
    -1453857185 / 822651844,
    69997945 / 29380423,
], dtype=_f32)
_DP_A = [
    np.array(a, dtype=_f32) for a in (
        [],
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    )
]
_DP_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0], dtype=_f32)
_DP_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
                   187 / 2100, 1 / 40], dtype=_f32)


def _rms(x) -> np.float32:
    """sqrt(mean(x^2)) over the whole state, all leaves together (the sum of
    each leaf's squares over the total count), read to the host (one sync)."""
    leaves = tree_leaves(x)
    total = torch.sum(torch.square(leaves[0]))
    for leaf in leaves[1:]:
        total = total + torch.sum(torch.square(leaf))
    norm = torch.sqrt(total / sum(leaf.numel() for leaf in leaves))
    with span("ode.read"):
        return _f32(norm.item())


def _err_ratio(err, x_new, x_old, rtol, atol) -> np.float32:
    """The RMS of the error over ``atol + rtol * max(|x_new|, |x_old|)``."""
    return _rms(tree_map(lambda e, a, b: e / (float(atol) + float(rtol) * torch.maximum(
        torch.abs(a), torch.abs(b))), err, x_new, x_old))


def _dp_step_stages(f, t, dt, x, k1):
    """One dopri5 trial step (FSAL): returns (x5, err, the 7 stages)."""
    ks = [k1]
    for i in range(1, 7):
        xi = x
        for j, aij in enumerate(_DP_A[i]):
            xi = _axpy(xi, ks[j], float(dt * aij))
        ks.append(f(float(t + _DP_C[i] * dt), xi))
    x5, x4 = x, x
    for i in range(7):
        x5 = _axpy(x5, ks[i], float(dt * _DP_B5[i]))
        x4 = _axpy(x4, ks[i], float(dt * _DP_B4[i]))
    return x5, tree_map(torch.sub, x5, x4), ks


def _hairer_initial_step(f, x0, f0, t0, t1, rtol, atol):
    """Signed initial step; one evaluation beyond f0."""
    direction = _f32(np.sign(t1 - t0))
    scale = tree_map(lambda y: float(atol) + float(rtol) * torch.abs(y), x0)
    d0, d1 = _rms(tree_map(torch.div, x0, scale)), _rms(tree_map(torch.div, f0, scale))
    if d0 < _f32(1e-5) or d1 < _f32(1e-5):
        h0 = _f32(1e-6)
    else:
        h0 = _f32(0.01) * d0 / d1
    a = direction * h0
    f1 = f(float(t0 + a), _axpy(x0, f0, float(a)))
    d2 = _rms(tree_map(lambda p, q, s_: (p - q) / s_, f1, f0, scale)) / h0
    if d1 <= _f32(1e-15) and d2 <= _f32(1e-15):
        h1 = max(_f32(1e-6), h0 * _f32(1e-3))
    else:
        h1 = (_f32(0.01) / max(d1, d2)) ** _f32(0.2)
    return direction * min(min(_f32(100) * h0, h1), abs(t1 - t0))


def _pi_factor(e: np.float32, accept: bool) -> np.float32:
    """Safety 0.9, e**(-1/5), clamped to [1 if accepted else 0.2, 10]."""
    dfactor = _f32(1.0) if accept else _f32(0.2)
    g = _f32(0.9) * (_f32(1.0) / max(e, _f32(1e-10))) ** _f32(0.2)
    return min(max(g, dfactor), _f32(10.0))


def _contd5(theta, dt, y0, y1, ks):
    """Hairer's contd5 interpolant of one accepted step at fraction theta,
    leaf by leaf."""
    return tree_map(lambda a, b, *k: _contd5_leaf(theta, dt, a, b, k), y0, y1, *ks)


def _contd5_leaf(theta, dt, y0, y1, ks):
    diff = y1 - y0
    bspl = float(dt) * ks[0] - diff
    r5 = float(_DP_D[0]) * ks[0]
    for i in range(1, 7):
        r5 = r5 + float(_DP_D[i]) * ks[i]
    r5 = float(dt) * r5
    r4 = diff - float(dt) * ks[6] - bspl
    th, om = float(theta), float(_f32(1) - theta)
    return y0 + th * (diff + om * (bspl + th * (r4 + om * r5)))


def _output_buffer(x0, T):
    """(T, *leaf.shape) NaN per leaf, x0 written at index 0."""
    def leaf(x):
        buf = torch.full((T,) + tuple(x.shape), float("nan"), dtype=x.dtype, device=x.device)
        buf[0] = x
        return buf

    return tree_map(leaf, x0)


def _write(out, i, x):
    """out[i] = x leaf by leaf; ``x=None`` writes NaN (a grid point not reached)."""
    if x is None:
        tree_map(lambda buf: buf[i].fill_(float("nan")), out)
    else:
        tree_map(lambda buf, v: buf.__setitem__(i, v), out, x)


def _ends(out, T):
    return tree_map(lambda buf: buf[[0, T - 1]], out)


def _count_trial(accepted: bool) -> None:
    count("ode.trial_steps")
    if not accepted:
        count("ode.rejected_steps")


def _odeint_dopri5(f, x0, ts, rtol, atol, max_steps, return_trajectory):
    T = ts.shape[0]
    t0, t1 = ts[0], ts[-1]
    f0 = f(float(t0), x0)
    dt = _hairer_initial_step(f, x0, f0, t0, t1, rtol, atol)
    nfe = 2
    out = _output_buffer(x0, T)
    t, x, k1 = t0, x0, f0
    done = False
    steps = 0
    tol_done = _f32(1e-10) * max(abs(t1), _f32(1.0))
    theta_hi = _f32(1.0 + 1e-7)
    while not done and steps < max_steps:
        with span("ode.trial") as trial:
            remaining = t1 - t
            if abs(dt) > abs(remaining):
                dt = remaining
            x_new, err, ks = _dp_step_stages(f, t, dt, x, k1)
            e = _err_ratio(err, x_new, x, rtol, atol)
            accept = bool(e <= _f32(1.0))
            trial.set(accepted=accept)
            _count_trial(accept)
        with span("ode.control"):
            dt_next = dt * _pi_factor(e, accept)
            if accept:
                theta = (ts - t) / dt
                for i in np.nonzero((theta > 0) & (theta <= theta_hi))[0]:
                    _write(out, i, _contd5(theta[i], dt, x, x_new, ks))
                t, x, k1 = t + dt, x_new, ks[6]
            nfe += 6
            steps += 1
            dt = dt_next
            done = bool(abs(t1 - t) <= tol_done)
    _write(out, -1, x if done else None)
    if not return_trajectory:
        out = _ends(out, T)
    return ODESolution(out, nfe)


# Tsitouras 5(4) tableau (Tsitouras 2011, Table 1), float32 as the JAX loop
# multiplies it into float32 step sizes. FSAL, 7 stages like dopri5.
_TS_C = np.array([0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0], dtype=_f32)
_TS_A = [
    np.array(a, dtype=_f32) for a in (
        [],
        [0.161],
        [-0.008480655492356989, 0.335480655492357],
        [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
        [5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525],
        [5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
         -0.028269050394068383],
        [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774],
    )
]
_TS_B5 = np.array([0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
                   -3.290069515436081, 2.324710524099774, 0.0], dtype=_f32)
# Error weights b - bhat: err = dt * sum_i btilde_i k_i.
_TS_BT = np.array([-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
                   -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
                   0.015151515151515152], dtype=_f32)


def _ts_step_stages(f, t, dt, x, k1):
    """One tsit5 trial step (FSAL): returns (x5, err, the 7 stages)."""
    ks = [k1]
    for i in range(1, 7):
        xi = x
        for j, aij in enumerate(_TS_A[i]):
            xi = _axpy(xi, ks[j], float(dt * aij))
        ks.append(f(float(t + _TS_C[i] * dt), xi))
    x5 = x
    for i in range(7):
        if _TS_B5[i]:
            x5 = _axpy(x5, ks[i], float(dt * _TS_B5[i]))

    def err(*k):
        e = float(_TS_BT[0]) * k[0]
        for i in range(1, 7):
            e = e + float(_TS_BT[i]) * k[i]
        return float(dt) * e

    return x5, tree_map(err, *ks), ks


def _odeint_tsit5(f, x0, ts, rtol, atol, max_steps, return_trajectory):
    T = ts.shape[0]
    t0, t1 = ts[0], ts[-1]
    direction = _f32(np.sign(t1 - t0))
    f0 = f(float(t0), x0)
    dt = _hairer_initial_step(f, x0, f0, t0, t1, rtol, atol)
    nfe = 2
    out = _output_buffer(x0, T)
    t, x, k1 = t0, x0, f0
    idx, steps, done = 1, 0, False  # idx: the next grid point to land on

    def near(a, b):
        return abs(a - b) <= _f32(1e-10) * max(abs(a), _f32(1.0))

    while not done and steps < max_steps:
        with span("ode.trial") as trial:
            t_out = ts[idx]
            remaining = t_out - t
            dt_c = remaining if abs(dt) > abs(remaining) else dt
            x_new, err, ks = _ts_step_stages(f, t, dt_c, x, k1)
            e = _err_ratio(err, x_new, x, rtol, atol)
            accept = bool(e <= _f32(1.0))
            trial.set(accepted=accept)
            _count_trial(accept)
        with span("ode.control"):
            factor = _pi_factor(e, accept)
            if accept:
                t, x, k1 = t + dt_c, x_new, ks[6]
            landed = accept and near(t_out, t)
            if landed:
                _write(out, idx, x)
                idx = min(idx + 1, T - 1)
            done = landed and idx == T - 1 and near(t1, t)
            # An accepted step keeps max(|dt|, |dt_c * factor|): a landing clamped
            # short (or to 0 on duplicate grid entries) must not shrink the next
            # trial; a rejected one shrinks from the dt_c that failed.
            dt = direction * max(abs(dt), abs(dt_c * factor)) if accept else dt_c * factor
            nfe += 6
            steps += 1
    _write(out, -1, x if done else None)
    if not return_trajectory:
        out = _ends(out, T)
    return ODESolution(out, nfe)


_ADAPTIVE = {"dopri5": _odeint_dopri5, "tsit5": _odeint_tsit5}


def _grid(ts) -> np.ndarray:
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    return np.asarray(ts, dtype=_f32)


def sdeint(drift: VectorField, diffusion: Callable[[float, torch.Tensor], torch.Tensor],
           generator: Optional[torch.Generator], x0: torch.Tensor,
           ts: Union[Sequence[float], np.ndarray, torch.Tensor],
           logqp_drift: Optional[VectorField] = None, return_trajectory: bool = True,
           method: str = "euler", noise: Optional[Sequence[torch.Tensor]] = None) -> SDESolution:
    """Integrate dx = drift dt + diffusion dW along the float32 grid ``ts``
    (a decreasing grid integrates in reverse time; the increments' variance
    is |dt|).

    ``method``: "euler" (Euler-Maruyama, one drift evaluation a step) or
    "heun" (stochastic Heun: drift and diffusion averaged between the start
    and an Euler predictor, two a step). ``diffusion(t, x)`` is the diagonal
    noise scale, broadcastable to x. Step i's standard normals (x's shape and
    dtype) are drawn from ``generator`` when the step comes, or are
    ``noise[i]``. With ``logqp_drift`` the Girsanov KL
    0.5 * sum |dt| |(drift - logqp_drift) / max(|diffusion|, 1e-8)|^2 over
    the non-batch axes is accumulated in float32 per sample.

    The arithmetic is the JAX loop's: the update promotes to float32 through
    dt and is cast back to x's dtype.
    """
    if method not in ("euler", "heun"):
        raise ValueError(f"Unknown SDE method: {method}")
    if generator is None and noise is None:
        raise ValueError("sdeint needs a generator or the steps' noise")
    ts = _grid(ts)
    axes = tuple(range(1, x0.dim()))
    x, nfe, ys = x0, 0, [x0]
    kl = (torch.zeros(x0.shape[0], dtype=torch.float32, device=x0.device)
          if logqp_drift is not None else None)
    for i, (t0, t1) in enumerate(zip(ts[:-1], ts[1:])):
        dt = t1 - t0
        if noise is None:
            z = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=generator.device).to(x.device)
        else:
            z = noise[i].to(device=x.device, dtype=x.dtype)
        dw = z.float() * float(np.sqrt(abs(dt)))
        fx, gx = drift(float(t0), x), diffusion(float(t0), x)
        xf = x.float()
        if method == "heun":
            x_pred = (xf + fx.float() * float(dt) + gx.float() * dw).to(x.dtype)
            f1, g1 = drift(float(t1), x_pred), diffusion(float(t1), x_pred)
            x_new = (xf + (0.5 * (fx + f1)).float() * float(dt)
                     + (0.5 * (gx + g1)).float() * dw).to(x.dtype)
            nfe += 2
        else:
            x_new = (xf + fx.float() * float(dt) + gx.float() * dw).to(x.dtype)
            nfe += 1
        if kl is not None:
            u = ((fx - logqp_drift(float(t0), x)) / torch.clamp_min(gx.abs(), 1e-8)).float()
            kl = kl + 0.5 * torch.sum(torch.square(u), dim=axes) * float(abs(dt))
        x = x_new
        if return_trajectory:
            ys.append(x)
    return SDESolution(torch.stack(ys if return_trajectory else [x0, x]), nfe, kl)


def _flat(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def _unflat(y: torch.Tensor, like: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    parts = torch.split(y, [leaf.numel() for leaf in like])
    return tuple(p.reshape(leaf.shape).to(leaf.dtype) for p, leaf in zip(parts, like))


class _OdeintAdjoint(torch.autograd.Function):
    """dopri5 forward; the backward integrates (x, a = dL/dx, g = dL/dparams)
    from ts[-1] back to ts[0] with the same dopri5 on one flat vector, whose
    RMS error norm is JAX's over the tuple of leaves."""

    @staticmethod
    def forward(ctx, f, ts, rtol, atol, max_steps, n_params, ts_tensor, *tensors):
        params, leaves = tensors[:n_params], tensors[n_params:]

        def field(t, y):
            return _flat(f(params, t, _unflat(y, leaves)))

        y = _odeint_dopri5(field, _flat(leaves), ts, rtol, atol, max_steps, False).final
        out = _unflat(y, leaves)
        ctx.save_for_backward(*params, *out)
        ctx.f, ctx.ts, ctx.tol = f, ts, (rtol, atol)
        ctx.max_steps, ctx.n_params = max_steps, n_params
        ctx.ts_like = None if ts_tensor is None else (ts_tensor.shape, ts_tensor.dtype,
                                                      ts_tensor.device)
        return out

    @staticmethod
    def backward(ctx, *grads):
        f, n = ctx.f, ctx.n_params
        saved = ctx.saved_tensors
        params, x_final = saved[:n], saved[n:]
        wrt = [i for i, p in enumerate(params) if p.requires_grad]
        nx = len(x_final)

        def aug(t, y):
            parts = _unflat(y, (*x_final, *x_final, *params))
            with torch.enable_grad():
                xx = tuple(leaf.detach().requires_grad_(True) for leaf in parts[:nx])
                fx = f(params, t, xx)
                vjp = torch.autograd.grad(fx, xx + tuple(params[i] for i in wrt),
                                          parts[nx:2 * nx], allow_unused=True)
            da = [torch.zeros_like(v) if d is None else d for d, v in zip(vjp[:nx], xx)]
            dp = [torch.zeros_like(p) for p in params]
            for i, d in zip(wrt, vjp[nx:]):
                if d is not None:
                    dp[i] = d
            return _flat([*(v.detach() for v in fx), *(-d for d in da), *(-d for d in dp)])

        g = [torch.zeros_like(x) if gr is None else gr for gr, x in zip(grads, x_final)]
        y0 = _flat([*x_final, *g, *(torch.zeros_like(p) for p in params)])
        ts_back = np.array([ctx.ts[-1], ctx.ts[0]], dtype=_f32)
        y = _odeint_dopri5(aug, y0, ts_back, *ctx.tol, ctx.max_steps, False).final
        parts = _unflat(y, (*x_final, *x_final, *params))
        dts = None if ctx.ts_like is None else torch.zeros(ctx.ts_like[0], dtype=ctx.ts_like[1],
                                                           device=ctx.ts_like[2])
        return (None,) * 6 + (dts,) + parts[2 * nx:] + parts[nx:2 * nx]


def odeint_adjoint(f: Callable[[Tuple[torch.Tensor, ...], float, Any], Any],
                   params: Sequence[torch.Tensor], x0: Union[torch.Tensor, Sequence[torch.Tensor]],
                   ts: Union[Sequence[float], np.ndarray, torch.Tensor], rtol: float = 1e-5,
                   atol: float = 1e-5, max_steps: int = 16384):
    """The final state of dopri5 from ``x0`` along ``ts``, differentiable in
    ``params`` and ``x0`` by the continuous adjoint (optimise, then
    discretise): the backward integrates da/dt = -a^T df/dx and
    dg/dt = -a^T df/dparams backward with the same dopri5 at (rtol, atol),
    the vector-Jacobian products by ``torch.autograd.grad``, so its memory is
    the state's, not the steps'.

    ``f(params, t, x)`` is the drift, ``params`` a sequence of tensors (a
    module's own parameters, or tensors ``f`` uses through
    ``torch.func.functional_call``). ``x0`` is a tensor or a tuple of
    tensors (then ``f`` takes and returns a tuple, and so does this
    function). The gradient of ``ts`` is zero. As with any continuous
    adjoint, x(t) is reconstructed backward, so the gradients are those of
    the exact flow to the solver's tolerance.
    """
    params = tuple(params)
    is_tuple = isinstance(x0, (tuple, list))
    leaves = tuple(x0) if is_tuple else (x0,)
    ts_tensor = ts if isinstance(ts, torch.Tensor) else None
    g = f if is_tuple else (lambda p, t, x: (f(p, t, x[0]),))
    out = _OdeintAdjoint.apply(g, _grid(ts), _f32(rtol), _f32(atol), max_steps, len(params),
                               ts_tensor, *params, *leaves)
    return tuple(out) if is_tuple else out[0]


@dataclasses.dataclass
class FlowSolver:
    """ODE and SDE generation over a learned field: ``odeint`` rolls out the
    drift; ``sdeint`` integrates dx = [v + s] dt + sigma dW, or with
    ``reverse`` dx = [-v(1 - t) + s(1 - t)] dt + sigma dW, optionally with
    the ``logqp`` KL against the zero drift. ``sigma`` is a float or a
    function of t whose value (any shape of one element) scales ones."""

    drift: VectorField
    score: Optional[VectorField] = None
    sigma: Union[float, Callable[[float], Any]] = 0.0
    ode_method: str = "dopri5"
    sde_solver: str = "euler"
    rtol: float = 1e-5
    atol: float = 1e-5

    def _sigma_fn(self) -> Callable[[float, torch.Tensor], torch.Tensor]:
        sig = self.sigma
        if not callable(sig):
            return lambda t, x: torch.full_like(x, float(sig))

        def g(t, x):
            s = sig(t)
            if isinstance(s, (int, float)):  # a weakly typed scalar: x's dtype, as in JAX
                return torch.full_like(x, float(s))
            s = torch.as_tensor(s, device=x.device)
            if s.dtype == torch.float64:  # JAX runs it in float32
                s = s.float()
            return s.reshape(()) * torch.ones_like(x, dtype=torch.promote_types(s.dtype, x.dtype))

        return g

    def odeint(self, x0: torch.Tensor, ts, **kw) -> ODESolution:
        method = kw.pop("method", self.ode_method)
        return odeint(self.drift, x0, ts, method=method, rtol=self.rtol, atol=self.atol, **kw)

    def sdeint(self, generator: Optional[torch.Generator], x0: torch.Tensor, ts,
               reverse: bool = False, logqp: bool = False, **kw) -> SDESolution:
        if self.score is None:
            raise ValueError("sdeint requires a score field")
        if logqp and not callable(self.sigma) and float(self.sigma) == 0.0:
            # The KL divides by the diffusion: with sigma 0 the 1e-8 floor
            # would give a huge finite number where the answer is undefined.
            raise ValueError("logqp KL is undefined for sigma=0: set FlowSolver.sigma (or a "
                             "noise schedule) before requesting logqp")
        v, s = self.drift, self.score
        if reverse:
            def drift(t, x):
                tr = float(_f32(1.0) - _f32(t))
                return -v(tr, x) + s(tr, x)
        else:
            def drift(t, x):
                return v(t, x) + s(t, x)
        logqp_drift = (lambda t, x: torch.zeros_like(x)) if logqp else None
        kw.setdefault("method", self.sde_solver)
        return sdeint(drift, self._sigma_fn(), generator, x0, ts, logqp_drift=logqp_drift, **kw)


def vector_field_from_model(model: Callable[..., torch.Tensor],
                            y: Optional[torch.Tensor] = None) -> VectorField:
    """Adapt ``model(t_batch, x[, y]) -> v`` to the (t scalar, x) drift:
    the scalar time is broadcast to one entry per sample."""

    def f(t: float, x: torch.Tensor) -> torch.Tensor:
        t_b = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
        return model(t_b, x) if y is None else model(t_b, x, y)

    return f
