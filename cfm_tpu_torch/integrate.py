"""ODE integration: the generation loop.

Counterpart of ``cfm_tpu/integrate.py`` (``odeint`` with euler, midpoint,
heun, rk4 and adaptive dopri5, ``vector_field_from_model``). The state is a
tensor on any device; the loop runs in Python.

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

The step-control scalars (t, dt, error ratios) live on the host as float32,
as they are float32 scalars in the JAX loop; each trial step reads its error
ratio from the device once.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

VectorField = Callable[[float, torch.Tensor], torch.Tensor]  # (t, x) -> dx/dt
_f32 = np.float32


class ODESolution(NamedTuple):
    """``ys``: (T, *x.shape), ``ys[i]`` the state at ``ts[i]`` (with
    ``return_trajectory=False``: (2, *x.shape), initial and final).
    ``nfe``: the number of vector-field evaluations."""

    ys: torch.Tensor
    nfe: int

    @property
    def final(self) -> torch.Tensor:
        return self.ys[-1]


# The steppers take float32 grid times; every scalar is formed in float32
# and handed to torch as the exact Python float of that value.


def _euler_step(f, t0, t1, x):
    dt = t1 - t0
    return x + float(dt) * f(float(t0), x), 1


def _midpoint_step(f, t0, t1, x):
    dt = t1 - t0
    h = dt / _f32(2)
    k1 = f(float(t0), x)
    k2 = f(float(t0 + h), x + float(h) * k1)
    return x + float(dt) * k2, 2


def _heun_step(f, t0, t1, x):
    dt = t1 - t0
    h = float(dt / _f32(2))
    k1 = f(float(t0), x)
    k2 = f(float(t1), x + float(dt) * k1)
    return (x + h * k1) + h * k2, 2


def _rk4_step(f, t0, t1, x):
    dt = t1 - t0
    h = dt / _f32(2)
    k1 = f(float(t0), x)
    k2 = f(float(t0 + h), x + float(h) * k1)
    k3 = f(float(t0 + h), x + float(h) * k2)
    k4 = f(float(t1), x + float(dt) * k3)
    return x + float(dt / _f32(6)) * (k1 + 2 * k2 + 2 * k3 + k4), 4


_FIXED_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}


def odeint(f: VectorField, x0: torch.Tensor, ts: Union[Sequence[float], np.ndarray, torch.Tensor],
           method: str = "dopri5", rtol: float = 1e-5, atol: float = 1e-5,
           max_steps: int = 16384, return_trajectory: bool = True) -> ODESolution:
    """Integrate dx/dt = f(t, x) along the float32 time grid ``ts``
    (increasing or decreasing). Fixed-step methods take one step per grid
    interval; dopri5 picks its own steps and writes grid points by dense
    output."""
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    ts = np.asarray(ts, dtype=_f32)
    if method in _FIXED_STEPPERS:
        stepper = _FIXED_STEPPERS[method]
        x, nfe, ys = x0, 0, [x0]
        for t0, t1 in zip(ts[:-1], ts[1:]):
            x, n = stepper(f, t0, t1, x)
            nfe += n
            if return_trajectory:
                ys.append(x)
        return ODESolution(torch.stack(ys if return_trajectory else [x0, x]), nfe)
    if method == "dopri5":
        return _odeint_dopri5(f, x0, ts, _f32(rtol), _f32(atol), max_steps, return_trajectory)
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


def _rms(x: torch.Tensor) -> np.float32:
    """sqrt(mean(x^2)) over the whole state, read to the host (one sync)."""
    return _f32(torch.sqrt(torch.sum(torch.square(x)) / x.numel()).item())


def _dp_step_stages(f, t, dt, x, k1):
    """One dopri5 trial step (FSAL): returns (x5, err, the 7 stages)."""
    ks = [k1]
    for i in range(1, 7):
        xi = x
        for j, aij in enumerate(_DP_A[i]):
            xi = xi + float(dt * aij) * ks[j]
        ks.append(f(float(t + _DP_C[i] * dt), xi))
    x5, x4 = x, x
    for i in range(7):
        x5 = x5 + float(dt * _DP_B5[i]) * ks[i]
        x4 = x4 + float(dt * _DP_B4[i]) * ks[i]
    return x5, x5 - x4, ks


def _hairer_initial_step(f, x0, f0, t0, t1, rtol, atol):
    """Signed initial step; one evaluation beyond f0."""
    direction = _f32(np.sign(t1 - t0))
    scale = float(atol) + float(rtol) * torch.abs(x0)
    d0, d1 = _rms(x0 / scale), _rms(f0 / scale)
    if d0 < _f32(1e-5) or d1 < _f32(1e-5):
        h0 = _f32(1e-6)
    else:
        h0 = _f32(0.01) * d0 / d1
    a = direction * h0
    f1 = f(float(t0 + a), x0 + float(a) * f0)
    d2 = _rms((f1 - f0) / scale) / h0
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
    """Hairer's contd5 interpolant of one accepted step at fraction theta."""
    diff = y1 - y0
    bspl = float(dt) * ks[0] - diff
    r5 = float(_DP_D[0]) * ks[0]
    for i in range(1, 7):
        r5 = r5 + float(_DP_D[i]) * ks[i]
    r5 = float(dt) * r5
    r4 = diff - float(dt) * ks[6] - bspl
    th, om = float(theta), float(_f32(1) - theta)
    return y0 + th * (diff + om * (bspl + th * (r4 + om * r5)))


def _odeint_dopri5(f, x0, ts, rtol, atol, max_steps, return_trajectory):
    T = ts.shape[0]
    t0, t1 = ts[0], ts[-1]
    f0 = f(float(t0), x0)
    dt = _hairer_initial_step(f, x0, f0, t0, t1, rtol, atol)
    nfe = 2
    out = torch.full((T,) + tuple(x0.shape), float("nan"), dtype=x0.dtype, device=x0.device)
    out[0] = x0
    t, x, k1 = t0, x0, f0
    done = False
    steps = 0
    tol_done = _f32(1e-10) * max(abs(t1), _f32(1.0))
    theta_hi = _f32(1.0 + 1e-7)
    while not done and steps < max_steps:
        remaining = t1 - t
        if abs(dt) > abs(remaining):
            dt = remaining
        x_new, err, ks = _dp_step_stages(f, t, dt, x, k1)
        scale = float(atol) + float(rtol) * torch.maximum(torch.abs(x_new), torch.abs(x))
        e = _rms(err / scale)
        accept = bool(e <= _f32(1.0))
        dt_next = dt * _pi_factor(e, accept)
        if accept:
            theta = (ts - t) / dt
            for i in np.nonzero((theta > 0) & (theta <= theta_hi))[0]:
                out[i] = _contd5(theta[i], dt, x, x_new, ks)
            t, x, k1 = t + dt, x_new, ks[6]
        nfe += 6
        steps += 1
        dt = dt_next
        done = bool(abs(t1 - t) <= tol_done)
    out[-1] = x if done else float("nan")
    if not return_trajectory:
        out = out[[0, T - 1]]
    return ODESolution(out, nfe)


def vector_field_from_model(model: Callable[..., torch.Tensor],
                            y: Optional[torch.Tensor] = None) -> VectorField:
    """Adapt ``model(t_batch, x[, y]) -> v`` to the (t scalar, x) drift:
    the scalar time is broadcast to one entry per sample."""

    def f(t: float, x: torch.Tensor) -> torch.Tensor:
        t_b = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
        return model(t_b, x) if y is None else model(t_b, x, y)

    return f
