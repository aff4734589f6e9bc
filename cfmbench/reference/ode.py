"""The plain reference of generation: euler and dopri5 from t = 0 to 1.

euler takes ``n_steps`` equal steps on the float32 grid
``linspace(0, 1, n_steps + 1)``. dopri5 is the Dormand-Prince 5(4) pair
with the JAX package's step control, written from its description:

- Hairer's initial step (two evaluations: f(x0) and one trial);
- the error ratio is one RMS over the whole batch of
  err / (atol + rtol * max(|x|, |x_new|)), a step accepted at <= 1;
- the next step is dt * clamp(0.9 * ratio^(-1/5), 1 if accepted else 0.2, 10),
  the last one cut to land on t = 1;
- FSAL: six evaluations a trial step, NFE = 2 + 6 * trials.

The host keeps t, dt and the ratios as float32 scalars. Images are
quantised with the FID formula: clamp(x * 127.5 + 128, 0, 255), truncated.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

_f32 = np.float32
A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
B4 = [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]

Field = Callable[[float, torch.Tensor], torch.Tensor]


def quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * 127.5 + 128.0, 0.0, 255.0).to(torch.uint8)


def euler(f: Field, x: torch.Tensor, n_steps: int) -> Tuple[torch.Tensor, int]:
    ts = np.linspace(0.0, 1.0, n_steps + 1, dtype=_f32)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        x = x + float(t1 - t0) * f(float(t0), x)
    return x, n_steps


def _rms(x: torch.Tensor) -> np.float32:
    return _f32(torch.sqrt(torch.mean(torch.square(x.double()))).item())


def dopri5(f: Field, x0: torch.Tensor, rtol: float, atol: float,
           max_steps: int = 16384) -> Tuple[torch.Tensor, int]:
    rtol, atol = _f32(rtol), _f32(atol)
    t, t1 = _f32(0.0), _f32(1.0)
    k1 = f(0.0, x0)
    scale = float(atol) + float(rtol) * torch.abs(x0)
    d0, d1 = _rms(x0 / scale), _rms(k1 / scale)
    h0 = _f32(1e-6) if d0 < _f32(1e-5) or d1 < _f32(1e-5) else _f32(0.01) * d0 / d1
    k_try = f(float(h0), x0 + float(h0) * k1)
    d2 = _rms((k_try - k1) / scale) / h0
    if d1 <= _f32(1e-15) and d2 <= _f32(1e-15):
        h1 = max(_f32(1e-6), h0 * _f32(1e-3))
    else:
        h1 = (_f32(0.01) / max(d1, d2)) ** _f32(0.2)
    dt = min(min(_f32(100) * h0, h1), t1 - t)
    nfe, x = 2, x0
    for _ in range(max_steps):
        if abs(t1 - t) <= _f32(1e-10):
            return x, nfe
        dt = min(dt, t1 - t)
        ks = [k1]
        for i in range(1, 7):
            xi = x
            for j, a in enumerate(A[i]):
                xi = xi + float(dt * _f32(a)) * ks[j]
            ks.append(f(float(t + _f32(C[i]) * dt), xi))
        x5, x4 = x, x
        for i in range(7):
            x5 = x5 + float(dt * _f32(B5[i])) * ks[i]
            x4 = x4 + float(dt * _f32(B4[i])) * ks[i]
        nfe += 6
        ratio = _rms((x5 - x4) / (float(atol) + float(rtol) * torch.maximum(x5.abs(), x.abs())))
        accept = ratio <= _f32(1.0)
        factor = _f32(0.9) * (_f32(1.0) / max(ratio, _f32(1e-10))) ** _f32(0.2)
        factor = min(max(factor, _f32(1.0) if accept else _f32(0.2)), _f32(10.0))
        if accept:
            t, x, k1 = t + dt, x5, ks[6]
        dt = dt * factor
    raise RuntimeError(f"dopri5 did not reach t = 1 in {max_steps} steps")
