"""Generation: integrate the learned field from N(0, I) and quantise to uint8.

Counterpart of the single-device body of ``cfm_tpu.train.
make_data_parallel_sample_fn`` and of ``gen_batch`` in
``examples/compute_fid.py``: x0 ~ N(0, I) in NHWC, ``odeint`` through the
model over [0, 1] (the adaptive dopri5 and tsit5 over the two-point span,
fixed-step methods over ``n_steps`` intervals, unless a grid is given),
final state to uint8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cfm_tpu_torch.device import DeviceLike, resolve_device
from cfm_tpu_torch.eval.protocol import quantize_to_uint8
from cfm_tpu_torch.integrate import odeint, vector_field_from_model

_ADAPTIVE = ("dopri5", "tsit5")
_FIXED = ("euler", "midpoint", "heun", "rk4")


class Generated(NamedTuple):
    images: torch.Tensor  # (n, H, W, C) uint8 on the model's device
    nfe: int              # vector-field evaluations, summed over the batches


def generate(model: torch.nn.Module, n: int, *, x_shape: Tuple[int, int, int] = (32, 32, 3),
             method: str = "dopri5", n_steps: int = 100, rtol: float = 1e-5,
             atol: float = 1e-5, max_steps: int = 16384, batch_size: Optional[int] = None,
             generator: Optional[torch.Generator] = None, x0: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None, grid: Optional[Sequence[float]] = None,
             device: DeviceLike = None) -> Generated:
    """Generate ``n`` images of shape ``x_shape`` (H, W, C) with ``model``.

    Runs on ``device`` (``cuda`` unless ``device="cpu"`` is asked for), where
    the model's parameters must already be. The noise comes from
    ``generator`` (a ``torch.Generator`` on that device; default: seed 0), or
    is given as ``x0`` of shape (n, *x_shape). Batches of ``batch_size``
    (default: all ``n``) are integrated one after another. ``y`` (n,) are
    the class labels of a class-conditional model. ``grid`` replaces the time
    grid (``Trainer.generate`` gives tsit5 ``n_steps + 1`` points, as the
    JAX ``Trainer`` does). Raises if an adaptive method does not reach t = 1
    within ``max_steps``.
    """
    device = resolve_device(device)
    if method not in _ADAPTIVE + _FIXED:
        raise ValueError(f"Unknown ODE method: {method}")
    wrong = {p.device for p in model.parameters()} - {device}
    if wrong:
        raise ValueError(f"model parameters are on {wrong}, generation runs on {device}")
    if x0 is None:
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        x0 = torch.randn((n,) + tuple(x_shape), generator=generator, device=device)
    elif tuple(x0.shape) != (n,) + tuple(x_shape):
        raise ValueError(f"x0 must have shape {(n,) + tuple(x_shape)}, got {tuple(x0.shape)}")
    x0 = x0.to(device=device, dtype=torch.float32)
    if y is not None and tuple(y.shape) != (n,):
        raise ValueError(f"y must have shape ({n},), got {tuple(y.shape)}")
    if grid is not None:
        ts = np.asarray(grid, dtype=np.float32)
    elif method in _ADAPTIVE:
        ts = np.array([0.0, 1.0], np.float32)
    else:
        ts = np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float32)
    images, nfe = [], 0
    with torch.inference_mode():
        for start in range(0, n, batch_size or n):
            batch = slice(start, start + (batch_size or n))
            f = vector_field_from_model(model, None if y is None else y[batch].to(device))
            sol = odeint(f, x0[batch], ts, method=method,
                         rtol=rtol, atol=atol, max_steps=max_steps, return_trajectory=False)
            if not bool(torch.isfinite(sol.final).all()):
                raise RuntimeError(f"{method} did not reach t=1 within max_steps={max_steps} "
                                   "or produced non-finite values")
            images.append(quantize_to_uint8(sol.final))
            nfe += sol.nfe
    return Generated(torch.cat(images), nfe)
