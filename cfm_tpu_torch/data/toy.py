"""2-D toy distributions on the device (counterpart of ``cfm_tpu/data/toy.py``).

Every generator is ``sample(generator, n, device=None) -> (n, 2)`` (or
(n, dim) for the dimension-aware ``gaussian`` and ``funnel``), drawn from an
explicit ``torch.Generator`` on the device it samples on (``device``
defaults to the generator's). ``torch.Generator`` draws differ from
``jax.random``'s, so the two packages give the same distributions, not the
same points; the layouts, scales and noise levels are the JAX package's.
A draw copies nothing from the host: the generators' constant vectors are
made once per device and cached (:func:`_const`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Generator = torch.Generator
Sampler = Callable[..., torch.Tensor]

# The JAX package's blob centers: 4 * jax.random.normal(PRNGKey(7), (3, 2)).
_BLOB_CENTERS = ((1.8049405813217163, 7.813803672790527),
                 (-2.064957857131958, -0.5637611746788025),
                 (2.461986780166626, 1.337265968322754))


_CONSTS: Dict[Tuple[tuple, torch.device], torch.Tensor] = {}


def _const(values: tuple, device) -> torch.Tensor:
    """The float32 tensor of ``values`` on ``device``, made at the first call
    and cached: building it from a Python list on every draw would copy a
    pageable host buffer to the card and wait for it."""
    key = (values, torch.device(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return _CONSTS[key]


def _dev(generator: Generator, device) -> torch.device:
    return torch.device(device) if device is not None else generator.device


def _normal(generator: Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


def _uniform(generator: Generator, n: int, device, lo: float = 0.0, hi: float = 1.0):
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def _coin(generator: Generator, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device) < 0.5


def _choice(generator: Generator, n: int, k: int, device) -> torch.Tensor:
    return torch.randint(0, k, (n,), generator=generator, device=device)


def eight_gaussians(generator: Generator, n: int, device=None, scale: float = 5.0,
                    var: float = 0.1) -> torch.Tensor:
    """Mixture of 8 Gaussians on a circle of radius scale * sqrt(2) / 2."""
    device = _dev(generator, device)
    angles = torch.arange(8, device=device) * (2 * math.pi / 8)
    centers = scale * torch.stack([math.sqrt(2.0) * torch.cos(angles),
                                   math.sqrt(2.0) * torch.sin(angles)], dim=-1) / 2.0
    comp = _choice(generator, n, 8, device)
    return centers[comp] + _normal(generator, (n, 2), device) * math.sqrt(var)


sample_8gaussians = eight_gaussians


def moons(generator: Generator, n: int, device=None, noise: float = 0.05) -> torch.Tensor:
    """Two interleaved half-moons at unit scale (sklearn's make_moons layout)."""
    device = _dev(generator, device)
    upper = _coin(generator, n, device)
    theta = _uniform(generator, n, device, 0.0, math.pi)
    x = torch.where(upper, torch.cos(theta), 1.0 - torch.cos(theta))
    y = torch.where(upper, torch.sin(theta), 0.5 - torch.sin(theta))
    return torch.stack([x, y], dim=-1) + noise * _normal(generator, (n, 2), device)


def sample_moons(generator: Generator, n: int, device=None, noise: float = 0.2) -> torch.Tensor:
    """The tutorial's target: moons * 3 - 1, ``noise`` the output-space std."""
    return moons(generator, n, device, noise=noise / 3.0) * 3.0 - 1.0


def pinwheel(generator: Generator, n: int, device=None, n_arms: int = 5) -> torch.Tensor:
    """Pinwheel of rotated Gaussian blades (radial/tangential std 0.3/0.1,
    rate 0.25, row-vector rotation, scale 7.5)."""
    device = _dev(generator, device)
    arm = _choice(generator, n, n_arms, device)
    feats = (_normal(generator, (n, 2), device) * _const((0.3, 0.1), device)
             + _const((1.0, 0.0), device))
    angles = arm * (2 * math.pi / n_arms) + 0.25 * torch.exp(feats[:, 0])
    c, s = torch.cos(angles), torch.sin(angles)
    x = c * feats[:, 0] + s * feats[:, 1]
    y = -s * feats[:, 0] + c * feats[:, 1]
    return 7.5 * torch.stack([x, y], dim=-1)


def checkerboard(generator: Generator, n: int, device=None, scale: float = 4.0) -> torch.Tensor:
    """Checkerboard density on [-scale, scale]^2."""
    device = _dev(generator, device)
    x1 = _uniform(generator, n, device) * scale - scale / 2
    x2_ = _uniform(generator, n, device) - _choice(generator, n, 2, device) * 2
    x2 = x2_ + torch.floor(x1) % 2
    return torch.stack([x1, x2], dim=-1) * 2.0


def circles(generator: Generator, n: int, device=None, noise: float = 0.08) -> torch.Tensor:
    """Two concentric circles (sklearn's make_circles layout), scaled x3."""
    device = _dev(generator, device)
    r = torch.where(_coin(generator, n, device), 0.5, 1.0)
    theta = _uniform(generator, n, device, 0.0, 2 * math.pi)
    pts = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return 3.0 * (pts + noise * _normal(generator, (n, 2), device))


def spirals(generator: Generator, n: int, device=None) -> torch.Tensor:
    """Two interleaved Archimedean spirals."""
    device = _dev(generator, device)
    t = torch.sqrt(_uniform(generator, n, device)) * 540 * (2 * math.pi) / 360
    sign = torch.where(_coin(generator, n, device), 1.0, -1.0)
    dx = -torch.cos(t) * t / (3 * math.pi)
    dy = torch.sin(t) * t / (3 * math.pi)
    pts = torch.stack([sign * dx, sign * dy], dim=-1) * 3.0
    return pts + 0.1 * _normal(generator, (n, 2), device)


def swissroll(generator: Generator, n: int, device=None, noise: float = 0.05) -> torch.Tensor:
    """2-D projection of the swiss roll, scaled / 5."""
    device = _dev(generator, device)
    t = 1.5 * math.pi * (1 + 2 * _uniform(generator, n, device))
    pts = torch.stack([t * torch.cos(t), t * torch.sin(t)], dim=-1) / 5.0
    return pts + noise * _normal(generator, (n, 2), device)


def scurve(generator: Generator, n: int, device=None, noise: float = 0.05) -> torch.Tensor:
    """2-D S-curve: (x, z) of sklearn's make_s_curve, scaled x2."""
    device = _dev(generator, device)
    t = 3 * math.pi * (_uniform(generator, n, device) - 0.5)
    pts = torch.stack([torch.sin(t), torch.sign(t) * (torch.cos(t) - 1.0)], dim=-1)
    return 2.0 * (pts + noise * _normal(generator, (n, 2), device))


def gaussian_mixture(generator: Generator, n: int, device=None,
                     means: Optional[torch.Tensor] = None, var: float = 0.1) -> torch.Tensor:
    """Isotropic Gaussian mixture with uniform weights (default: two
    components at (-2, 0) and (2, 0))."""
    device = _dev(generator, device)
    means = (_const(((-2.0, 0.0), (2.0, 0.0)), device) if means is None
             else torch.as_tensor(means, dtype=torch.float32, device=device))
    comp = _choice(generator, n, means.shape[0], device)
    return means[comp] + math.sqrt(var) * _normal(generator, (n, 2), device)


def gaussian(generator: Generator, n: int, device=None, std: float = 1.0,
             dim: int = 2) -> torch.Tensor:
    return std * _normal(generator, (n, dim), _dev(generator, device))


def funnel(generator: Generator, n: int, device=None, dim: int = 10) -> torch.Tensor:
    """Neal's funnel: x0 ~ N(0, 1), x_{1:} ~ N(0, exp(x0))."""
    x = _normal(generator, (n, dim), _dev(generator, device))
    return torch.cat([x[:, :1], x[:, 1:] * torch.exp(x[:, :1] / 2.0)], dim=1)


def blobs(generator: Generator, n: int, device=None, n_centers: int = 3,
          std: float = 0.5) -> torch.Tensor:
    """Isotropic Gaussian blobs around the JAX package's three fixed centers
    (it draws other counts from its own key, which the port cannot)."""
    if n_centers != len(_BLOB_CENTERS):
        raise ValueError(f"blobs has {len(_BLOB_CENTERS)} fixed centers, got n_centers={n_centers}")
    device = _dev(generator, device)
    centers = _const(_BLOB_CENTERS, device)
    comp = _choice(generator, n, n_centers, device)
    return centers[comp] + std * _normal(generator, (n, 2), device)


_REGISTRY: Dict[str, Sampler] = {
    "8gaussians": eight_gaussians,
    "moons": sample_moons,
    "moon": sample_moons,
    "pinwheel": pinwheel,
    "checkerboard": checkerboard,
    "checker": checkerboard,
    "circles": circles,
    "circle": circles,
    "2spirals": spirals,
    "swiss": swissroll,
    "swissroll": swissroll,
    "scurve": scurve,
    "mixture": gaussian_mixture,
    "gaussian": gaussian,
    "funnel": funnel,
    "blobs": blobs,
}

# Generators that take a ``dim`` keyword (the rest are intrinsically 2-D).
_DIM_AWARE = {"gaussian", "funnel"}


def two_dim_data(name: str, dim: int = 0) -> Sampler:
    """A generator by name. ``dim`` > 0 fixes the dimension of ``gaussian``
    and ``funnel``; the 2-D-only generators refuse any dim other than 2."""
    try:
        gen = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown 2D dataset: {name!r}; have {sorted(_REGISTRY)}")
    if dim and name in _DIM_AWARE:
        return lambda generator, n, device=None, _g=gen, _d=dim: _g(generator, n, device, dim=_d)
    if dim and dim != 2:
        raise ValueError(f"{name!r} is a 2-D generator; got dim={dim}")
    return gen
