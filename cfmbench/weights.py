"""A configuration's weights, made on the device from its weights seed.

A configuration stands for one trained checkpoint, so its file fixes the
seed. The values follow guided-diffusion's initialisation (fan-in-scaled
normal kernels, N(0, 1) class embeddings, unit norm scales, zero biases),
except that the layers it initialises to zero (each ResBlock's last
convolution, the attention out-projections, the output convolution) get
small seeded values too, 0.3 / sqrt(fan-in), so that the field is not zero.
One ``torch.randn`` call draws every random value; the names and shapes come
from the plain reference (:func:`cfmbench.reference.unet.parameter_specs`),
and the same dict loads into the program and into the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from cfmbench.reference.unet import parameter_specs

_STD = {"kernel": 1.0, "zero_kernel": 0.3, "embedding": 1.0}


def make_weights(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``."""
    specs = parameter_specs(arch)
    total = sum(math.prod(shape) for _, shape, kind, _ in specs if kind in _STD)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        if kind in _STD:
            scale = _STD[kind] * (1.0 if kind == "embedding" else fan_in ** -0.5)
            out[name] = flat[at:at + n].view(shape).mul_(scale)
            at += n
        elif kind == "norm_scale":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
