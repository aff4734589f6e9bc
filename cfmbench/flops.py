"""Model FLOPs of a configuration, counted on the plain reference.

``torch.utils.flop_counter`` counts the matrix products and convolutions of
the reference UNet, built on the meta device (no memory, no device time), at
the cell's batch: the forward for generation, forward plus backward for
training, recompute not counted. The count is per image.
"""

from __future__ import annotations

from typing import Dict

import torch

from cfmbench.reference.unet import RefUNet


def model_flops_per_image(arch: Dict, batch: int, backward: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    h, w, c = arch["dim"]
    with torch.device("meta"):
        model = RefUNet(arch)
        t = torch.empty(batch)
        x = torch.empty(batch, h, w, c)
        y = torch.zeros(batch, dtype=torch.long) if arch.get("class_cond") else None
    with FlopCounterMode(display=False) as counter:
        out = model(t, x, y)
        if backward:
            out.sum().backward()
    return counter.get_total_flops() / batch
