"""The FLOP count and the bounds against hand counts."""

from __future__ import annotations

import json

import pytest
import torch

from cfmbench import harness, trace
from cfmbench.reference.unet import RefAttention, RefConv


def _count(module, *inputs):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        module(*inputs)
    return counter.get_total_flops()


def test_flops_of_one_convolution():
    with torch.device("meta"):
        conv = RefConv(64, 128)
        x = torch.empty(2, 16, 16, 64)
    assert _count(conv, x, None) == 2 * 2 * 16 * 16 * 128 * 64 * 9


def test_flops_of_one_attention_block():
    n, side, c, heads = 2, 8, 128, 2
    s = side * side
    with torch.device("meta"):
        block = RefAttention(c, heads)
        x = torch.empty(n, side, side, c)
    # qkv 2 N S C 3C, logits and values 2 N S^2 C each, out-projection 2 N S C^2.
    hand = 2 * n * s * c * 3 * c + 4 * n * s * s * c + 2 * n * s * c * c
    assert _count(block, x, None) == hand
    group = json.loads((harness.HERE / "kernels" / "attention.json").read_text())
    assert eval(group["forward"]["operations"], {"__builtins__": {}},
                dict(N=n, S=s, C=c)) == hand


def test_groupnorm_bound_at_cifar10_shape():
    """#8 at N = 128, 32x32x128 bf16: 0.0201 ms by bytes (PERF.md's table)."""
    group = json.loads((harness.HERE / "kernels" / "groupnorm.json").read_text())
    ms = 1e3 * trace._bound(group["forward"], dict(N=128, HW=32 * 32, C=128, itemsize=2))
    assert ms == pytest.approx(0.0201, abs=5e-5)


def test_model_flops_of_the_configurations():
    from cfmbench.flops import model_flops_per_image

    arch = {c: json.loads((harness.HERE / "configs" / f"{c}.json").read_text())["model"]
            for c in ("imagenet64-adm", "cifar10-torchcfm")}
    imagenet = model_flops_per_image(arch["imagenet64-adm"], 1, False)
    cifar = model_flops_per_image(arch["cifar10-torchcfm"], 1, False)
    assert imagenet == pytest.approx(219.3e9, rel=1e-3)
    assert cifar == pytest.approx(12.44e9, rel=1e-3)
