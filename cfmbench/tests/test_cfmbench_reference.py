"""The plain reference against the program's plain (CPU) paths, on small
shapes with seeded weights, in float32."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from cfmbench.reference import ode
from cfmbench.reference import train as reference
from cfmbench.reference.unet import RefUNet, parameter_specs
from cfmbench.tests.tiny import ARCH, OPTIMIZER
from cfmbench.weights import make_weights

torch.set_num_threads(2)

CIFAR_LIKE = {"dim": [16, 16, 3], "num_channels": 32, "num_res_blocks": 2,
              "channel_mult": [1, 2], "num_heads": 2, "num_head_channels": -1,
              "attention_resolutions": "8", "dropout": 0.1, "class_cond": False,
              "learn_sigma": False}
IMAGENET_LIKE = dict(ARCH, channel_mult=[1, 2, 2], attention_resolutions="8,4")


def _port(arch):
    from cfm_tpu_torch.models.unet import UNetModelWrapper

    model = UNetModelWrapper(**dict(arch, dim=tuple(arch["dim"])), dtype=torch.float32,
                             device="cpu")
    model.load_state_dict(make_weights(arch, 11, "cpu"))
    return model


@pytest.mark.parametrize("arch", [IMAGENET_LIKE, CIFAR_LIKE], ids=["imagenet-like", "cifar-like"])
def test_reference_unet_matches_the_port(arch):
    port = _port(arch)
    ref = RefUNet(arch)
    ref.load_state_dict(make_weights(arch, 11, "cpu"))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((4,) + tuple(arch["dim"]), generator=g)
    t = torch.rand(4, generator=g)
    y = torch.randint(0, 10, (4,), generator=g) if arch.get("class_cond") else None
    with torch.no_grad():
        want = port(t, x, y)
        got = ref(t, x, y)
    assert got.shape == want.shape
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 1e-5
    assert [n for n, _, _, _ in parameter_specs(arch)] == [n for n, _ in port.named_parameters()]


def _run(arch, seed=9):
    cell = types.SimpleNamespace(config={"model": arch, "dtype": "float32", "weights_seed": 5,
                                         "optimizer": OPTIMIZER},
                                 traffic={"batch": 6, "checked_steps": 3, "block": 4})
    return types.SimpleNamespace(cell=cell, seed=seed, device=torch.device("cpu"), world=1,
                                 rank=0, distributed=False, cuda=False)


def test_reference_train_step_matches_the_port():
    from cfmbench.drivers import train as driver
    from cfmbench.program import build_model

    run = _run(ARCH)
    prog = driver.Program(run, build_model(run))
    program = prog.checked_steps(3)
    gaps = reference.compare(program, driver.reference_readings(run))
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
    assert gaps["ema_gap"] < 1e-3


def test_reference_assignment_is_optimal():
    from scipy.optimize import linear_sum_assignment

    g = torch.Generator().manual_seed(1)
    x0, x1 = torch.randn(12, 5, generator=g), torch.randn(12, 5, generator=g)
    perm = reference.assignment(x0, x1)
    cost = torch.cdist(x0.double(), x1.double()) ** 2
    rows, cols = linear_sum_assignment(cost.numpy())
    assert float(cost[torch.arange(12), perm].sum()) == pytest.approx(float(cost[rows, cols].sum()))


def _field(t, x):
    return -x * (1.0 + 0.5 * np.sin(3 * t)) + 0.3 * torch.cos(x)


def test_reference_euler_matches_the_port():
    from cfm_tpu_torch.integrate import odeint

    x0 = torch.randn(5, 4, 4, 3, generator=torch.Generator().manual_seed(2))
    got, nfe = ode.euler(_field, x0, 100)
    sol = odeint(_field, x0, np.linspace(0, 1, 101, dtype=np.float32), method="euler",
                 return_trajectory=False)
    assert nfe == sol.nfe == 100
    torch.testing.assert_close(got, sol.final, rtol=0, atol=0)


def test_reference_dopri5_matches_the_port():
    from cfm_tpu_torch.integrate import odeint

    x0 = torch.randn(5, 4, 4, 3, generator=torch.Generator().manual_seed(2))
    got, nfe = ode.dopri5(_field, x0, 1e-5, 1e-5)
    sol = odeint(_field, x0, [0.0, 1.0], method="dopri5", rtol=1e-5, atol=1e-5,
                 return_trajectory=False)
    assert nfe == sol.nfe
    torch.testing.assert_close(got, sol.final, rtol=1e-6, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    folder = Path(__file__).resolve().parent.parent / "reference"
    for path in folder.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("cfm_tpu_torch", "cfm_tpu", "jax"), (path, name)
