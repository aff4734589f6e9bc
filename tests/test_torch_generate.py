"""The slice end to end on the CPU: the port's ``generate`` against JAX.

JAX integrates ``vector_field_from_model(model.apply, params)`` with its
``odeint`` and quantises with its ``quantize_to_uint8``; the port runs
``generate`` on the same numpy x0 with the same (converted) weights. On the
CPU the JAX model computes its attention blocks by the composition and the
port by the block kernel's plain version; in float32 the two differ at the
1e-6 level, so the uint8 images agree within one level and the NFE exactly.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.eval.protocol import quantize_to_uint8 as jquantize
from cfm_tpu.integrate import odeint as jodeint
from cfm_tpu.integrate import vector_field_from_model as jfield
from cfm_tpu_torch.eval.protocol import quantize_to_uint8
from cfm_tpu_torch.generate import generate
from cfm_tpu_torch.models import UNetModelWrapper
from test_torch_unet import SMALL, _flax_params, _port_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    m, params = _flax_params(SMALL, jnp.float32, seed=5)
    return m, params, _port_model(SMALL, torch.float32, params)


@pytest.mark.parametrize("method", ["euler", "dopri5"])
def test_generate_matches_jax(models, method):
    m, params, model = models
    x0 = np.random.default_rng(6).standard_normal((3, 16, 16, 3)).astype(np.float32)
    ts = jnp.array([0.0, 1.0]) if method == "dopri5" else jnp.linspace(0.0, 1.0, 5)
    f = jfield(m.apply, {"params": params})
    sol = jodeint(f, jnp.asarray(x0), ts, method=method, return_trajectory=False)
    ref = np.asarray(jquantize(sol.final))
    out = generate(model, 3, x_shape=(16, 16, 3), method=method, n_steps=4,
                   x0=torch.from_numpy(x0), device="cpu")
    assert out.images.dtype == torch.uint8 and out.images.shape == (3, 16, 16, 3)
    assert out.nfe == int(sol.nfe)
    diff = np.abs(out.images.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert len(np.unique(ref)) > 50  # the field moved the noise: not a trivial check


def test_generate_batches_and_generator(models):
    """Batches are integrated one after another and their NFE summed; the
    same generator seed gives the same images."""
    _, _, model = models
    kw = dict(x_shape=(16, 16, 3), method="euler", n_steps=2, device="cpu")
    a = generate(model, 4, batch_size=2, generator=torch.Generator().manual_seed(7), **kw)
    b = generate(model, 4, generator=torch.Generator().manual_seed(7), **kw)
    assert a.nfe == 4 and b.nfe == 2
    assert torch.equal(a.images, b.images)


def test_quantize_matches_jax():
    x = np.linspace(-1.2, 1.2, 1001, dtype=np.float32)
    np.testing.assert_array_equal(quantize_to_uint8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jquantize(jnp.asarray(x))))


def test_entry_points_need_cuda_unless_cpu_is_asked_for(monkeypatch, models):
    _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, 2, x_shape=(16, 16, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNetModelWrapper(**SMALL)


def test_generate_rejects_bad_inputs(models):
    _, _, model = models
    with pytest.raises(ValueError, match="x0 must have shape"):
        generate(model, 2, x_shape=(16, 16, 3), x0=torch.zeros(3, 16, 16, 3), device="cpu")
    with pytest.raises(ValueError, match="Unknown ODE method"):
        generate(model, 2, x_shape=(16, 16, 3), method="tsit6", device="cpu")
    with pytest.raises(ValueError, match="model parameters are on"):
        generate(model, 2, x_shape=(16, 16, 3), device="meta")


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the JAX
    package (a fresh interpreter, so this test process's imports don't count)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cfm_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(cfm_tpu_torch.__path__, 'cfm_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'cfm_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 12, proc.stdout
