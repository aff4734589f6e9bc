"""The port's ODE solvers (cfm_tpu_torch/integrate.py) against JAX ``odeint``.

Each method integrates the same numpy initial state through the same field
written twice (jnp and torch). The fixed-step methods must agree to float32
rounding; dopri5 must take the same steps (identical NFE), write the same
dense-output trajectory at 11 grid points and leave the same grid points
NaN when ``max_steps`` runs out. dopri5's NFE is also held against the
independent torch oracle in tests/helpers/torch_dopri5.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.integrate import odeint as jodeint
from cfm_tpu_torch.integrate import ODESolution, odeint

_A = np.array([[-0.5, -2.0, 0.0], [2.0, -0.5, 0.3], [0.0, -0.3, -0.2]], np.float32)

# (name, jax field, torch field); both take a scalar t and an (N, 3) state.
FIELDS = {
    "linear": (lambda t, x: x @ _A.T,
               lambda t, x: x @ torch.from_numpy(_A).T),
    "nonlinear": (lambda t, x: jnp.sin(3.0 * x) * (1.0 + t) - 0.5 * x ** 3,
                  lambda t, x: torch.sin(3.0 * x) * (1.0 + t) - 0.5 * x ** 3),
}


def _x0(seed=0):
    return np.random.default_rng(seed).standard_normal((4, 3)).astype(np.float32)


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_fixed_step_matches_jax(method, field):
    fj, ft = FIELDS[field]
    x0 = _x0()
    ts = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    ref = jodeint(fj, jnp.asarray(x0), jnp.asarray(ts), method=method)
    sol = odeint(ft, torch.from_numpy(x0), ts, method=method)
    assert isinstance(sol, ODESolution) and sol.ys.shape == (11, 4, 3)
    assert sol.nfe == int(ref.nfe)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("tol", [1e-5, 1e-6])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_dopri5_matches_jax(field, tol):
    """Same steps (identical NFE) and the same contd5 dense output at the 11
    grid points, to float32 rounding of the step arithmetic. (Much below
    1e-6 the error ratio of the nonlinear field is float32 noise, and the
    two libraries' sin() can flip one accept decision.)"""
    fj, ft = FIELDS[field]
    x0 = _x0(1)
    ts = np.linspace(0.0, 2.0, 11, dtype=np.float32)
    ref = jodeint(fj, jnp.asarray(x0), jnp.asarray(ts), method="dopri5", rtol=tol, atol=tol)
    sol = odeint(ft, torch.from_numpy(x0), ts, method="dopri5", rtol=tol, atol=tol)
    assert sol.nfe == int(ref.nfe) and (sol.nfe - 2) % 6 == 0
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), atol=1e-5, rtol=1e-5)
    short = odeint(ft, torch.from_numpy(x0), ts[[0, -1]], method="dopri5", rtol=tol, atol=tol,
                   return_trajectory=False)
    assert short.ys.shape == (2, 4, 3) and short.nfe == sol.nfe
    np.testing.assert_array_equal(short.final.numpy(), sol.final.numpy())


def test_dopri5_reverse_time_matches_jax():
    fj, ft = FIELDS["nonlinear"]
    x0 = _x0(2)
    ts = np.linspace(1.0, 0.0, 6, dtype=np.float32)
    ref = jodeint(fj, jnp.asarray(x0), jnp.asarray(ts), method="dopri5")
    sol = odeint(ft, torch.from_numpy(x0), ts, method="dopri5")
    assert sol.nfe == int(ref.nfe)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(ref.ys), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("max_steps", [1, 3])
def test_dopri5_max_steps_leaves_nan(max_steps):
    fj, ft = FIELDS["nonlinear"]
    x0 = _x0(3)
    ts = np.linspace(0.0, 2.0, 11, dtype=np.float32)
    ref = np.asarray(jodeint(fj, jnp.asarray(x0), jnp.asarray(ts), method="dopri5",
                             max_steps=max_steps).ys)
    sol = odeint(ft, torch.from_numpy(x0), ts, method="dopri5", max_steps=max_steps)
    assert sol.nfe == 2 + 6 * max_steps
    ys = sol.ys.numpy()
    assert np.isnan(ys[-1]).all()
    np.testing.assert_array_equal(np.isnan(ys), np.isnan(ref))
    np.testing.assert_allclose(ys, ref, atol=1e-5, rtol=1e-5)  # NaNs compare equal


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_dopri5_nfe_matches_torch_oracle(field):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
    from torch_dopri5 import dopri5 as oracle

    _, ft = FIELDS[field]
    x0 = torch.from_numpy(_x0(4))
    sol = odeint(ft, x0, [0.0, 1.0], method="dopri5", return_trajectory=False)
    y, nfe, _ = oracle(lambda t, x: ft(float(t), x), x0, 0.0, 1.0)
    assert sol.nfe == nfe
    np.testing.assert_allclose(sol.final.numpy(), y.numpy(), atol=1e-5, rtol=1e-5)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown ODE method"):
        odeint(lambda t, x: x, torch.zeros(2), [0.0, 1.0], method="tsit6")
