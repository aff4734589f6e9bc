"""The port's ODE solvers (cfm_tpu_torch/integrate.py) against JAX ``odeint``.

Each method integrates the same numpy initial state through the same field
written twice (jnp and torch). The fixed-step methods must agree to float32
rounding; dopri5 must take the same steps (identical NFE), write the same
dense-output trajectory at 11 grid points and leave the same grid points
NaN when ``max_steps`` runs out. dopri5's NFE is also held against the
independent torch oracle in tests/helpers/torch_dopri5.py. tsit5, ``sdeint``
(given JAX's normals), ``FlowSolver`` and ``odeint_adjoint`` follow.
"""

import copy
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.integrate import odeint as jodeint
from cfm_tpu_torch.integrate import ODESolution, odeint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# --- tsit5 -----------------------------------------------------------------
#
# JAX's tsit5 loop is a ``lax.while_loop``, which XLA compiles; its fused
# arithmetic can round one error ratio differently and flip a borderline
# accept (linear decay on the duplicate grid at 1e-5: 50 NFE jitted, 44 op
# by op). The port follows the loop as written, so it is held to the JAX
# loop run op by op (``jax.disable_jit()``) for the NFE and to the jitted
# loop for the states.

_W1 = np.random.default_rng(7).standard_normal((3, 16)).astype(np.float32) * 0.5
_W2 = np.random.default_rng(8).standard_normal((16, 3)).astype(np.float32) * 0.5
TSIT5_FIELDS = {
    "decay": (lambda t, x: -x, lambda t, x: -x),
    "mlp": (lambda t, x: jnp.tanh(x @ _W1 + 0.5 * t) @ _W2,
            lambda t, x: torch.tanh(x @ torch.from_numpy(_W1) + 0.5 * t) @ torch.from_numpy(_W2)),
}
TSIT5_GRIDS = {
    "dense": np.linspace(0.0, 2.0, 11, dtype=np.float32),
    "duplicates": np.array([0.0, 0.5, 0.5, 1.0, 1.0, 1.5], np.float32),
    "reverse": np.linspace(1.0, 0.0, 6, dtype=np.float32),
}


@pytest.mark.parametrize("grid", sorted(TSIT5_GRIDS))
@pytest.mark.parametrize("field", sorted(TSIT5_FIELDS))
def test_tsit5_matches_jax(field, grid):
    """The NFE equal to the JAX loop's op by op; the trajectory within
    1e-5 of it and of the jitted loop's, as for dopri5 (float32 rounding of
    the step arithmetic, accumulated over the steps); with max_steps = 3
    the same NaN rows as the loop op by op."""
    import jax

    fj, ft = TSIT5_FIELDS[field]
    ts, x0 = TSIT5_GRIDS[grid], _x0(5)
    for max_steps in (3, 16384):
        sol = odeint(ft, torch.from_numpy(x0), ts, method="tsit5", max_steps=max_steps)
        with jax.disable_jit():
            eager = jodeint(fj, jnp.asarray(x0), jnp.asarray(ts), method="tsit5",
                            max_steps=max_steps)
        refs = [eager]
        if max_steps > 3:
            refs.append(jodeint(fj, jnp.asarray(x0), jnp.asarray(ts), method="tsit5"))
        assert sol.nfe == int(eager.nfe) and (sol.nfe - 2) % 6 == 0
        ys = sol.ys.numpy()
        for ref in refs:
            np.testing.assert_array_equal(np.isnan(ys), np.isnan(np.asarray(ref.ys)))
            np.testing.assert_allclose(ys, np.asarray(ref.ys), atol=1e-5, rtol=1e-5)
        if max_steps == 3:
            assert sol.nfe == 20 and np.isnan(ys[-1]).all()
        else:
            assert np.isfinite(ys).all()
    short = odeint(ft, torch.from_numpy(x0), ts, method="tsit5", return_trajectory=False)
    assert short.ys.shape == (2, 4, 3)
    np.testing.assert_array_equal(short.final.numpy(), ys[-1])


# --- sdeint ----------------------------------------------------------------
#
# Fields whose constants are exact in bfloat16, so that both packages' ops
# round the same. JAX's scan body is compiled, and XLA keeps bfloat16 chains
# in float32 (excess precision), so bits are held against JAX op by op
# (``jax.disable_jit()``) and the jitted scan within a bound.

SDE_DRIFT = (lambda t, x: 0.25 * x * x - x, lambda t, x: 0.25 * x * x - x)
SDE_DIFFUSION = (lambda t, x: 0.5 * jnp.ones_like(x) + 0.125 * jnp.abs(x),
                 lambda t, x: 0.5 * torch.ones_like(x) + 0.125 * torch.abs(x))
SDE_LOGQP = (lambda t, x: 0.25 * x, lambda t, x: 0.25 * x)


def _jax_normals(key, n_steps, shape, dtype):
    """JAX's draws: keys = split(key, n_steps), normal(keys[i], shape, dtype)."""
    import jax

    return [torch.from_numpy(np.asarray(jax.random.normal(k, shape, dtype), np.float32))
            for k in jax.random.split(key, n_steps)]


@pytest.mark.parametrize("reverse,logqp", [(False, True), (True, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["euler", "heun"])
def test_sdeint_matches_jax_given_its_normals(method, dtype, reverse, logqp):
    """Trajectory bit for bit against JAX op by op, f32 or bf16 state,
    forward time with the KL or reverse time without (reverse time with the
    KL: ``test_flow_solver_sdeint_matches_jax``); the same NFE; the float32
    KL within 2 f32 ulps of its max (the sums' order). Against the jitted
    scan: f32 within 2e-6, bf16 within 4 bf16 ulps."""
    import jax
    from cfm_tpu.integrate import sdeint as jsdeint
    from cfm_tpu_torch.integrate import sdeint

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ts = np.linspace(1.0, 0.0, 11, dtype=np.float32) if reverse else np.linspace(
        0.0, 1.0, 11, dtype=np.float32)
    x0 = _x0(6)
    key = jax.random.PRNGKey(3)
    noise = _jax_normals(key, 10, x0.shape, jdt)
    kw = dict(logqp_drift=SDE_LOGQP[0] if logqp else None, method=method)
    with jax.disable_jit():
        eager = jsdeint(SDE_DRIFT[0], SDE_DIFFUSION[0], key, jnp.asarray(x0, jdt), jnp.asarray(ts),
                        **kw)
    jitted = jsdeint(SDE_DRIFT[0], SDE_DIFFUSION[0], key, jnp.asarray(x0, jdt), jnp.asarray(ts),
                     **kw)
    sol = sdeint(SDE_DRIFT[1], SDE_DIFFUSION[1], None, torch.from_numpy(x0).to(tdt), ts,
                 logqp_drift=SDE_LOGQP[1] if logqp else None, method=method, noise=noise)
    assert sol.ys.dtype == tdt and sol.ys.shape == (11, 4, 3)
    assert sol.nfe == int(eager.nfe) == (20 if method == "heun" else 10)
    ys = sol.ys.float().numpy()
    np.testing.assert_array_equal(ys, np.asarray(eager.ys.astype(jnp.float32)))
    bound = 2e-6 if dtype == "float32" else 4 * 2.0 ** -8
    np.testing.assert_allclose(ys, np.asarray(jitted.ys.astype(jnp.float32)), rtol=bound,
                               atol=bound)
    if logqp:
        ref = np.asarray(eager.logqp)
        assert sol.logqp.dtype == torch.float32 and sol.logqp.shape == (4,)
        np.testing.assert_allclose(sol.logqp.numpy(), ref, rtol=0, atol=2 * 2.0 ** -23 * ref.max())
    else:
        assert sol.logqp is None and eager.logqp is None
    short = sdeint(SDE_DRIFT[1], SDE_DIFFUSION[1], None, torch.from_numpy(x0).to(tdt), ts,
                   method=method, noise=noise, return_trajectory=False)
    assert short.ys.shape == (2, 4, 3)
    np.testing.assert_array_equal(short.final.float().numpy(), ys[-1])


def test_sdeint_draws_from_its_generator_step_by_step():
    """Step i's normals are the generator's i-th draw of x's shape and dtype;
    a CPU generator serves any device; an unknown method raises."""
    from cfm_tpu_torch.integrate import sdeint

    x0 = torch.from_numpy(_x0(7))
    ts = np.linspace(0.0, 1.0, 6, dtype=np.float32)
    g = torch.Generator().manual_seed(4)
    noise = [torch.randn(x0.shape, generator=g) for _ in range(5)]
    a = sdeint(SDE_DRIFT[1], SDE_DIFFUSION[1], torch.Generator().manual_seed(4), x0, ts)
    b = sdeint(SDE_DRIFT[1], SDE_DIFFUSION[1], None, x0, ts, noise=noise)
    assert torch.equal(a.ys, b.ys)
    with pytest.raises(ValueError, match="Unknown SDE method"):
        sdeint(SDE_DRIFT[1], SDE_DIFFUSION[1], g, x0, ts, method="srk")
    with pytest.raises(ValueError, match="generator or the steps' noise"):
        sdeint(SDE_DRIFT[1], SDE_DIFFUSION[1], None, x0, ts)


@pytest.mark.parametrize("case", ["reverse_logqp", "callable_sigma", "heun_float_sigma"])
def test_flow_solver_sdeint_matches_jax(case):
    """``FlowSolver.sdeint`` against JAX's on the same normals, op by op:
    reverse time with the KL, a (1,)-shaped callable sigma, and the heun
    solver with a float sigma; both refusals raise as in JAX."""
    import jax
    from cfm_tpu.integrate import FlowSolver as JFlowSolver
    from cfm_tpu_torch.integrate import FlowSolver

    vj, vt = (lambda t, x: -x + 0.5 * t), (lambda t, x: -x + 0.5 * t)
    sj, st = (lambda t, x: 0.25 * x), (lambda t, x: 0.25 * x)
    sigma_j, sigma_t = {"reverse_logqp": (0.75, 0.75),
                        "callable_sigma": (lambda t: jnp.full((1,), 0.5) * (1.0 - t),
                                           lambda t: torch.full((1,), 0.5) * (1.0 - t)),
                        "heun_float_sigma": (0.5, 0.5)}[case]
    solver_kw = {"sde_solver": "heun"} if case == "heun_float_sigma" else {}
    kw = dict(reverse=case == "reverse_logqp", logqp=case != "heun_float_sigma")
    ts = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    x0, key = _x0(8), jax.random.PRNGKey(9)
    with jax.disable_jit():
        ref = JFlowSolver(drift=vj, score=sj, sigma=sigma_j, **solver_kw).sdeint(
            key, jnp.asarray(x0), jnp.asarray(ts), **kw)
    solver = FlowSolver(drift=vt, score=st, sigma=sigma_t, **solver_kw)
    sol = solver.sdeint(None, torch.from_numpy(x0), ts,
                        noise=_jax_normals(key, 8, x0.shape, jnp.float32), **kw)
    assert sol.nfe == int(ref.nfe) == (16 if solver_kw else 8)
    np.testing.assert_array_equal(sol.ys.numpy(), np.asarray(ref.ys))
    if kw["logqp"]:
        np.testing.assert_allclose(sol.logqp.numpy(), np.asarray(ref.logqp), rtol=3e-7)
    bare = FlowSolver(drift=vt)
    with pytest.raises(ValueError, match="requires a score field"):
        bare.sdeint(torch.Generator(), torch.from_numpy(x0), ts)
    with pytest.raises(ValueError, match="sigma=0"):
        FlowSolver(drift=vt, score=st).sdeint(torch.Generator(), torch.from_numpy(x0), ts,
                                              logqp=True)
    ode = solver.odeint(torch.from_numpy(x0), ts, method="rk4")
    np.testing.assert_allclose(ode.final.numpy(), np.asarray(JFlowSolver(
        drift=vj).odeint(jnp.asarray(x0), jnp.asarray(ts), method="rk4").final), atol=2e-6)


# --- odeint_adjoint ----------------------------------------------------------


def _adjoint_field():
    """A time-varying 2-D MLP (the port's ``MLP``) and its flax twin, with
    converted random weights; f(params, t, x) for each."""
    import jax

    from cfm_tpu.models.mlp import MLP as JMLP
    from cfm_tpu_torch.models.convert import mlp_params_from_flax
    from cfm_tpu_torch.models.mlp import MLP

    jm = JMLP(dim=2, w=16, time_varying=True)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1,)), jnp.zeros((1, 2)))["params"]
    params = jax.tree.map(lambda a: 0.5 * a, params)
    model = MLP(2, w=16, device="cpu")
    model.load_state_dict(mlp_params_from_flax(params))

    def fj(p, t, x):
        return jm.apply({"params": p}, jnp.full((x.shape[0],), t), x)

    def ft(p, t, x):  # p: the model's own parameters
        return model(torch.full((x.shape[0],), t), x)

    return params, fj, model, ft


def _rk4_grads(model, x0, t1, steps=1500):
    """Gradients of sum(x(t1)^2) for a float64 copy of ``model``'s
    parameters and for x0, by autograd through a fine float64 rk4: the
    discretise-then-optimise reference."""
    m64 = copy.deepcopy(model).double()
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)

    def f(t, y):
        return m64(torch.full((y.shape[0],), t, dtype=torch.float64), y)

    y, grid = x, np.linspace(0.0, t1, steps + 1)
    for a, b in zip(grid[:-1], grid[1:]):
        h = b - a
        k1 = f(a, y)
        k2 = f(a + h / 2, y + h / 2 * k1)
        k3 = f(a + h / 2, y + h / 2 * k2)
        y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + f(b, y + h * k3))
    (y ** 2).sum().backward()
    return x.grad.numpy(), {n: p.grad.numpy() for n, p in m64.named_parameters()}


def test_odeint_adjoint_matches_jax_odeint_adjoint():
    """Gradients of sum(x(T)^2) for the MLP's parameters and x0 at
    rtol = atol = 1e-6, the port's continuous adjoint against JAX's.

    At 1e-6 a float32 dopri5's error estimate (x5 - x4) is a few ulps of
    the state, so the MLP's matmul rounding (3e-8, summation order) moves
    the two packages' steps apart (56 against 50 NFE forward), and each
    adjoint lands within a few 1e-3 of the exact gradient (of each
    tensor's max-abs: JAX's up to 3.6e-3, the port's up to 1.9e-3, against
    a float64 rk4 reference, discretise then optimise). So both are held to
    4e-3 of it, and to 5e-3 of each other. The gradient of a ``ts`` tensor
    is zero."""
    import jax

    from cfm_tpu.integrate import odeint_adjoint as jadjoint
    from cfm_tpu_torch.integrate import odeint_adjoint
    from cfm_tpu_torch.models.convert import mlp_params_from_flax

    params, fj, model, ft = _adjoint_field()
    x0 = np.random.default_rng(10).standard_normal((5, 2)).astype(np.float32)
    ts = np.array([0.0, 1.5], np.float32)

    def loss(p, x):
        return jnp.sum(jadjoint(fj, p, x, jnp.asarray(ts), rtol=1e-6, atol=1e-6) ** 2)

    _, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(params, jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    ts_t = torch.tensor(ts, requires_grad=True)
    final = odeint_adjoint(ft, tuple(model.parameters()), x, ts_t, rtol=1e-6, atol=1e-6)
    (final ** 2).sum().backward()
    assert torch.equal(ts_t.grad, torch.zeros(2))
    ref_x, ref_p = _rk4_grads(model, x0, 1.5)
    jax_p = mlp_params_from_flax(gp)
    cases = [("x0", x.grad.numpy(), np.asarray(gx), ref_x)] + [
        (n, p.grad.numpy(), jax_p[n].numpy(), ref_p[n]) for n, p in model.named_parameters()]
    for name, port, jax_grad, ref in cases:
        scale = np.abs(ref).max()
        np.testing.assert_allclose(port, ref, rtol=0, atol=4e-3 * scale, err_msg=name)
        np.testing.assert_allclose(jax_grad, ref, rtol=0, atol=4e-3 * scale, err_msg=name)
        np.testing.assert_allclose(port, jax_grad, rtol=0, atol=5e-3 * scale, err_msg=name)


@pytest.mark.parametrize("tuple_state", [False, True])
def test_odeint_adjoint_matches_discretize_grads(tuple_state):
    """The port's adjoint at 1e-6 against autograd through a 400-step rk4 of
    the same field (JAX's ``test_odeint_adjoint_matches_discretize_grads``,
    the same bounds: 2e-3 relative, 2e-4 absolute); with a tuple state
    (x, logp), logp accumulating -sum(tanh(x W)), as a CNF's is."""
    from cfm_tpu_torch.integrate import odeint_adjoint

    w0 = torch.tensor([[-0.4, 0.8], [-0.9, -0.2]])
    b0 = torch.tensor([0.1, -0.3])
    x0 = torch.tensor([[1.0, 0.5], [-0.7, 1.2], [0.2, -0.4]])

    def f(p, t, s):
        x = s[0] if tuple_state else s
        dx = torch.tanh(x @ p[0].T + p[1]) + 0.1 * math.sin(t) * x
        return (dx, -torch.tanh(x @ p[0].T).sum(dim=1)) if tuple_state else dx

    def loss(s):
        return (s[0] ** 2).sum() + s[1].sum() if tuple_state else (s ** 2).sum()

    def start(x):
        return (x, torch.zeros(3)) if tuple_state else x

    grads = []
    for adjoint in (True, False):
        p = [w0.clone().requires_grad_(True), b0.clone().requires_grad_(True)]
        x = x0.clone().requires_grad_(True)
        if adjoint:
            final = odeint_adjoint(f, p, start(x), [0.0, 1.5], rtol=1e-6, atol=1e-6)
        else:
            final = start(x)
            for t0, t1 in zip(np.linspace(0, 1.5, 401)[:-1], np.linspace(0, 1.5, 401)[1:]):
                h = t1 - t0
                k1 = f(p, t0, final)
                k2 = f(p, t0 + h / 2, _axpy(final, k1, h / 2))
                k3 = f(p, t0 + h / 2, _axpy(final, k2, h / 2))
                k4 = f(p, t1, _axpy(final, k3, h))
                final = _axpy(final, _axpy(_axpy(k1, k2, 2.0), _axpy(k3, k4, 0.5), 2.0), h / 6)
        assert isinstance(final, tuple) == tuple_state
        loss(final).backward()
        grads.append([x.grad] + [q.grad for q in p])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)


def _axpy(x, k, a):
    """x + a * k over a tensor or a tuple of tensors."""
    if isinstance(x, tuple):
        return tuple(xi + a * ki for xi, ki in zip(x, k))
    return x + a * k
