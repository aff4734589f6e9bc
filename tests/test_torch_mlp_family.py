"""The rest of the port's MLP family (cfm_tpu_torch/models/mlp.py:
``VelocityNet`` with and without batch norm, ``TimeInvariantVelocityNet``,
``SimpleDenseNet``, ``_ActionNet``, ``GradModel``, ``ICNN`` and its
``transport``) against flax's (cfm_tpu/models/mlp.py), through
``models/convert.variables_from_flax``, on shared numpy inputs and seeded
weights (``tests/helpers/flax_variables.py``). Forwards
within 1e-5 and parameter gradients within 1e-4, each relative to the
tensor's max-abs; batch norm's running statistics after a train step
within 1e-5 too; each module's own initialisation against flax's statistics."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfm_tpu.models import mlp as jm
from cfm_tpu_torch.models import mlp as tm
from cfm_tpu_torch.models.convert import variables_from_flax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from flax_variables import fast_jit, random_variables  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, rtol=1e-5):
    ref = np.asarray(ref)
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _data(bs=16, dim=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=bs).astype(np.float32),
            rng.standard_normal((bs, dim)).astype(np.float32))


def _load(module, variables):
    module.load_state_dict(variables_from_flax(variables), strict=True)
    return module


def _grads_close(module, jax_grads, rtol=1e-4):
    """Each gradient within ``rtol`` of its max-abs, or of 1e-3 of the
    largest leaf's where that is more: a bias feeding a batch norm has a
    gradient of exactly 0, which both packages compute as rounding noise."""
    ref = variables_from_flax({"params": jax_grads})
    top = max(float(v.abs().max()) for v in ref.values())
    for name, p in module.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad  # unused: JAX's zeros
        want = ref[name].numpy()
        scale = max(np.abs(want).max(), 1e-3 * top)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * scale, err_msg=name)


def _tx_pairs():
    return [
        ("velocity_selu", jm.VelocityNet(dim=2), tm.VelocityNet(2, device="cpu")),
        ("velocity_gelu", jm.VelocityNet(dim=3, hidden_dims=(32, 16), activation="gelu"),
         tm.VelocityNet(3, (32, 16), "gelu", device="cpu")),
        ("velocity_leaky", jm.VelocityNet(dim=2, hidden_dims=(8,), activation="leaky_relu"),
         tm.VelocityNet(2, (8,), "leaky_relu", device="cpu")),
        ("velocity_softplus", jm.VelocityNet(dim=2, activation="softplus"),
         tm.VelocityNet(2, activation="softplus", device="cpu")),
        ("velocity_tanh_silu", jm.VelocityNet(dim=2, hidden_dims=(16, 16), activation="swish"),
         tm.VelocityNet(2, (16, 16), "swish", device="cpu")),
        ("time_invariant", jm.TimeInvariantVelocityNet(dim=3, activation="tanh"),
         tm.TimeInvariantVelocityNet(3, activation="tanh", device="cpu")),
        ("action", jm._ActionNet(w=32), tm._ActionNet(3, 32, device="cpu")),
        ("grad_model", jm.GradModel(w=32), tm.GradModel(3, 32, device="cpu")),
    ]


@pytest.mark.parametrize("name,jmod,tmod", _tx_pairs(), ids=[p[0] for p in _tx_pairs()])
def test_tx_module_matches_flax(name, jmod, tmod):
    """Forward (a batch t and a scalar t) and the gradients of a squared
    loss in the parameters; ``GradModel``'s loss differentiates through its
    gradient, so the second-order graph is held too."""
    dim = 3 if name in ("time_invariant", "action", "grad_model") or "gelu" in name else 2
    t, x = _data(dim=dim)
    variables = random_variables(jmod, jnp.asarray(t), jnp.asarray(x), seed=1)
    _load(tmod, variables)

    def jloss(p, tt):
        out = jmod.apply({"params": p}, tt, jnp.asarray(x))
        return jnp.sum(jnp.square(out)), out

    step = fast_jit(jax.value_and_grad(jloss, has_aux=True))
    (_, ref), g = step(variables["params"], jnp.asarray(t))
    _close(tmod(torch.from_numpy(t), torch.from_numpy(x)), ref)
    (_, ref_scalar), _ = step(variables["params"], jnp.full((16,), 0.25, jnp.float32))
    _close(tmod(0.25, torch.from_numpy(x)), ref_scalar)
    torch.sum(torch.square(tmod(torch.from_numpy(t), torch.from_numpy(x)))).backward()
    _grads_close(tmod, g)


def test_simple_dense_net_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 4, 4, 1)).astype(np.float32)
    jmod = jm.SimpleDenseNet(input_size=16, hidden_dims=(32, 32), output_size=5, activation="selu")
    tmod = tm.SimpleDenseNet(16, (32, 32), 5, "selu", device="cpu")
    variables = random_variables(jmod, jnp.asarray(x))
    _load(tmod, variables)

    def jrun(p):
        y = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y ** 2), y

    (_, ref), g = fast_jit(jax.value_and_grad(jrun, has_aux=True))(variables["params"])
    _close(tmod(torch.from_numpy(x)), ref)
    torch.sum(tmod(torch.from_numpy(x)) ** 2).backward()
    _grads_close(tmod, g)


def test_velocity_net_batch_norm_train_step_matches_flax():
    """One train-mode forward: outputs, the gradients, and the running
    statistics flax writes into ``batch_stats`` (momentum 0.99, the biased
    batch variance; ``torch.nn.BatchNorm1d`` would move toward the unbiased
    one, 1/15 apart at 16 samples). Then an eval-mode forward on the updated
    statistics."""
    t, x = _data(bs=16, dim=2, seed=4)
    x = 3.0 * x + 1.0
    jmod = jm.VelocityNet(dim=2, hidden_dims=(32, 32), batch_norm=True)
    tmod = tm.VelocityNet(2, (32, 32), batch_norm=True, device="cpu")
    variables = random_variables(jmod, jnp.asarray(t), jnp.asarray(x), seed=3)
    _load(tmod, variables)
    def jtrain(p):
        y, updates = jmod.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(t), jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y ** 2), (y, updates)

    (_, (out, updates)), g = fast_jit(jax.value_and_grad(jtrain, has_aux=True))(
        variables["params"])
    got = tmod(torch.from_numpy(t), torch.from_numpy(x), train=True)
    _close(got, out)
    new = variables_from_flax({"batch_stats": updates["batch_stats"]})
    state = tmod.state_dict()
    for k, v in new.items():
        _close(state[k], v.numpy())
    assert not torch.allclose(state["BatchNorm_0.var"], variables_from_flax(variables)[
        "BatchNorm_0.var"])
    torch.sum(got ** 2).backward()
    _grads_close(tmod, g)
    ev = fast_jit(jmod.apply)({"params": variables["params"],
                              "batch_stats": updates["batch_stats"]},
                             jnp.asarray(t), jnp.asarray(x))
    _close(tmod(torch.from_numpy(t), torch.from_numpy(x)), ev)


def test_icnn_and_transport_match_flax():
    """f(x), T(x) = grad f(x) and the gradients of a loss through T in the
    parameters (second order, as the ICNN losses need)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((12, 3)).astype(np.float32)
    jmod = jm.ICNN(dim=3, hidden_dims=(16, 16, 16))
    tmod = tm.ICNN(3, (16, 16, 16), device="cpu")
    variables = random_variables(jmod, jnp.asarray(x), seed=7)
    _load(tmod, variables)

    def jrun(p):
        T = jmod.transport({"params": p}, jnp.asarray(x))
        return jnp.sum(T ** 2), (jmod.apply({"params": p}, jnp.asarray(x)), T)

    (_, (ref_f, ref_T)), g = fast_jit(jax.value_and_grad(jrun, has_aux=True))(variables["params"])
    _close(tmod(torch.from_numpy(x)), ref_f)
    T = tmod.transport(torch.from_numpy(x))
    _close(T, ref_T)
    torch.sum(T ** 2).backward()
    _grads_close(tmod, g)
    with torch.no_grad():
        assert not tmod.transport(torch.from_numpy(x)).requires_grad


def _flax_leaves(variables):
    return variables_from_flax(variables)


INIT_CASES = [
    ("velocity_bn", lambda: jm.VelocityNet(dim=2, batch_norm=True),
     lambda s: tm.VelocityNet(2, batch_norm=True, seed=s, device="cpu"), "tx2"),
    ("time_invariant", lambda: jm.TimeInvariantVelocityNet(dim=2),
     lambda s: tm.TimeInvariantVelocityNet(2, seed=s, device="cpu"), "tx2"),
    ("simple_dense", lambda: jm.SimpleDenseNet(input_size=16, hidden_dims=(64, 64)),
     lambda s: tm.SimpleDenseNet(16, (64, 64), seed=s, device="cpu"), "x16"),
    ("grad_model", lambda: jm.GradModel(w=64), lambda s: tm.GradModel(2, 64, seed=s, device="cpu"),
     "tx2"),
    ("icnn", lambda: jm.ICNN(dim=2), lambda s: tm.ICNN(2, seed=s, device="cpu"), "x2"),
]


@pytest.mark.parametrize("name,jmake,tmake,inputs", INIT_CASES, ids=[c[0] for c in INIT_CASES])
def test_init_statistics_match_flax(name, jmake, tmake, inputs):
    """Over 8 seeds, each weight's std within four standard errors of
    flax's (4 / sqrt(2 n) relative for n draws; lecun-normal kernels, the
    ICNN's ``wz`` normal(0.05)), its largest magnitude within
    flax's truncation, zero biases, unit norm scales, batch statistics at
    mean 0 and var 1."""
    args = {"tx2": (jnp.zeros((4,)), jnp.zeros((4, 2))), "x2": (jnp.zeros((4, 2)),),
            "x16": (jnp.zeros((4, 16)),)}[inputs]
    flax, port = {}, {}
    init = fast_jit(jmake().init)
    for seed in range(8):
        for k, v in _flax_leaves(init(jax.random.PRNGKey(seed), *args)).items():
            flax.setdefault(k, []).append(v.numpy().ravel())
        for k, v in tmake(seed).state_dict().items():
            port.setdefault(k, []).append(v.numpy().ravel())
    assert flax.keys() == port.keys()
    for k in flax:
        f, p = np.concatenate(flax[k]), np.concatenate(port[k])
        leaf = k.split(".")[-1]
        if leaf in ("bias", "mean") or (leaf == "weight" and "BatchNorm" in k) or leaf == "var":
            np.testing.assert_array_equal(p, f, err_msg=k)
            continue
        assert abs(p.std() / f.std() - 1) < 4 / np.sqrt(2 * p.size), (k, p.std(), f.std())
        if leaf == "weight":
            assert np.abs(p).max() <= f.std() * 2 / 0.87962566103423978 * 1.1, k
