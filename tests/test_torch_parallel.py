"""The port's data parallelism (cfm_tpu_torch/parallel, the data-parallel
helpers of cfm_tpu_torch/train.py, ops/sharded_sinkhorn.py and the
Trainer's data-parallel branch) against the JAX package on a 2-device mesh.

Two gloo ranks run once for the module: ``tests/helpers/torch_parallel_workers.py``
(torch only) in two processes joined by a ``file://`` store under the
module's temporary directory, on inputs this file writes. The JAX side runs
on conftest's virtual CPU devices, a mesh of ``jax.devices()[:2]``, while
the ranks work. The port is given JAX's draws: the coupling's uniforms from
the coupling key, each rank's t and eps from ``fold_in(key, rank)``, as
``tests/test_train_e2e.py::test_replicated_coupling_data_parallel_step``
decomposes them.

- The replicated-coupling step against ``make_data_parallel_train_step``,
  the local-coupling step against ``local_coupling_step`` and
  ``make_data_parallel_step`` against the one-process step on the gathered
  batch: 2-D OT-CFM, an MLP at width 32, global batch 16, two steps, loss
  and grad norm to 1e-5 relative and parameters and EMA to 1e-5, as
  ``test_train_step_matches_jax_step`` holds them. The ranks' parameters
  are equal bit for bit after every step.
- ``sharded_sinkhorn_plan`` against JAX's and against the dense plan on
  the gathered batch, to 1e-5 of the plan's maximum.
- The data-parallel sampler against JAX's and against one-process ``odeint``.
- The untagged-step and indivisible-batch refusals.
- A ``Trainer`` on ``2d_otcfm`` at world size 2: rank 0 alone writes its
  logs, hparams and checkpoints and evaluates, the ranks stay equal, and a
  second ``Trainer`` resumes from the checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfm_tpu_torch import train as ttr

HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers",
                      "torch_parallel_workers.py")
WORLD, B, WIDTH, STEPS, SIGMA, LR, WARMUP, DECAY = 2, 16, 32, 2, 0.1, 1e-3, 10, 0.99
SK_N, SK_REG, SK_ITERS = 64, 0.5, 100
SAMPLES, EULER_STEPS = 32, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work, as the other port files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_draws(key):
    """Every draw the three steps make at one step key, as JAX makes them."""
    import jax

    def path(key, n):  # make_train_step's matcher key, split into (t, eps)
        t_key, eps_key = jax.random.split(key)
        return {"t": _t(jax.random.uniform(t_key, (n,))),
                "eps": _t(jax.random.normal(eps_key, (n, 2)))}

    def coupled(key, n):  # matcher key -> (plan key, path key)
        plan_key, path_key = jax.random.split(jax.random.split(key, 3)[0])
        return {"plan_u": _t(jax.random.uniform(plan_key, (n,))), **path(path_key, n)}

    shard = B // WORLD
    kc, kstep = jax.random.split(key)
    return {
        "replicated": {"plan_u": _t(jax.random.uniform(kc, (B,))),
                       "ranks": [path(jax.random.split(jax.random.fold_in(kstep, r), 3)[0], shard)
                                 for r in range(WORLD)]},
        "local": {"ranks": [coupled(jax.random.fold_in(key, r), shard) for r in range(WORLD)]},
        "gathered": coupled(key, B),
    }


def _jax_side(params, x0, x1, keys, sk, noise_key):
    """JAX's results on the 2-device mesh: the three steps' states and
    metrics after each step, the sharded plan, the sharded samples."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cfm_tpu import train as jtr
    from cfm_tpu.models.mlp import MLP as JMLP
    from cfm_tpu.ops.sharded_sinkhorn import sharded_sinkhorn_plan
    from cfm_tpu.parallel.mesh import local_coupling_step
    from cfm_tpu.paths import ExactOptimalTransportConditionalFlowMatcher

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    m = JMLP(dim=2, w=WIDTH)
    matcher = ExactOptimalTransportConditionalFlowMatcher(sigma=SIGMA)
    opt = jtr.make_optimizer(lr=LR, warmup_steps=WARMUP, grad_clip=1.0)
    steps = {
        "replicated": jtr.make_data_parallel_train_step(matcher, m.apply, opt, mesh,
                                                        ema_decay=DECAY),
        "local": jax.jit(local_coupling_step(
            jtr.make_train_step(matcher, m.apply, opt, ema_decay=DECAY, data_axis="data"), mesh)),
        "gathered": jax.jit(jtr.make_train_step(matcher, m.apply, opt, ema_decay=DECAY)),
    }
    out = {}
    for name, step in steps.items():
        state = jtr.init_train_state(jax.tree.map(jnp.copy, params), opt)
        out[name] = []
        for key in keys:
            state, metrics = step(state, key, jnp.asarray(x0), jnp.asarray(x1))
            out[name].append((jax.tree.map(np.asarray, state.params),
                              jax.tree.map(np.asarray, state.ema_params),
                              {k: float(v) for k, v in metrics.items()}))
    out["sinkhorn"] = np.asarray(sharded_sinkhorn_plan(mesh, jnp.asarray(sk["x0"]),
                                                       jnp.asarray(sk["x1"]), SK_REG,
                                                       num_iters=SK_ITERS))
    out["samples"] = np.asarray(jtr.make_data_parallel_sample_fn(
        m.apply, mesh, SAMPLES, (2,), method="euler", n_steps=EULER_STEPS)(params, noise_key))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX's results, each rank's results, the directory): the
    ranks run while JAX computes its side."""
    import jax

    from cfm_tpu.models.mlp import MLP as JMLP
    from cfm_tpu_torch.models.convert import mlp_params_from_flax

    d = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(31)
    x0 = (2 * rng.standard_normal((B, 2))).astype(np.float32)
    x1 = (0.5 * rng.standard_normal((B, 2)) + 1).astype(np.float32)
    params = JMLP(dim=2, w=WIDTH).init(jax.random.PRNGKey(3), np.zeros((1,), np.float32),
                                       np.zeros((1, 2), np.float32))
    keys = [jax.random.fold_in(jax.random.PRNGKey(100), i) for i in range(STEPS)]
    draws = [_jax_draws(k) for k in keys]
    sk = {"x0": rng.standard_normal((SK_N, 2)).astype(np.float32),
          "x1": (rng.standard_normal((SK_N, 2)) + 2).astype(np.float32)}
    noise_key = jax.random.PRNGKey(5)
    inp = {"width": WIDTH, "params": mlp_params_from_flax(params["params"]), "x0": _t(x0),
           "x1": _t(x1), "sigma": SIGMA, "lr": LR, "warmup": WARMUP, "decay": DECAY,
           "steps": STEPS, **{k: [dr[k] for dr in draws] for k in draws[0]},
           "sinkhorn": {"x0": _t(sk["x0"]), "x1": _t(sk["x1"]), "reg": SK_REG,
                        "iters": SK_ITERS},
           "sampler": {"noise": _t(jax.random.normal(noise_key, (SAMPLES, 2))),
                       "n_steps": EULER_STEPS},
           "trainer": {"ckpt_dir": str(d / "ckpt"), "log_root": str(d / "logs")}}
    torch.save(inp, d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, HELPER, str(r), str(WORLD), str(d / "store"),
                               str(d / "inputs.pt"), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        ref = _jax_side(params, x0, x1, keys, sk, noise_key)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return inp, ref, ranks, d


def _held(port, jax_step):
    """The port's state and metrics after one step against JAX's."""
    from cfm_tpu_torch.models.convert import mlp_params_from_flax
    from cfm_tpu_torch.models.mlp import MLP

    params, ema, metrics = jax_step
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(port["metrics"][k], metrics[k], rtol=1e-5, err_msg=k)
    assert port["metrics"]["coupling_degenerate"] == metrics["coupling_degenerate"] == 0.0
    names = [n for n, _ in MLP(2, w=WIDTH, device="cpu").named_parameters()]
    for got, want in ((port["params"], params), (port["ema"], ema)):
        want = mlp_params_from_flax(want["params"])
        for name, g in zip(names, got):
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kind", ["replicated", "local", "gathered"])
def test_steps_match_jax_on_a_two_device_mesh(runs, kind):
    """``replicated``: make_data_parallel_train_step on both sides;
    ``local``: local_coupling_step; ``gathered``: the port's
    make_data_parallel_step against JAX's one-process step on the whole
    batch. Every step of every rank at the stated tolerances, and the two
    ranks' parameters and EMA equal bit for bit."""
    _, ref, ranks, _ = runs
    for i in range(STEPS):
        for r in ranks:
            _held(r[kind][i], ref[kind][i])
        for a, b in zip(ranks[0][kind][i]["params"] + ranks[0][kind][i]["ema"],
                        ranks[1][kind][i]["params"] + ranks[1][kind][i]["ema"]):
            assert torch.equal(a, b)


def test_sharded_sinkhorn_matches_jax_and_the_dense_plan(runs):
    """Each rank's rows of the plan, stacked in rank order, against JAX's
    sharded plan and the port's dense Sinkhorn on the gathered batch (same
    iterations, no early stop): within 1e-5 of the plan's maximum."""
    from cfm_tpu_torch.ops.cost import sq_euclidean_cost
    from cfm_tpu_torch.ops.sinkhorn import sinkhorn

    inp, ref, ranks, _ = runs
    sk = inp["sinkhorn"]
    plan = torch.cat([r["sinkhorn"] for r in ranks]).numpy()
    uniform = torch.full((SK_N,), 1.0 / SK_N)
    dense = sinkhorn(uniform, uniform, sq_euclidean_cost(sk["x0"], sk["x1"]), SK_REG,
                     num_iters=SK_ITERS, tol=0.0).numpy()
    for other in (ref["sinkhorn"], dense):
        assert np.abs(plan - other).max() <= 1e-5 * np.abs(other).max()
    np.testing.assert_allclose(plan.sum(), 1.0, rtol=1e-4)


def test_data_parallel_sampler_matches_jax_and_one_process_odeint(runs):
    """Euler at 20 steps from JAX's noise: each rank returns its rows, the
    gathered samples are the rows in rank order; they equal one-process
    ``odeint`` of the same noise to 1e-6 and JAX's sharded samples to 1e-5."""
    from cfm_tpu_torch.integrate import odeint, vector_field_from_model
    from cfm_tpu_torch.models.mlp import MLP

    inp, ref, ranks, _ = runs
    rows = torch.cat([r["sample_rows"] for r in ranks])
    assert all(torch.equal(r["sample_gathered"], rows) for r in ranks)
    model = MLP(2, w=WIDTH, device="cpu")
    model.load_state_dict(inp["params"])
    with torch.inference_mode():
        one = odeint(vector_field_from_model(model), inp["sampler"]["noise"],
                     np.linspace(0.0, 1.0, EULER_STEPS + 1, dtype=np.float32), method="euler",
                     return_trajectory=False).final
    np.testing.assert_allclose(rows.numpy(), one.numpy(), atol=1e-6)
    np.testing.assert_allclose(rows.numpy(), ref["samples"], atol=1e-5)


def test_refusals_match_jax(runs):
    """A step without the data axis's tag is refused with JAX's message; a
    global batch that does not divide over the ranks raises on every rank."""
    from cfm_tpu.parallel.mesh import local_coupling_step as jax_local
    from cfm_tpu_torch.models.mlp import MLP
    from cfm_tpu_torch.parallel import local_coupling_step
    from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher

    model = MLP(2, w=WIDTH, device="cpu")
    opt = ttr.make_optimizer()
    untagged = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(), model, opt)
    with pytest.raises(ValueError) as port:
        local_coupling_step(untagged, None)
    with pytest.raises(ValueError) as ref:
        jax_local(lambda *a: a, None)
    assert str(port.value) == str(ref.value).replace("'<untagged>'", "None")
    for r in runs[2]:
        for kind in ("refuse_replicated", "refuse_local"):
            assert r[kind] == f"global batch {B - 1} must divide over {WORLD} devices"


def test_trainer_at_world_size_two_writes_once_and_resumes(runs):
    """2d_otcfm (batch 32, width 32) for 4 steps with an evaluation at 4,
    then a second Trainer that resumes at 4 and fits to 6: both ranks take
    the data-parallel branch and hold the same parameters after each fit;
    rank 0 alone evaluated and wrote the logs (two rows, then one more),
    hparams and exec_time; rank 1's log directory was never made."""
    _, _, ranks, d = runs
    for r in ranks:
        assert r["trainer_first"]["parallel"] and r["trainer_first"]["step"] == 4
        assert r["trainer_again"]["restored"] == 4 and r["trainer_again"]["step"] == 6
    assert [r["trainer_first"]["evals"] for r in ranks] == [1, 0]
    for fit in ("trainer_first", "trainer_again"):
        for a, b in zip(ranks[0][fit]["params"], ranks[1][fit]["params"]):
            assert torch.equal(a, b)
    logs = d / "logs"
    assert sorted(os.listdir(logs)) == ["rank0"]
    assert {"2d_otcfm_metrics.csv", "2d_otcfm_hparams.json", "exec_time.log"} <= set(
        os.listdir(logs / "rank0"))
    rows = (logs / "rank0" / "2d_otcfm_metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 1 + 3  # the header and steps 2, 4 and 6
    assert (logs / "rank0" / "exec_time.log").read_text().count("2d_otcfm:") == 2
