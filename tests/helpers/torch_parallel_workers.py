"""One rank of ``tests/test_torch_parallel.py``: the port's side of its checks.

    python tests/helpers/torch_parallel_workers.py RANK WORLD INIT_FILE INPUTS OUT_DIR

Joins a gloo group through a ``file://`` store, runs each data-parallel
entry point of ``cfm_tpu_torch`` on the inputs that the test wrote
(``torch.save`` of a dict: the MLP's weights, the batches and JAX's draws)
and saves what it saw to ``OUT_DIR/rank<RANK>.pt``. It imports torch and
``cfm_tpu_torch`` only, never JAX.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from cfm_tpu_torch import profiling  # noqa: E402
from cfm_tpu_torch import train as ttr  # noqa: E402
from cfm_tpu_torch.config import load_config  # noqa: E402
from cfm_tpu_torch.models.mlp import MLP  # noqa: E402
from cfm_tpu_torch.ops.sharded_sinkhorn import sharded_sinkhorn_plan  # noqa: E402
from cfm_tpu_torch.parallel import initialize_distributed, local_coupling_step  # noqa: E402
from cfm_tpu_torch.parallel.mesh import axis_index  # noqa: E402
from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher  # noqa: E402
from cfm_tpu_torch.trainer import Trainer  # noqa: E402


def _model(inp):
    model = MLP(2, w=inp["width"], device="cpu")
    model.load_state_dict(inp["params"])
    return model


def _snapshot(state, metrics):
    return {"params": [p.detach().clone() for p in state.params],
            "ema": [e.clone() for e in state.ema_params],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _steps(inp, make, draws_of, batch_of):
    """Run ``inp["steps"]`` steps of the step ``make(model, opt)`` builds;
    the state after each."""
    model = _model(inp)
    opt = ttr.make_optimizer(lr=inp["lr"], warmup_steps=inp["warmup"], grad_clip=1.0)
    state = ttr.init_train_state(model, opt)
    step = make(model, opt)
    out = []
    for i in range(inp["steps"]):
        kw = draws_of(i)
        out.append(_snapshot(state, step(state, *batch_of(i), **kw)))
    return out


def _draws(d):
    return ttr.StepDraws(d["t"], d["eps"], d.get("plan_u"))


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def main(rank: int, world: int, init_file: str, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{init_file}", world_size=world, rank=rank)
    inp = torch.load(inputs, weights_only=False)
    mesh = ttr.make_mesh()
    idx, count = axis_index(mesh, "data")
    matcher = ExactOptimalTransportConditionalFlowMatcher(sigma=inp["sigma"])
    x0, x1 = inp["x0"], inp["x1"]
    shard = x0.shape[0] // count
    mine = slice(idx * shard, (idx + 1) * shard)
    res = {"index": idx, "count": count}

    profiling.enable_spans(True)
    res["replicated"] = _steps(
        inp, lambda m, o: ttr.make_data_parallel_train_step(matcher, m, o, mesh,
                                                            ema_decay=inp["decay"]),
        lambda i: dict(plan_noise=inp["replicated"][i]["plan_u"],
                       draws=_draws(inp["replicated"][i]["ranks"][idx])),
        lambda i: (x0, x1))
    profiling.enable_spans(False)
    res["replicated_spans"] = [(s.name, s.parent, s.root) for s in profiling.drain()[0]]
    res["local"] = _steps(
        inp, lambda m, o: local_coupling_step(ttr.make_train_step(
            matcher, m, o, ema_decay=inp["decay"], data_axis="data", mesh=mesh), mesh),
        lambda i: dict(draws=_draws(inp["local"][i]["ranks"][idx])),
        lambda i: (x0, x1))
    res["gathered"] = _steps(
        inp, lambda m, o: ttr.make_data_parallel_step(ttr.make_train_step(
            matcher, m, o, ema_decay=inp["decay"]), mesh),
        lambda i: dict(draws=_draws(inp["gathered"][i])),
        lambda i: (x0[mine], x1[mine]))

    sk = inp["sinkhorn"]
    rows = sk["x0"].shape[0] // count
    res["sinkhorn"] = sharded_sinkhorn_plan(mesh, sk["x0"][idx * rows:(idx + 1) * rows], sk["x1"],
                                            sk["reg"], num_iters=sk["iters"])
    sm = inp["sampler"]
    sample = ttr.make_data_parallel_sample_fn(_model(inp), mesh, sm["noise"].shape[0], (2,),
                                              method="euler", n_steps=sm["n_steps"])
    res["sample_rows"] = sample(x0=sm["noise"])
    res["sample_gathered"] = ttr.make_data_parallel_sample_fn(
        _model(inp), mesh, sm["noise"].shape[0], (2,), method="euler", n_steps=sm["n_steps"],
        gather=True)(x0=sm["noise"])

    model = _model(inp)
    opt = ttr.make_optimizer(lr=inp["lr"], warmup_steps=inp["warmup"])
    state = ttr.init_train_state(model, opt)
    odd = (x0[:-1], x1[:-1])
    res["refuse_replicated"] = _refusal(
        lambda: ttr.make_data_parallel_train_step(matcher, model, opt, mesh)(state, *odd))
    res["refuse_local"] = _refusal(lambda: local_coupling_step(
        ttr.make_train_step(matcher, model, opt, data_axis="data", mesh=mesh), mesh)(state, *odd))

    tr = inp["trainer"]
    overrides = [f"trainer.ckpt_dir={tr['ckpt_dir']}", "trainer.data_parallel=True",
                 "trainer.log_interval=2", "trainer.eval_interval=4",
                 "eval.num_eval_samples=64", "data.batch_size=32", "model.width=32"]
    log_dir = os.path.join(tr["log_root"], f"rank{rank}")
    first = Trainer(load_config("2d_otcfm", overrides + ["trainer.total_steps=4"]),
                    device="cpu", log_dir=log_dir)
    first.fit()
    res["trainer_first"] = {"parallel": first.mesh is not None, "step": first.state.step,
                            "evals": len(first.eval_log),
                            "params": [p.detach().clone() for p in first.state.params]}
    again = Trainer(load_config("2d_otcfm", overrides + ["trainer.total_steps=6"]),
                    device="cpu", log_dir=log_dir)
    restored = again.state.step
    again.fit()
    res["trainer_again"] = {"restored": restored, "step": again.state.step,
                            "params": [p.detach().clone() for p in again.state.params]}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
