"""The readings that a cell's limits are set from, over many seeds in one
process: for each seed, the numbers that a run compares, read from the
program (``--program 1``) and from the control (``--control 1``: the plain
reference computed in float8 e4m3, the nearest precision below the
configurations' bfloat16), each against the float32 reference, at the
cell's own sizes. One JSON line a seed on standard output.

    python3 -m cfmbench.calibrate --workload <cell> --seeds 11,12,13 --program 1 --control 1

A training cell's program readings need its cards (one process a card),
so a four-card cell reads here its control only; its program readings come
from its runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import types

import torch

from cfmbench import harness


def main(argv=None, dirs=(), device=None) -> int:
    p = argparse.ArgumentParser(prog="cfmbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    from cfmbench.run import Run

    cell = harness.load_cell(args.workload, dirs)
    device = device or "cuda"
    if device == "cuda":
        torch.cuda.set_device(0)
    if cell.chips > 1 and args.program:
        raise SystemExit("a multi-card cell's program readings come from its runs (--program 0)")
    seeds = [int(s) for s in args.seeds.split(",")]
    ns = types.SimpleNamespace(seed=seeds[0], seconds=0.0, trace=0)
    run = Run(cell, ns, 0, cell.chips, device, None, time.perf_counter())
    drv = harness.load_driver(cell.driver, dirs)
    model = None
    if args.program:
        from cfmbench.program import build_model

        model = build_model(run)
    for seed in seeds:
        run.seed = seed
        line = {"workload": cell.name, "seed": seed}
        t0 = time.perf_counter()
        if cell.driver == "train":
            line.update(_train(run, drv, model, args))
        else:
            line.update(_generate(run, drv, model, args))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _train(run, drv, model, args):
    from cfmbench.reference import train as reference
    from cfmbench.weights import make_weights

    out = {}
    program = None
    if args.program:
        cfg = run.cell.config
        model.load_state_dict(make_weights(cfg["model"], cfg["weights_seed"], run.device))
        prog = drv.Program(run, model)
        program = prog.checked_steps(run.cell.traffic["checked_steps"])
        del prog
        _free()
    ref = drv.reference_readings(run)
    if program is not None:
        out["program"] = reference.compare(program, ref)
    if args.control:
        control = drv.reference_readings(run, quant="fp8")
        out["control"] = reference.compare(control, ref)
        del control
    del ref, program
    _free()
    return out


def _generate(run, drv, model, args):
    from cfm_tpu_torch import generate as program

    traffic, arch = run.cell.traffic, run.cell.config["model"]
    rows = drv.check_rows(run)
    out = {}
    got = None
    if args.program:
        x0, y = drv.batch_inputs(run, 1)
        gen = program.generate(model, traffic["batch"], x0=x0, y=y, device=run.device,
                               x_shape=tuple(arch["dim"]), method=traffic["method"],
                               n_steps=traffic.get("n_steps", 100),
                               rtol=traffic.get("rtol", 1e-5), atol=traffic.get("atol", 1e-5))
        got = (gen.images[rows], gen.nfe)
        del gen
        _free()
    want, want_nfe = drv.reference_images(run, 1, rows)
    out["reference_nfe"] = want_nfe
    if got is not None:
        out["program"] = drv.gaps(got[0], got[1], want, want_nfe)
        out["program_nfe"] = got[1]
    if args.control:
        ctl, ctl_nfe = drv.reference_images(run, 1, rows, quant="fp8")
        out["control"] = drv.gaps(ctl, ctl_nfe, want, want_nfe)
        out["control_nfe"] = ctl_nfe
    _free()
    return out


if __name__ == "__main__":
    sys.exit(main())
