#!/usr/bin/env python3
"""Build the port's kernels and run some of ``chip_smoke.py``'s later phases
alone on one CUDA card, each timed, with what it logs and returns:

    python3 probes/phases.py 27 31       # the phases named
    python3 probes/phases.py             # every phase of the table

The table: 3 (the GroupNorm kernels at ``ResNetDiffEq``'s shapes and
beyond the strip, and phase 4's timing at 256x256 float32), 18 (the
presets as given), 19-22 (SDE generation, activation checkpointing, tsit5
and the continuous adjoint), 23-26 (the single-cell path), 27-31 (the
research variants), 32-33 (data parallelism; 32 prints its step beside
phase 8's time in ``chip_smoke.py``'s last full run, ``PHASE8_MS``) and
34-35 (the examples and the notebooks). A phase that needs another's result runs that one
first (22 needs 19's trainer, 25 needs 24's plans). Phase 22's tsit5 is
printed beside phase 6's dopri5 as ``chip_smoke.py`` last measured it
(NFE 62, 292.39 images/s), which this script does not run.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cfm_tpu_torch.ops import _build  # noqa: E402

DOPRI5 = (62, 292.39)  # phase 6's NFE and images/s in chip_smoke.py's last full run


def table(smi, need):
    """{phase: a function that runs it}; ``need(p)`` is phase p's result."""
    cifar = dict(auction=1, attn_block_fwd=5, attn_block_bwd=5,
                 gn_silu_fwd=cs.GN_PER_EVAL["cifar10"], gn_silu_bwd=cs.GN_PER_EVAL["cifar10"])

    def joint_plans():
        with cs.scipy_pool() as pool:
            joint, launches, w2, check = cs.single_cell_joint_plans(smi, pool)
            check()
        return joint, launches, w2

    def imagenet_checkpointing():
        model = cs.seeded_model(cs.IMAGENET64, torch.bfloat16, "cuda", seed=0, dropout=0.1)
        return cs.checkpointing(model, smi)

    return {
        "3": lambda: [cs.check_gn_diffeq(), cs.check_gn_diffeq(6), cs.check_gn_beyond(),
                      cs.time_gn_beyond(smi)],
        "18": lambda: cs.presets_as_given(cifar, smi),
        "19": lambda: cs.mnist_sde(smi),
        "20": lambda: cs.sf2m_sde(smi),
        "21": imagenet_checkpointing,
        "22": lambda: (cs.tsit5_generation(DOPRI5, smi),
                       cs.adjoint_gradients(need("19")[0], smi)),
        "23": lambda: cs.single_cell_synthetic(smi),
        "24": joint_plans,
        "25": lambda: cs.spline_and_interpolation(need("24")[0], need("24")[2], smi),
        "26": lambda: cs.grn_models(smi),
        "27": lambda: cs.cnf_maximum_likelihood(smi),
        "28": lambda: cs.ot_study(smi),
        "29": lambda: cs.bridges(smi),
        "30": lambda: cs.action_and_icnn(smi),
        "31": lambda: cs.diffeq_zoo(smi),
        "32": lambda: cs.data_parallel_one_rank(cifar, cs.PHASE8_MS, smi),
        "33": lambda: cs.data_parallel_two_ranks(smi),
        "34": lambda: cs.train_2d_runs(smi),
        "35": lambda: cs.notebooks_on_card(smi),
    }


def main(argv) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.time()
    _build.build_all()
    cs.log(f"built in {time.time() - t0:.1f} s; {smi}")
    results = {}

    def need(p):
        if p not in results:
            t0 = time.time()
            results[p] = runs[p]()
            cs.log(f"phase {p} took {time.time() - t0:.1f} s")
        return results[p]

    runs = table(smi, need)
    unknown = set(argv) - set(runs)
    if unknown:
        raise SystemExit(f"no such phase in the table: {sorted(unknown)}; it has {list(runs)}")
    for p in sorted(set(argv) or runs, key=int):
        out = need(p)
        cs.log(f"phase {p}: {out if isinstance(out, (dict, float, tuple)) else type(out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
