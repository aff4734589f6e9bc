#!/usr/bin/env python3
"""Build the port's kernels and run ``chip_smoke.py``'s phases 23-26 alone
(the single-cell path: ``single_cell --synthetic`` and ``--npz``, the joint
plans with a held-out timepoint, spline CFM and the OT interpolation, the
GRN models), on one CUDA card, in about three minutes:

    python3 probes/single_cell_phases.py          # all four
    python3 probes/single_cell_phases.py 23 26    # some of them (25 runs 24 first)

It prints what the phases log and the launch counts of their windows.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from cfm_tpu_torch.ops import _build  # noqa: E402


def main(argv) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.time()
    _build.build_all()
    cs.log(f"built in {time.time() - t0:.1f} s; {smi}")
    phases = set(argv) or {"23", "24", "25", "26"}
    launches = {}
    if "23" in phases:
        t0 = time.time()
        launches.update(cs.single_cell_synthetic(smi))
        cs.log(f"phase 23 took {time.time() - t0:.1f} s")
    if phases & {"24", "25"}:
        t0 = time.time()
        with cs.scipy_pool() as pool:
            joint, launches["single_cell joint plans"], w2, check = cs.single_cell_joint_plans(
                smi, pool)
            check()
        cs.log(f"phase 24 took {time.time() - t0:.1f} s (scipy's checks included)")
    if "25" in phases:
        t0 = time.time()
        launches["spline cfm"] = cs.spline_and_interpolation(joint, w2, smi)
        cs.log(f"phase 25 took {time.time() - t0:.1f} s")
    if "26" in phases:
        t0 = time.time()
        cs.grn_models(smi)
        cs.log(f"phase 26 took {time.time() - t0:.1f} s")
    print(launches)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
