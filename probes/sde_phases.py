#!/usr/bin/env python3
"""Build the port's kernels and run ``chip_smoke.py``'s phases 19-22 alone
(MNIST [SF]2M by SDE, ``2d_sf2m`` with ``eval.sde``, activation
checkpointing on ``cifar10_otcfm`` and ImageNet-64, tsit5 and the
continuous adjoint), on one CUDA card, in about three minutes:

    python3 probes/sde_phases.py          # all four
    python3 probes/sde_phases.py 21       # some of them (22 runs 19 first)

Phase 22's tsit5 is printed beside phase 6's dopri5 as ``chip_smoke.py``
last measured it (NFE 62, 287-292 images/s), which this script does not
run. It prints what the phases log and the launch counts of their windows.
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


def main(argv) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.time()
    _build.build_all()
    cs.log(f"built in {time.time() - t0:.1f} s; {smi}")
    phases = set(argv) or {"19", "20", "21", "22"}
    launches = {}
    if phases & {"19", "22"}:
        t0 = time.time()
        trainer, counts = cs.mnist_sde(smi)
        launches.update(counts)
        cs.log(f"phase 19 took {time.time() - t0:.1f} s")
    if "20" in phases:
        t0 = time.time()
        launches["2d_sf2m eval.sde"] = cs.sf2m_sde(smi)
        cs.log(f"phase 20 took {time.time() - t0:.1f} s")
    if "21" in phases:
        t0 = time.time()
        imagenet = cs.seeded_model(cs.IMAGENET64, torch.bfloat16, "cuda", seed=0, dropout=0.1)
        launches.update(cs.checkpointing(imagenet, smi))
        del imagenet
        cs.log(f"phase 21 took {time.time() - t0:.1f} s")
    if "22" in phases:
        t0 = time.time()
        launches["tsit5 generation"] = cs.tsit5_generation(DOPRI5, smi)
        launches["adjoint"] = cs.adjoint_gradients(trainer, smi)
        cs.log(f"phase 22 took {time.time() - t0:.1f} s")
    print(launches)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
