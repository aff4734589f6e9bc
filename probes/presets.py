#!/usr/bin/env python3
"""Build the port's kernels and run ``chip_smoke.py``'s phase 18 alone (the
presets as given: ``cli train cifar10_otcfm`` through a checkpoint and two
evaluations, the resume's bit checks, ``cli eval``, both ``compute_fid``
routes), on one CUDA card, in about two minutes:

    python3 probes/presets.py

It prints what the phase logs and the launch counts of its windows.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from cfm_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.time()
    _build.build_all()
    cs.log(f"built in {time.time() - t0:.1f} s; {smi}")
    per_step = dict(auction=1, attn_block_fwd=5, attn_block_bwd=5,
                    gn_silu_fwd=cs.GN_PER_EVAL["cifar10"], gn_silu_bwd=cs.GN_PER_EVAL["cifar10"])
    t0 = time.time()
    print(cs.presets_as_given(per_step, smi))
    cs.log(f"phase 18 took {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
