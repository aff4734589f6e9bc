"""On the card only (``python -m pytest cfmbench/tests -m cuda``): the
control at each one-card cell's own size, on three seeds, fails the cell's
limits, and the program at the same seeds passes them."""

from __future__ import annotations

import json

import pytest
import torch

from cfmbench import calibrate, harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]
         if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(capsys, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = harness.load_cell(cell).traffic["limits"]
    calibrate.main(["--workload", cell, "--seeds", "901,902,903", "--program", "1"])
    for line in capsys.readouterr().out.strip().splitlines():
        reading = json.loads(line)
        assert all(reading["program"][k] <= v for k, v in limits.items()), reading
        assert any(reading["control"][k] > v for k, v in limits.items()), reading
