"""The harness on the CPU: its files, the result line, a throwaway cell in
a temporary folder, the import check, the faults that the check must catch,
and the control."""

from __future__ import annotations

import json

import pytest
import torch

from cfmbench import calibrate, harness, run
from cfmbench.tests import tiny

torch.set_num_threads(2)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("cells"))


def _result(capsys, argv, folder, fault=None):
    rc = run.main(argv, dirs=[str(folder)], device="cpu", fault=fault)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_every_cell_and_metric_has_its_files():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert bench["paths"] == ["cfmbench"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"] and cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        harness.load_driver(cell.driver)
        assert set(cell.traffic["limits"]) <= {"loss_gap", "grad_gap", "change_gap", "ema_gap",
                                                "image_rms_levels", "nfe_gap"}
    for c in bench["configs"]:
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in bench["per_layer"]:
        assert harness.metric_reader(m["name"]) is not None, m["name"]
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= names


def test_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["cfm_tpu_torch", "cfm_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["cfm_tpu", "cfm_tpu.ops.x", "jax", "jaxlib.xla_client",
                                      "flax", "optax"]) == ["cfm_tpu", "flax", "jax", "jaxlib",
                                                            "optax"]


@pytest.mark.parametrize("trace", [0, 1])
def test_a_throwaway_cell_runs_and_prints_the_contract(capsys, folder, trace):
    result, err = _result(capsys, ["--workload", "tiny-train", "--seed", str(2 ** 33 + 7),
                                   "--seconds", "1", "--trace", str(trace)], folder)
    assert list(result)[:5] == KEYS[:5] and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == set(tiny.TRAIN_LIMITS)
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert set(result["metrics"]) == {"train_images_per_s", "train_step_ms_p90", "setup_s"}
    assert harness.forbidden_modules() == []


def test_generation_cell_runs(capsys, folder):
    result, _ = _result(capsys, ["--workload", "tiny-gen-euler", "--seed", "12", "--seconds",
                                 "1"], folder)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"gen_images_per_s", "setup_s"}


@pytest.fixture
def program_restored(monkeypatch):
    """The program's functions that a fault replaces, put back after the
    test (a fault planted in this process would reach the next test's rank
    0, and a rank that skips a collective leaves the other waiting)."""
    import cfm_tpu_torch.generate
    import cfm_tpu_torch.paths
    import cfm_tpu_torch.train

    for module in (cfm_tpu_torch.generate, cfm_tpu_torch.train):
        for name in ("odeint", "quantize_to_uint8", "ema_update", "_all_reduce_flat"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, getattr(module, name))
    monkeypatch.setattr(cfm_tpu_torch.train.Optimizer, "apply",
                        cfm_tpu_torch.train.Optimizer.apply)
    ot = cfm_tpu_torch.paths.ExactOptimalTransportConditionalFlowMatcher
    monkeypatch.setattr(ot, "guided_sample_location_and_conditional_flow",
                        ot.guided_sample_location_and_conditional_flow)


@pytest.mark.parametrize("cell,fault", [("tiny-train", "frozen"), ("tiny-train", "half_batch"),
                                        ("tiny-gen-euler", "frozen"),
                                        ("tiny-gen-euler", "altered"),
                                        ("tiny-gen-euler", "fails_once")])
@pytest.mark.usefixtures("program_restored")
def test_a_broken_path_reads_not_correct(capsys, folder, cell, fault):
    result, _ = _result(capsys, ["--workload", cell, "--seed", "31", "--seconds", "1"], folder,
                        fault=fault)
    assert result["correct"] is False
    if fault == "fails_once":  # the checked batch may be a sound one
        assert result["failed"] > 0


@pytest.mark.parametrize("fault", [None, "no_exchange"])
@pytest.mark.usefixtures("program_restored")
def test_data_parallel_cell_on_two_cpu_ranks(capsys, folder, fault):
    result, _ = _result(capsys, ["--workload", "tiny-train-dp2", "--seed", "41", "--seconds",
                                 "1"], folder, fault=fault)
    assert result["correct"] is (fault is None)
    assert result["device"]["count"] == 2


def test_a_forbidden_module_on_another_rank_prints_no_result(capsys, folder):
    rc = run.main(["--workload", "tiny-train-dp2", "--seed", "43", "--seconds", "1"],
                  dirs=[str(folder)], device="cpu", fault="forbidden_on_rank1")
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert harness.forbidden_modules() == []


@pytest.mark.skipif(torch.cuda.is_available() and torch.cuda.device_count() >= 2,
                    reason="the machine has the two CUDA devices that the cell asks for")
def test_too_few_cards_stop_every_rank_and_print_no_result(capsys, folder):
    rc = run.main(["--workload", "tiny-train-dp2", "--seed", "45", "--seconds", "1"],
                  dirs=[str(folder)])
    out = capsys.readouterr()
    assert rc == 2 and out.out.strip() == ""
    assert "needs 2 CUDA device(s)" in out.err


def test_the_control_fails_the_limits(capsys, folder):
    """The float8 control against the float32 reference, on three seeds:
    it fails one of the train cell's numbers and the generation cell's."""
    for cell, limits in (("tiny-train", tiny.TRAIN_LIMITS), ("tiny-gen-euler", tiny.GEN_LIMITS)):
        calibrate.main(["--workload", cell, "--seeds", "1,2,3", "--program", "1"],
                       dirs=[str(folder)], device="cpu")
        lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
        for line in lines:
            assert all(line["program"][k] <= v for k, v in limits.items()), line
            assert any(line["control"][k] > v for k, v in limits.items()), line
