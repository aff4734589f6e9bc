"""What every run shares: the cell's files found by name, seeds, the device
record, the clock, the import check and the result line.

Files are found by name under the benchmark's own folder (or the folders a
test passes): ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py`` and ``kernels/*.json``.
``BENCHMARK.json`` at the checkout's root says which metrics a cell reports;
a cell it does not name reports every metric its driver and the readers
find.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "cfmbench"

# Top-level module names that no run may hold: the JAX stack and the JAX
# package, compared whole (the port's own name begins with the latter's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "cfm_tpu")

# The published peaks of one NVIDIA H100 SXM (dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def derive_seed(*parts: int) -> int:
    """A 63-bit seed mixed from whole numbers of any size (numpy's
    SeedSequence), so that a run's streams never overlap."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Cell:
    """One workload: its file's entries and its configuration's."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.workload["traffic"]


def _find(kind: str, name: str, dirs: Sequence[Path], suffix: str) -> Path:
    for d in list(dirs) + [HERE / kind]:
        path = Path(d) / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind[:-1]} named {name!r} (looked for {name}{suffix} in "
                            f"{[str(d) for d in list(dirs) + [HERE / kind]]})")


def load_cell(name: str, dirs: Sequence[Path] = ()) -> Cell:
    """The cell ``name``: ``workloads/<name>.json`` and the configuration it
    names, ``configs/<config>.json`` (``dirs`` are searched first)."""
    workload = json.loads(_find("workloads", name, dirs, ".json").read_text())
    config = json.loads(_find("configs", workload["config"], dirs, ".json").read_text())
    return Cell(name, workload, config)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name: str, dirs: Sequence[Path] = ()):
    return load_module(_find("drivers", name, dirs, ".py"), f"cfmbench_driver_{name}")


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (``read(trace, outcome) -> value or
    None``), or None where the benchmark has no such reader."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    return load_module(path, "cfmbench_metric_" + name.replace(".", "_").replace("-", "_"))


def kernel_groups() -> List[Dict[str, Any]]:
    """Every ``kernels/*.json``: ``name``, ``patterns`` (substrings of a
    device operation's name) and ``order`` (the lower is matched first),
    with the file's stem as ``key``."""
    groups = []
    for path in sorted((HERE / "kernels").glob("*.json")):
        group = json.loads(path.read_text())
        group["key"] = path.stem
        groups.append(group)
    return sorted(groups, key=lambda g: (g.get("order", 100), g["key"]))


def _benchmark() -> Optional[Dict[str, Any]]:
    path = ROOT / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else None


def benchmark_units() -> Dict[str, str]:
    """Every metric's unit as ``BENCHMARK.json`` gives it, by name."""
    bench = _benchmark() or {}
    return {m["name"]: m["unit"] for m in bench.get("end_to_end", []) + bench.get("per_layer", [])}


def benchmark_metrics(cell: str) -> Optional[Dict[str, List[Dict[str, Any]]]]:
    """The ``end_to_end`` and ``per_layer`` entries of ``BENCHMARK.json``
    that ``cell`` reports, or None where the file does not name the cell."""
    bench = _benchmark()
    if bench is None or cell not in {w["name"] for w in bench.get("workloads", [])}:
        return None
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]
    return {"end_to_end": e2e, "per_layer": per_layer}


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def device_record(torch, count: int, peak_bytes: int) -> Dict[str, Any]:
    """``device`` of the result line: the card's name as torch gives it."""
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


@dataclasses.dataclass
class Check:
    """One number compared, with its limit (the run fails above it)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def set_cache_dirs() -> None:
    """Kernel and build caches inside the checkout, at fixed paths, for a
    program that compiles through Triton or PyTorch's extension builder (the
    port builds its CUDA libraries with nvcc into ``build/cfm_tpu_torch``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(BUILD / sub)


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
