"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each source under ``cfm_tpu_torch/csrc/`` exposes a plain C interface and is
compiled alone by ``nvcc`` into a shared library under ``build/cfm_tpu_torch/``
at the repository root (``build/`` is git-ignored). The library's file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import: the
CPU tests import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cfm_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: Path
    log: str  # nvcc's output (the -Xptxas -v register and shared-memory lines)


_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILT: Dict[str, Built] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built at first use on a machine with the CUDA toolkit")


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    if name in _BUILT:
        return _BUILT[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        built = Built(out, "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        built = Built(out, proc.stdout + proc.stderr)
    _BUILT[name] = built
    return built


def build_all() -> Dict[str, Built]:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` process per source."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name).path))
    return _LIBS[name]
