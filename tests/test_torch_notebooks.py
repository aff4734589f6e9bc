"""The port's tutorial notebooks (``cfm_tpu_torch/notebooks/``, written by
``cfm_tpu_torch/gen_notebooks.py``) against the JAX package's
(``examples/notebooks/``), on the CPU.

- The generator writes exactly the committed files, under JAX's nine
  names, without outputs.
- Each notebook has the JAX notebook's section headings in order; one cell
  tagged ``parameters`` holds ``DEVICE = "cuda"`` and sizes whose defaults
  are the JAX notebook's numbers; matplotlib and IPython are imported only
  in cells tagged ``plot``; no cell imports JAX or the JAX package.
- Each notebook's code cells run in-process on the CPU (``execute``), plots
  included under matplotlib's Agg backend, with the ``parameters`` cell set
  to ``DEVICE = "cpu"`` and the small sizes of ``gen_notebooks.SMOKE``
  (``chip_smoke.py`` phase 35 runs the same sizes on the card).
- Without matplotlib the cells other than the plots still run; without
  scikit-learn the Forest-Flow notebook raises ``ImportError``.
"""

import ast
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from cfm_tpu_torch import gen_notebooks as gn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NOTEBOOKS = os.path.join(ROOT, "examples", "notebooks")
NAMES = sorted(gn.NOTEBOOKS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work: the suite runs six
    workers on the machine's cores, and torch's OpenMP pool of one thread a
    core then waits on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _source(cell):
    return "".join(cell["source"])


def _headings(nb):
    return [ln.strip() for c in nb["cells"] if c["cell_type"] == "markdown"
            for ln in _source(c).splitlines() if ln.startswith("#")]


def test_generator_writes_the_committed_notebooks(tmp_path, capsys):
    assert sorted(os.listdir(gn.OUT)) == NAMES == sorted(
        f for f in os.listdir(JAX_NOTEBOOKS) if f.endswith(".ipynb"))
    written = gn.main(["--out", str(tmp_path)])
    assert len(written) == len(NAMES) and capsys.readouterr().out.count("wrote") == len(NAMES)
    for name in NAMES:
        with open(tmp_path / name, "rb") as a, open(os.path.join(gn.OUT, name), "rb") as b:
            assert a.read() == b.read(), f"{name} differs from what gen_notebooks writes"
    assert gn.main(["--out", str(tmp_path / "one"), "--only", "SF2M"]) == [
        str(tmp_path / "one" / "SF2M_tutorial.ipynb")]


@pytest.mark.parametrize("name", NAMES)
def test_notebook_follows_the_jax_notebook(name):
    port, ref = _load(os.path.join(gn.OUT, name)), _load(os.path.join(JAX_NOTEBOOKS, name))
    assert _headings(port) == _headings(ref) and _headings(port)
    cells = [c for c in port["cells"] if c["cell_type"] == "code"]
    assert all(not c["outputs"] and c["execution_count"] is None for c in cells)
    params = [c for c in cells if "parameters" in gn.cell_tags(c)]
    assert len(params) == 1
    src = _source(params[0])
    assert re.search(r'^DEVICE = "cuda"', src, re.M)
    values = {}
    exec(src, values)
    assert set(gn.SMOKE[name]) <= set(values)
    jax_code = "\n".join(_source(c) for c in ref["cells"] if c["cell_type"] == "code")
    for key, value in values.items():
        if key.isupper() and isinstance(value, int) and not isinstance(value, bool):
            assert re.search(rf"\b{value}\b", jax_code), (key, value)
    for c in cells:
        text = _source(c)
        assert not re.search(r"^\s*(import|from) (jax|optax|flax|cfm_tpu)\b", text, re.M), text
        if "plot" not in gn.cell_tags(c):
            assert "matplotlib" not in text and "IPython" not in text and "plt." not in text
    assert ast.parse("\n".join(_source(c) for c in cells))


CHECKS = {
    "flow_matching_tutorial.ipynb": lambda ns: all(np.isfinite(w) for _, w in ns["paths"].values()),
    "SF2M_tutorial.ipynb": lambda ns: all(np.isfinite(x).all() for x, _ in ns["samples"].values()),
    "maximum_likelihood_CNF_tutorial.ipynb": lambda ns: bool(torch.isfinite(ns["logp"]).all()),
    "conditional_mnist.ipynb": lambda ns: (tuple(ns["out"].images.shape) == (80, 28, 28, 1)
                                           and os.path.exists(ns["path"])),
    "mnist_example.ipynb": lambda ns: tuple(ns["out"].images.shape) == (64, 28, 28, 1),
    "minibatch_OT_study.ipynb": lambda ns: ns["results"]["OT-CFM"] < ns["results"]["I-CFM"],
    "model_comparison_plotting.ipynb": lambda ns: len(ns["paths"]) == 5,
    "single_cell_example.ipynb": lambda ns: (len(ns["preds"]) == 4 and np.isfinite(ns["vals"]).all()
                                             and np.isfinite(ns["d_plan"])),
    "tabular_forest_flow.ipynb": lambda ns: np.isfinite(ns["w2"]),
}


@pytest.mark.parametrize("name", NAMES)
def test_notebook_runs_on_cpu(name, tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from threadpoolctl import threadpool_limits

    monkeypatch.chdir(tmp_path)
    params = dict(gn.SMOKE[name], DEVICE="cpu", RESULTS=str(tmp_path / "results"))
    try:
        with threadpool_limits(1):
            ns = gn.execute(os.path.join(gn.OUT, name), params, skip_tags=())
    finally:
        plt.close("all")
    assert ns["DEVICE"] == "cpu" and CHECKS[name](ns)


def test_notebooks_run_without_matplotlib_and_need_scikit_learn(monkeypatch):
    for mod in ("matplotlib", "matplotlib.pyplot", "IPython", "IPython.display"):
        monkeypatch.setitem(sys.modules, mod, None)
    path = os.path.join(gn.OUT, "SF2M_tutorial.ipynb")
    params = dict(gn.SMOKE["SF2M_tutorial.ipynb"], DEVICE="cpu")
    ns = gn.execute(path, params)
    assert set(ns["samples"]) == {"ODE", "SDE"}
    with pytest.raises(ImportError, match="matplotlib"):
        gn.execute(path, params, skip_tags=())
    for mod in ("sklearn", "sklearn.datasets", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError, match="sklearn"):
        gn.execute(os.path.join(gn.OUT, "tabular_forest_flow.ipynb"),
                   dict(gn.SMOKE["tabular_forest_flow.ipynb"], DEVICE="cpu"))
