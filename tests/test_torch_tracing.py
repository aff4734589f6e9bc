"""The port's spans and counters (cfm_tpu_torch/profiling.py) on the CPU.

- With spans off nothing is recorded: ``span`` is one shared no-op context.
- A coupled class-conditional train step on a tiny UNet and ``generate``
  with dopri5 give bit-equal outputs with spans on and off.
- The one-process step's span tree: one ``train.step`` root a step holding
  ``train.coupling``, ``train.forward``, ``train.backward``,
  ``train.optimizer`` and ``train.ema``; a generated batch's: ``gen.batch``
  holding ``ode.solve`` (trials, reads, control) and ``gen.check``.
- On a field that forces rejections, dopri5 and tsit5 count rejected trial
  steps, and dopri5's trial steps are (NFE - 2) / 6.
- A span's start is on the profiler's clock, and ``trace`` shows the spans
  as ranges in its Chrome trace.

The two-rank data-parallel step's spans are checked in
``test_torch_parallel.py``, whose ranks record them.
"""

import json

import numpy as np
import pytest
import torch

from cfm_tpu_torch import profiling
from cfm_tpu_torch import train as ttr
from cfm_tpu_torch.generate import generate
from cfm_tpu_torch.integrate import odeint
from cfm_tpu_torch.models.mlp import MLP
from cfm_tpu_torch.models.unet import UNetModelWrapper
from cfm_tpu_torch.paths import ExactOptimalTransportConditionalFlowMatcher

TINY = dict(dim=(16, 16, 3), num_channels=16, num_res_blocks=1, channel_mult=(1, 2),
            num_heads=2, num_head_channels=8, attention_resolutions="8", class_cond=True,
            num_classes=4)
STEP_CHILDREN = ["train.coupling", "train.forward", "train.backward", "train.optimizer",
                 "train.ema"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU work, as the other port files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _spans_off():
    """Each test starts and ends with spans off and nothing recorded."""
    profiling.enable_spans(False)
    profiling.drain()
    yield
    profiling.enable_spans(False)
    profiling.drain()


def _recorded(fn):
    """``fn()``'s result, spans and counters, with spans on for the call."""
    profiling.enable_spans(True)
    try:
        out = fn()
    finally:
        profiling.enable_spans(False)
    spans, counters = profiling.drain()
    return out, spans, counters


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def _model():
    model = UNetModelWrapper(**TINY, device="cpu", seed=2)
    with torch.no_grad():  # a field that moves the noise (the output layer starts at 0)
        g = torch.Generator().manual_seed(9)
        for p in model.parameters():
            if not p.abs().max() > 0:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return model


def _train_steps(steps=2):
    """Two coupled class-conditional steps from fixed draws: the metrics,
    parameters and EMA after each."""
    rng = np.random.default_rng(4)
    model = _model()
    opt = ttr.make_optimizer(lr=1e-3, warmup_steps=2)
    state = ttr.init_train_state(model, opt)
    step = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(), model, opt,
                               class_conditional=True)
    out = []
    for _ in range(steps):
        x0, x1, eps = (torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
                       for _ in range(3))
        y = torch.from_numpy(rng.integers(0, 4, 4))
        draws = ttr.StepDraws(torch.from_numpy(rng.random(4).astype(np.float32)), eps,
                              torch.from_numpy(rng.random(4).astype(np.float32)))
        metrics = step(state, x0, x1, y, y, draws=draws)
        out.append(({k: v.clone() for k, v in metrics.items()},
                    [p.detach().clone() for p in state.params],
                    [e.clone() for e in state.ema_params]))
    return out


def _generate():
    x0 = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 16, 3))
                          .astype(np.float32))
    return generate(_model(), 2, x_shape=(16, 16, 3), method="dopri5", x0=x0,
                    y=torch.tensor([1, 3]), device="cpu")


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_spans_off_record_nothing():
    first = profiling.span("train.step", step=0)
    with first as s:
        s.set(accepted=True)
        profiling.count("ode.trial_steps")
        with profiling.span("train.forward") as inner:
            assert inner is first
    assert profiling.span("ode.read") is first
    odeint(lambda t, x: -x, torch.ones(3), [0.0, 1.0], method="dopri5")
    assert profiling.drain() == ([], {})


def test_train_step_is_bit_equal_with_spans_and_has_their_tree():
    off = _train_steps()
    on, spans, counters = _recorded(_train_steps)
    assert _equal(off, on)
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["train.step"] * 2
    assert [spans[i].attrs["step"] for i in roots] == [0, 1]
    for r in roots:
        assert _children(spans, r) == STEP_CHILDREN
    assert all(s.root in roots and s.start_ns <= s.end_ns for s in spans)
    assert len(spans) == 2 * (1 + len(STEP_CHILDREN))  # nothing below the layers
    assert counters == {}


def test_generate_is_bit_equal_with_spans_and_has_their_tree():
    off = _generate()
    on, spans, counters = _recorded(_generate)
    assert _equal(tuple(off), tuple(on))
    (root,) = [i for i, s in enumerate(spans) if s.parent < 0]
    assert spans[root].name == "gen.batch"
    assert _children(spans, root) == ["ode.solve", "gen.check"]
    solve = spans.index(next(s for s in spans if s.name == "ode.solve"))
    below = _children(spans, solve)
    # The initial step's three reads, then a trial and its control each step.
    assert below[:3] == ["ode.read"] * 3
    assert below[3:] == ["ode.trial", "ode.control"] * ((len(below) - 3) // 2)
    trials = [i for i, s in enumerate(spans) if s.name == "ode.trial"]
    assert all(_children(spans, i) == ["ode.read"] for i in trials)
    assert len(trials) == (on.nfe - 2) // 6 > 1
    assert counters["ode.trial_steps"] == {root: len(trials)}
    rejected = sum(not spans[i].attrs["accepted"] for i in trials)
    assert counters.get("ode.rejected_steps", {}).get(root, 0) == rejected


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_rejected_steps_are_counted(method):
    """A fast decay (rate 200 over [0, 1]) makes the controller reject steps."""
    sol, spans, counters = _recorded(lambda: odeint(
        lambda t, x: -200.0 * x, torch.ones(4, 3), [0.0, 1.0], method=method,
        return_trajectory=False))
    trials = counters["ode.trial_steps"][0]
    rejected = counters["ode.rejected_steps"][0]
    assert rejected > 0 and trials > rejected
    assert trials == (sol.nfe - 2) / 6
    assert sum(s.name == "ode.trial" and not s.attrs["accepted"] for s in spans) == rejected
    assert spans[0].name == "ode.solve" and spans[0].attrs == {"method": method}


def test_span_is_on_the_profilers_clock():
    """A span's start is within 1 ms of a ``record_function`` opened right
    after it, in one CPU profiler session."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with profiling.span("probe.span"):
                with torch.autograd.profiler.record_function(f"probe.after/{i}"):
                    torch.ones(8).add_(1)
    profiling.enable_spans(False)
    spans, _ = profiling.drain()
    after = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("probe.after/")}
    assert len(spans) == len(after) == 20
    gaps = [after[f"probe.after/{i}"] - s.start_ns for i, s in enumerate(spans)]
    assert max(abs(g) for g in gaps) < 1_000_000, gaps


def test_trace_shows_the_spans_as_ranges(tmp_path):
    rng = np.random.default_rng(1)
    model = MLP(2, w=16, device="cpu")
    opt = ttr.make_optimizer(lr=1e-3, warmup_steps=2)
    state = ttr.init_train_state(model, opt)
    step = ttr.make_train_step(ExactOptimalTransportConditionalFlowMatcher(), model, opt)
    x0, x1 = (torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32)) for _ in range(2))
    with profiling.trace(str(tmp_path), "step"):
        step(state, x0, x1, generator=torch.Generator().manual_seed(0))
    events = json.load(open(tmp_path / "step.pt.trace.json"))["traceEvents"]
    ranges = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"train.step"} | set(STEP_CHILDREN) <= ranges
    assert profiling.drain() == ([], {})  # the trace's own spans are dropped
