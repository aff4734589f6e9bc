"""The span readers (``cfmbench/spans.py``) on synthetic events: device
operations placed by their launching call, idle gaps by their midpoint,
None where device time lacks its call, and the generation metrics over the
batches after the first."""

from __future__ import annotations

import pytest

from cfm_tpu_torch.profiling import Span
from cfmbench import spans as sp
from cfmbench.trace import Op

MAIN, AUTOGRAD = 1, 2


def _span(name, start, end, parent=-1, root=0, thread=MAIN):
    return Span(name, start, end, parent, root, thread, {})


def _call(name, start, corr, thread=MAIN):
    return Op(name, start, start + 2, corr, -1, thread, device=False, host=False, runtime=True)


def _kernel(start, end, corr):
    return Op("kernel", start, end, corr, -1, 0, device=True, host=False, runtime=False)


# One step: forward [10, 40], backward [40, 80] (its launches from the
# autograd thread), optimizer [80, 95] under the root [0, 100].
STEP = [_span("train.step", 0, 100), _span("train.forward", 10, 40, 0),
        _span("train.backward", 40, 80, 0), _span("train.optimizer", 80, 95, 0)]


def test_a_device_operation_is_placed_by_its_launching_call():
    ops = [_call("cudaLaunchKernel", 12, 1), _kernel(45, 60, 1),   # launched in forward
           _call("cuLaunchKernel", 50, 2, thread=AUTOGRAD), _kernel(60, 90, 2),
           _call("cudaMemsetAsync", 85, 3), _kernel(90, 100, 3),
           _call("cudaLaunchKernel", 97, 4), _kernel(100, 104, 4)]  # in the root's own time
    p = sp.place(ops, STEP)
    assert not p.partial and p.unlinked_s == 0.0
    assert p.by_name == pytest.approx({"train.forward": 15e-9, "train.backward": 30e-9,
                                       "train.optimizer": 10e-9, "train.step": 4e-9})
    ms = sp.train_span_ms(ops, STEP, steps=1)
    assert ms["span_forward_ms.train"] == pytest.approx(15e-6)
    assert ms["span_optimizer_ms.train"] == pytest.approx(10e-6)
    assert ms["span_exchange_ms.train"] == 0.0


def test_device_time_without_its_launching_call_reads_none():
    ops = [_call("cudaLaunchKernel", 12, 1), _kernel(45, 60, 1), _kernel(60, 90, 7)]
    assert sp.place(ops, STEP).partial
    assert set(sp.train_span_ms(ops, STEP, steps=1).values()) == {None}
    # A checkout whose program records no spans reads None too.
    assert set(sp.train_span_ms(ops[:2], [], steps=1).values()) == {None}


def test_an_idle_gap_is_placed_at_its_midpoint():
    # Busy [0, 20], [30, 70] (two overlapping kernels), [86, 100]: the gap
    # [20, 30] has its midpoint in forward, [70, 86] in backward; a malloc
    # at [74, 76] stalls the second.
    ops = [_kernel(0, 20, 1), _kernel(30, 50, 2), _kernel(40, 70, 3), _kernel(86, 100, 4),
           _call("cudaMalloc", 74, 9), _call("cudaStreamSynchronize", 5, 10)]
    rows = sp.idle_table(ops, STEP)
    assert [(r.span, r.gaps) for r in rows] == [("train.backward", 1), ("train.forward", 1)]
    assert rows[0].seconds == pytest.approx(16e-9) and rows[0].stalled_s == rows[0].seconds
    assert rows[1].stalled_s == 0.0
    gap_outside = sp.idle_table([_kernel(100, 110, 1), _kernel(130, 140, 2)], STEP)
    assert [(r.span, r.gaps) for r in gap_outside] == [(sp.OUTSIDE, 1)]
    assert "train.backward" in sp.format_idle_table(rows, 100e-9)


def _batches():
    """Three generated batches: each a root with two trials and their
    control spans (1, 2 and 3 ns of control)."""
    spans = []
    for b in range(3):
        t0, root = 100 * b, len(spans)
        spans.append(_span("gen.batch", t0, t0 + 90, root=root))
        spans.append(_span("ode.solve", t0 + 1, t0 + 80, root, root))
        for k in range(2):
            spans.append(_span("ode.trial", t0 + 10 + 30 * k, t0 + 20 + 30 * k, root + 1, root))
            spans.append(_span("ode.control", t0 + 20 + 30 * k, t0 + 21 + 30 * k + b, root + 1,
                               root))
    return spans


def test_generation_metrics_skip_the_first_batch():
    spans = _batches()
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    counters = {"ode.trial_steps": {r: 2 for r in roots},
                "ode.rejected_steps": {roots[0]: 2, roots[2]: 1}}
    assert sp.later_batches(spans) == roots[1:]
    assert sp.rejected_steps_per_batch(spans, counters) == 0.5
    assert sp.control_idle_ms_per_batch(spans) == pytest.approx((2 * 2 + 2 * 3) / 2 / 1e6)
    assert sp.rejected_steps_per_batch(spans, {}) == 0.0
    assert sp.rejected_steps_per_batch(spans[:6], counters) is None  # one batch only
    assert sp.control_idle_ms_per_batch([]) is None
