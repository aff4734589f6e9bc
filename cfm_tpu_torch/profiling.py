"""Spans, counters and profiler traces (counterpart of ``cfm_tpu/profiling.py``).

The train step and the ODE loop open a span at each layer boundary
(``train.step``, ``train.forward``, ``ode.trial``, ...) and count at the
same places (``ode.trial_steps``, ``ode.rejected_steps``). Spans are off
unless :func:`enable_spans` turns them on: then :func:`span` is one shared
no-op context and :func:`count` returns at once. When on, each span is kept
in memory, with its parent, its thread, its attributes and the ``root`` of
its tree (the outermost span: one train step, one generated batch), until
:func:`drain` hands them over; counts are kept by root.

Spans are stamped with ``time.time_ns()``, the wall clock that
``torch.profiler`` converts its host events to, so that a span and the
runtime calls (``cudaLaunchKernel``, memcpy, memset) of a profiler session
share one time base. While a profiler session is active, each span also
opens a ``record_function`` of its name, so the session's trace shows it.

``trace`` records a ``torch.profiler`` trace of a block (the device's
kernels too when there is a card) with the spans on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class Span:
    """One recorded span: its name, start and end (ns, ``time.time_ns``),
    the index of its parent in the drained list (-1 for a root), the index
    of its root, its thread and its attributes."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    thread: int
    attrs: Dict[str, Any]


_on = False
_lock = threading.Lock()
_spans: List[Span] = []
_counts: Dict[Tuple[str, int], int] = defaultdict(int)
_open = threading.local()  # .stack: the indices of this thread's open spans


class _NoSpan:
    """The context a span is while spans are off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (dropped: spans are off)."""


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("record", "range")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.record = Span(name, 0, 0, -1, -1, threading.get_ident(), attrs)
        self.range = None

    def __enter__(self) -> "_OpenSpan":
        rec = self.record
        stack = _stack()
        with _lock:
            index = len(_spans)
            _spans.append(rec)
        if stack:
            rec.parent = stack[-1]
            rec.root = _spans[rec.parent].root
        else:
            rec.root = index
        stack.append(index)
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(rec.name)
            self.range.__enter__()
        rec.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.record.end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (e.g. a trial step's
        ``accepted``)."""
        self.record.attrs.update(attrs)


def _stack() -> List[int]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def enable_spans(on: bool) -> bool:
    """Turn spans and counts on or off; returns the previous setting."""
    global _on
    was, _on = _on, bool(on)
    return was


def span(name: str, **attrs):
    """``with span("train.forward"):`` records the block as a span (when
    spans are on). ``with span(...) as s: s.set(key=value)`` adds
    attributes known only inside it."""
    if not _on:
        return _NO_SPAN
    return _OpenSpan(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span's root
    (root -1 outside spans), when spans are on."""
    if not _on:
        return
    stack = _stack()
    key = (name, _spans[stack[-1]].root if stack else -1)
    with _lock:
        _counts[key] += n


def drain() -> Tuple[List[Span], Dict[str, Dict[int, int]]]:
    """The spans recorded since the last drain, in the order they opened,
    and the counters, ``{name: {root: count}}``; both are then cleared.
    Drain between roots: a span still open on this thread raises."""
    global _spans, _counts
    if _stack():
        raise RuntimeError(f"drain() with {len(_stack())} span(s) open on this thread")
    with _lock:
        spans, counts = _spans, _counts
        _spans, _counts = [], defaultdict(int)
    counters: Dict[str, Dict[int, int]] = defaultdict(dict)
    for (name, root), n in counts.items():
        counters[name][root] = n
    return spans, dict(counters)


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace", name: str = "trace") -> Iterator[torch.profiler.profile]:
    """``with trace("logs/trace"): step(...)`` writes the block's
    ``torch.profiler`` trace (host operators, and the card's kernels when
    CUDA is available) as ``<log_dir>/<name>.pt.trace.json``, which
    Perfetto, ``chrome://tracing`` and TensorBoard's profile plugin read;
    also when the block raises. Spans are on for the block and show as
    ranges; what they record is dropped at its end unless spans were on
    already."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was = enable_spans(True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        enable_spans(was)
        if not was:
            drain()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))

