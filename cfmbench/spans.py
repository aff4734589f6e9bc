"""The program's spans and counters (``cfm_tpu_torch.profiling``) read
against the card-only session of a traced run.

The program stamps its spans with ``time.time_ns()``, the clock that the
profiler converts its host events to, so a device operation is placed by
the runtime call that launched it (the same correlation id): in the
innermost span open at the call's start, on any thread (the autograd
engine launches the backward from a thread of its own). An idle gap of the
card is placed at its midpoint, in the innermost span open on the host
then.

The functions take what the readers are handed: ``ops``, the session's
events (:class:`cfmbench.trace.Op`), and ``spans`` and ``counters`` as
``profiling.drain()`` gives them. Where the program records no spans (a
checkout that predates them), every reading is None.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from cfmbench.trace import SYNC_NAMES, _union

OUTSIDE = "(outside spans)"
# The runtime calls that launch work on the card, as ``TraceData.add_host``
# finds them.
LAUNCH_KEYS = ("Launch", "Memcpy", "Memset")
# Runtime calls that stall the host or the card's queue: an idle gap that
# overlaps one is flagged (the allocator's calls by prefix, the
# synchronisations by name).
ALLOC_PREFIXES = ("cudaMalloc", "cudaFree")
# The train metrics' spans: each names the spans whose device time it sums.
TRAIN_SPANS = {
    "span_forward_ms.train": ("train.forward",),
    "span_backward_ms.train": ("train.backward",),
    "span_exchange_ms.train": ("train.allreduce",),
    "span_optimizer_ms.train": ("train.optimizer", "train.ema"),
    "span_coupling_ms.train": ("train.coupling",),
}


class _Index:
    """The innermost span holding a time, over every thread's spans (each
    thread's spans nest, and open in the order of their starts)."""

    def __init__(self, spans: Sequence):
        self.spans = spans
        self.by_thread: Dict[int, Tuple[List[int], List[int]]] = {}
        for i, s in enumerate(spans):
            starts, idx = self.by_thread.setdefault(s.thread, ([], []))
            starts.append(s.start_ns)
            idx.append(i)

    def innermost(self, t: int) -> Optional[int]:
        best = None
        for starts, idx in self.by_thread.values():
            k = bisect.bisect_right(starts, t) - 1
            # The innermost span holding t is the last one opened before t
            # or one of its ancestors.
            i = idx[k] if k >= 0 else -1
            while i >= 0 and self.spans[i].end_ns < t:
                i = self.spans[i].parent
            if i >= 0 and (best is None or self.spans[i].start_ns > self.spans[best].start_ns):
                best = i
        return best


@dataclasses.dataclass
class Placement:
    """Device seconds of the session by the name of the span that launched
    them (``OUTSIDE`` for none), and the device seconds whose launching call
    was or was not found."""

    by_name: Dict[str, float]
    linked_s: float
    unlinked_s: float

    @property
    def partial(self) -> bool:
        """Device time without its launching call over a thousandth of the
        placed time: readings would be partial (``roofline_pct``'s rule)."""
        return self.unlinked_s > 0.001 * max(self.linked_s, 1e-12)


def place(ops: Sequence, spans: Sequence) -> Placement:
    """Each device operation of ``ops`` in the innermost span open at its
    launching call's start."""
    launches = {o.corr: o for o in ops if o.runtime and any(k in o.name for k in LAUNCH_KEYS)}
    index = _Index(spans)
    by_name: Dict[str, float] = defaultdict(float)
    linked = unlinked = 0.0
    for o in ops:
        if not o.device:
            continue
        dur = (o.end - o.start) * 1e-9
        call = launches.get(o.corr)
        if call is None:
            unlinked += dur
            continue
        linked += dur
        i = index.innermost(call.start)
        by_name[OUTSIDE if i is None else spans[i].name] += dur
    return Placement(dict(by_name), linked, unlinked)


def train_span_ms(ops: Sequence, spans: Sequence, steps: int) -> Dict[str, Optional[float]]:
    """The five ``span_*_ms.train`` metrics: device ms a traced step placed
    in their spans; None where no step was traced, the program recorded no
    spans, or the placement is partial."""
    p = place(ops, spans)
    if not steps or not spans or p.partial:
        return {name: None for name in TRAIN_SPANS}
    return {name: 1e3 * sum(p.by_name.get(n, 0.0) for n in names) / steps
            for name, names in TRAIN_SPANS.items()}


def later_batches(spans: Sequence) -> List[int]:
    """The roots of the generated batches after the first (the traced
    sessions run inside the first)."""
    return [i for i, s in enumerate(spans) if s.parent < 0 and s.name == "gen.batch"][1:]


def rejected_steps_per_batch(spans: Sequence, counters: Dict[str, Dict[int, int]]
                             ) -> Optional[float]:
    """dopri5's rejected trial steps a batch, over the batches after the first."""
    roots = later_batches(spans)
    if not roots:
        return None
    rejected = counters.get("ode.rejected_steps", {})
    return sum(rejected.get(r, 0) for r in roots) / len(roots)


def control_idle_ms_per_batch(spans: Sequence) -> Optional[float]:
    """Host ms a batch in ``ode.control`` (step control after a trial's
    blocking read, while the card waits), over the batches after the first."""
    roots = later_batches(spans)
    if not roots:
        return None
    kept = set(roots)
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "ode.control" and s.root in kept)
    return ns / 1e6 / len(roots)


@dataclasses.dataclass
class IdleRow:
    """The card's idle gaps placed in one span: their seconds and count,
    and the seconds of those that overlap a stalling runtime call."""

    span: str
    seconds: float
    gaps: int
    stalled_s: float


def idle_table(ops: Sequence, spans: Sequence) -> List[IdleRow]:
    """The session's idle gaps (between the union of its device
    operations), each put down to the innermost span open on the host at
    the gap's midpoint, largest first."""
    busy = _union([(o.start, o.end) for o in ops if o.device])
    stalls = [(o.start, o.end) for o in ops if o.runtime and (
        o.name in SYNC_NAMES or o.name.startswith(ALLOC_PREFIXES))]
    index = _Index(spans)
    rows: Dict[str, IdleRow] = {}
    for (_, gap_start), (gap_end, _) in zip(busy[:-1], busy[1:]):
        i = index.innermost((gap_start + gap_end) // 2)
        name = OUTSIDE if i is None else spans[i].name
        row = rows.setdefault(name, IdleRow(name, 0.0, 0, 0.0))
        dur = (gap_end - gap_start) * 1e-9
        row.seconds += dur
        row.gaps += 1
        if any(s <= gap_end and e >= gap_start for s, e in stalls):
            row.stalled_s += dur
    return sorted(rows.values(), key=lambda r: -r.seconds)


def format_idle_table(rows: List[IdleRow], window_s: float) -> str:
    """The idle table as lines of text (``window_s``: the session's span)."""
    total = sum(r.seconds for r in rows)
    lines = [f"idle table: {total * 1e3:.3f} ms idle of {window_s * 1e3:.3f} ms "
             f"({100.0 * total / max(window_s, 1e-12):.2f}%), by the span open at each gap's "
             "midpoint"]
    for r in rows:
        lines.append(f"  {r.span:<20} {r.seconds * 1e3:10.3f} ms  {r.gaps:6d} gaps  "
                     f"{100.0 * r.seconds / max(total, 1e-12):6.2f}%  overlapping a "
                     f"malloc, free or sync: {r.stalled_s * 1e3:.3f} ms")
    return "\n".join(lines)
