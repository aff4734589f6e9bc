#!/usr/bin/env python3
"""One run of a benchmark cell (``cfmbench.run``) with the program's spans
(``cfm_tpu_torch.profiling``) on from the window's start, and what they say:

    python3 probes/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run prints its own result line as ``python3 -m cfmbench.run`` does. With
``--trace 0`` that line is what the spans cost, against a run of the
benchmark's own command with the same arguments (spans off). With
``--trace 1`` the card-only session's operations are kept as well, and a
line ``{"spans": {...}}`` follows on standard output: the train cell's five
``span_*_ms.train`` (device ms a traced step, by the span that launched
each operation) beside the session's device ms a step, or the generation
cell's ``rejected_steps_per_batch.gen`` and ``control_idle_ms_per_batch.gen``
(over the batches after the first), each with the consistency checks
against the result line's metrics; the session's runtime calls; and the
clock check. The idle table goes to standard error (``cfmbench/spans.py``).

The clock check (with a card) opens spans around a small kernel's launch in
a profiler session with host operators, each with a ``record_function``
opened right after it, and in a card-only session: the largest distance
between a span's start and its range's, and how many launching calls fall
inside their span.

Spans are on in rank 0's process only: the other ranks of a four-card cell
start from a fresh import.
"""

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cfm_tpu_torch import profiling  # noqa: E402
from cfmbench import run as bench_run  # noqa: E402
from cfmbench import spans as bench_spans  # noqa: E402
from cfmbench import trace as bench_trace  # noqa: E402


def _instrument(kept):
    """Spans on at the window's start; the card-only session's operations
    and traced steps into ``kept``."""
    window_start = bench_run.Run.window_start
    from_device = bench_trace.TraceData.from_device.__func__

    def start(self):
        now = window_start(self)
        profiling.enable_spans(True)
        return now

    def keep(cls, ops, steps):
        kept["ops"], kept["steps"] = ops, steps
        return from_device(cls, ops, steps)

    bench_run.Run.window_start = start
    bench_trace.TraceData.from_device = classmethod(keep)


def clock_check(n: int = 50) -> dict:
    """Spans against the profiler's clock on the card (see the module's
    docstring); distances in ns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    out = {}
    for key, acts in (("host", [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                      ("card_only", [ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        was = profiling.enable_spans(True)
        with profile(activities=acts) as prof:
            for i in range(n):
                with profiling.span(f"probe.span/{i}"):
                    with torch.autograd.profiler.record_function(f"probe.after/{i}"):
                        x.add_(1)
            torch.cuda.synchronize()
        profiling.enable_spans(was)
        spans, _ = profiling.drain()
        events = list(prof.profiler.kineto_results.events())
        after = {e.name(): e.start_ns() for e in events if e.name().startswith("probe.after/")}
        calls = sorted(e.start_ns() for e in events
                       if bench_trace._RUNTIME.match(e.name())
                       and any(k in e.name() for k in bench_spans.LAUNCH_KEYS))
        inside = sum(any(s.start_ns <= c <= s.end_ns for s in spans) for c in calls)
        out[key] = {
            "ranges": len(after), "launch_calls": len(calls), "launch_calls_in_spans": inside,
            "max_abs_range_minus_span_start_ns": max(
                (abs(after[f"probe.after/{i}"] - s.start_ns) for i, s in enumerate(spans)
                 if f"probe.after/{i}" in after), default=None)}
    return out


def summarize(result: dict, kept: dict, spans, counters, driver: str) -> dict:
    """The spans' metrics and their checks against the result line."""
    ops, steps = kept.get("ops", []), kept.get("steps", 0)
    metrics = {k: v["value"] for k, v in result.get("metrics", {}).items()}
    runtime = [o for o in ops if o.runtime]
    device_s = sum((o.end - o.start) * 1e-9 for o in ops if o.device)
    place = bench_spans.place(ops, spans)
    out = {"traced_steps": steps, "runtime_calls": len(runtime),
           "device_ms_per_step": 1e3 * device_s / steps if steps else None,
           "placed_ms_by_span": {k: 1e3 * v / max(steps, 1) for k, v in place.by_name.items()},
           "unlinked_ms": 1e3 * place.unlinked_s, "roots": sum(s.parent < 0 for s in spans)}
    if driver == "train":
        ms = bench_spans.train_span_ms(ops, spans, steps)
        out.update(ms)
        if None not in ms.values() and out["device_ms_per_step"]:
            out["five_over_device_pct"] = 100.0 * sum(ms.values()) / out["device_ms_per_step"]
            for mine, theirs in (("span_exchange_ms.train", "allreduce_ms.train"),
                                 ("span_optimizer_ms.train", "optim_ms.train"),
                                 ("span_coupling_ms.train", "coupling_ms.train")):
                if theirs in metrics:
                    out[f"{mine} >= {theirs}"] = ms[mine] >= metrics[theirs]
    else:
        rejected = bench_spans.rejected_steps_per_batch(spans, counters)
        out["rejected_steps_per_batch.gen"] = rejected
        out["control_idle_ms_per_batch.gen"] = bench_spans.control_idle_ms_per_batch(spans)
        later = bench_spans.later_batches(spans)
        trials = counters.get("ode.trial_steps", {})
        out["trial_steps_per_batch"] = (sum(trials.get(r, 0) for r in later) / len(later)
                                        if later else None)
        if rejected is not None and "nfe_per_batch.gen" in metrics:
            out["accepted_steps_per_batch"] = (metrics["nfe_per_batch.gen"] - 2) / 6 - rejected
    return out


def main(argv):
    import torch

    kept = {}
    _instrument(kept)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(argv)
    profiling.enable_spans(False)
    spans, counters = profiling.drain()
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        return rc
    args = bench_run.parse(argv)
    if not args.trace:
        return 0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    driver = "train" if any(s.name == "train.step" for s in spans) else "generate"
    out = summarize(result, kept, spans, counters, driver)
    if kept.get("ops"):
        window = bench_trace._union([(o.start, o.end) for o in kept["ops"] if o.device])
        window_s = (window[-1][1] - window[0][0]) * 1e-9 if window else 0.0
        print(bench_spans.format_idle_table(bench_spans.idle_table(kept["ops"], spans), window_s),
              file=sys.stderr)
    if torch.cuda.is_available():
        out["clock"] = clock_check()
    print(json.dumps({"spans": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
