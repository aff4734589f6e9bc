"""Profiling and timing helpers (counterpart of ``cfm_tpu/profiling.py``).

``trace`` records a ``torch.profiler`` trace of a block (the device's
kernels too when there is a card) into a directory; ``time_fn`` times a
call with CUDA events when its result lies on the card and with the host's
clock on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator, Optional

import torch


def _first_tensor(x: Any) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace") -> Iterator[torch.profiler.profile]:
    """``with trace("logs/trace"): step(...)`` writes the block's
    ``torch.profiler`` trace (host operators, and the card's kernels when
    CUDA is available) as ``<log_dir>/trace.pt.trace.json``, which Perfetto,
    ``chrome://tracing`` and TensorBoard's profile plugin read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.pt.trace.json"))


def hard_sync(x: Any) -> float:
    """Wait for ``x``'s first tensor by reading one element back to the host."""
    t = _first_tensor(x)
    if t is None:
        raise TypeError(f"hard_sync needs a tensor, got {type(x).__name__}")
    return float(t.reshape(-1)[0])


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            sync_overhead_s: float = 0.0) -> float:
    """Seconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup``: between CUDA events when the result lies on the card, by
    ``time.perf_counter`` around the calls and a ``hard_sync`` on the CPU,
    less ``sync_overhead_s``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    t = _first_tensor(out) if out is not None else _first_tensor(fn(*args))
    if t is not None and t.device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(t.device)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
        return max(start.elapsed_time(end) / 1e3 - sync_overhead_s, 0.0) / iters
    hard_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    hard_sync(out)
    return max(time.perf_counter() - t0 - sync_overhead_s, 0.0) / iters


def measure_sync_overhead(iters: int = 5, device: Optional[str] = None) -> float:
    """Seconds of one small op and its read back to the host on ``device``
    (default: the card when there is one, else the CPU)."""
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    x = torch.zeros((8, 128), device=device)
    hard_sync(x * 1.0)
    t0 = time.perf_counter()
    for _ in range(iters):
        hard_sync(x * 1.0)
    return (time.perf_counter() - t0) / iters
