"""The bodies that per-layer metric readers share. Each reader,
``metrics/<name>.py``, defines ``read(trace, outcome) -> value or None``,
often as one of these bound to its kernel group; ``None`` leaves the metric
out of the line. Units come from ``BENCHMARK.json``."""

from __future__ import annotations

import functools

from cfmbench import harness
from cfmbench.flops import model_flops_per_image


def per_step_ms(group: str):
    """Device ms a traced step of ``kernels/<group>.json``'s kernels."""
    def read(trace, outcome):
        return None if trace is None else trace.per_step_ms(group)

    return read


def roofline(group: str, backward: bool):
    """The calls' bound over the device time attributed to them, in %
    (``cfmbench/trace.py``; silent where the attribution is partial)."""
    def read(trace, outcome):
        return None if trace is None else trace.roofline_pct(group, backward=backward)

    return read


def device_idle_pct(trace, outcome):
    """1 - the union of the card's operations over the traced window, in %."""
    if trace is None or trace.window_s <= 0 or not outcome.get("cuda"):
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def peak_mem_gib(trace, outcome):
    """The allocator's peak over the window (``max_memory_allocated``), GiB."""
    if not outcome.get("cuda"):
        return None
    return outcome["window_peak_bytes"] / 2 ** 30


def mfu_pct(trace, outcome, backward: bool):
    """The traced run's model FLOP/s over the bf16 peak (989 TFLOP/s a card),
    in %: the plain reference's FLOPs an image (``cfmbench/flops.py``;
    forward, or forward and backward), times the NFE a batch where the cell
    generates, times the images a second over the whole window."""
    if trace is None or not outcome.get("cuda"):
        return None
    cell = outcome["cell"]
    flops = model_flops_per_image(cell.config["model"], cell.traffic["batch"], backward=backward)
    flops *= outcome.get("nfe_per_batch", 1)
    return 100.0 * flops * outcome["images_per_s"] / (harness.PEAK_BF16_FLOPS * outcome["world"])


mfu_train = functools.partial(mfu_pct, backward=True)
mfu_gen = functools.partial(mfu_pct, backward=False)
