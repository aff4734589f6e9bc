"""The benchmark's command: one run of one cell.

    python3 -m cfmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run builds the program (``cfm_tpu_torch``) and the cell's inputs from the
seed, warms up the cell's shapes, measures for ``--seconds``, checks what
the measured path produced against the plain reference in
``cfmbench/reference/``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
also printed as the last lines of standard error.

It exits with another code than 0 and prints no result when the cell asks
for more CUDA devices than there are, and when a module of the JAX stack or
of the JAX package is loaded once the window has closed. A four-card cell
starts its other ranks itself, one process a card, joined by NCCL.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional, Sequence  # noqa: E402

from cfmbench import harness  # noqa: E402


def parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="cfmbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Run:
    """What a driver is handed: the cell, the seed and window, this rank,
    and the collectives and clocks the drivers share."""

    def __init__(self, cell, args, rank: int, world: int, device: str, fault: Optional[str],
                 start: float, marks: Optional[List] = None):
        import torch

        self.torch = torch
        self.cell, self.seed, self.seconds, self.trace = cell, args.seed, args.seconds, args.trace
        self.rank, self.world, self.fault, self.start = rank, world, fault, start
        self.cuda = device == "cuda"
        # A process group joins the ranks (a data-parallel cell has one, even alone).
        self.distributed = world > 1 or bool(cell.traffic.get("data_parallel"))
        self.device = torch.device("cuda", rank) if self.cuda else torch.device("cpu")
        self.setup_s = None
        self.marks = [] if marks is None else marks  # (phase, seconds since start)

    # Clocks and synchronisation.
    def mark(self, phase: str):
        """Note the end of a phase of set-up (printed when the window opens)."""
        self.marks.append((phase, time.perf_counter() - self.start))

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)
        if self.distributed:
            self.torch.distributed.barrier()

    def window_start(self) -> float:
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - self.start
        self.mark("window")
        print(f"set-up, rank {self.rank}, seconds at each phase's end: "
              + ", ".join(f"{p} {t:.2f}" for p, t in self.marks), file=sys.stderr)
        return now

    def event(self):
        if self.cuda:
            e = self.torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def event_times(self, events) -> List[float]:
        """ms between consecutive events, read after the window."""
        if self.cuda:
            events[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        return [1e3 * (b - a) for a, b in zip(events[:-1], events[1:])]

    def peak_bytes(self) -> int:
        return int(self.torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    # Collectives over the ranks (identity on one card).
    def agree(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        if not self.distributed:
            return value
        t = self.torch.tensor([value], dtype=self.torch.int64, device=self.device)
        self.torch.distributed.broadcast(t, 0)
        return int(t.item())

    def gather_max(self, values: List[float]) -> List[float]:
        """The element-wise largest over the ranks (the slowest rank)."""
        if not self.distributed:
            return values
        t = self.torch.tensor(values, dtype=self.torch.float64, device=self.device)
        self.torch.distributed.all_reduce(t, op=self.torch.distributed.ReduceOp.MAX)
        return t.tolist()

    def gather_peak(self, peak: int) -> int:
        return int(self.gather_max([float(peak)])[0])

    def gather_mean(self, value: float) -> float:
        if not self.distributed:
            return value
        t = self.torch.tensor([value], dtype=self.torch.float64, device=self.device)
        self.torch.distributed.all_reduce(t)
        return float(t.item()) / self.world

    def finish_ranks(self):
        """After the window: every rank leaves the process group; rank 0
        goes on to the reference alone."""
        if self.distributed:
            self.torch.distributed.barrier()
            self.torch.distributed.destroy_process_group()

    def tracer(self, model, n: int):
        """The traced run's profiler sessions over steps 3 .. 3 + 2n - 1."""
        if not self.trace:
            return None
        from cfmbench.trace import Tracer

        return Tracer(self.torch, model, first=3, n=n)

    def apply_fault(self, model):
        """Break the measured path on purpose (tests of the check only)."""
        if self.fault is not None:
            from cfmbench import faults

            faults.apply(self.fault, model, self.rank)


def rank_main(rank: int, world: int, argv: List[str], dirs: List[str], device: str,
              fault: Optional[str], init_method: Optional[str], start: float):
    """One rank's run; returns rank 0's outcome (the others return None)."""
    import torch

    marks = [("imports", time.perf_counter() - start)]
    if world > 1 and device == "cuda":  # the ranks share the host's cores, not each all of them
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    args = parse(argv)
    cell = harness.load_cell(args.workload, [Path(d) for d in dirs])
    if world > 1 or cell.traffic.get("data_parallel"):
        if device == "cuda":
            torch.cuda.set_device(rank)
        if init_method is None:
            init_method = f"tcp://localhost:{_free_port()}"
        torch.distributed.init_process_group(
            "nccl" if device == "cuda" else "gloo", init_method=init_method,
            world_size=world, rank=rank,
            device_id=torch.device("cuda", rank) if device == "cuda" else None)
        marks.append(("process group", time.perf_counter() - start))
    else:
        if device == "cuda":
            torch.cuda.set_device(0)
    torch.manual_seed(harness.derive_seed(args.seed, 0, rank))
    run = Run(cell, args, rank, world, device, fault, start, marks)
    driver = harness.load_driver(cell.driver, [Path(d) for d in dirs])
    out = driver.drive(run)
    out.update(setup_s=run.setup_s, cell=cell, cuda=run.cuda, world=world)
    return out if rank == 0 else None


def _spawned(rank, world, argv, dirs, device, fault, init_method, start):
    """Rank ``rank`` > 0 in a process of its own; it exits with 3, and rank
    0 then prints no result, where it holds a forbidden module. ``start`` is
    rank 0's start on the machine's monotonic clock, which every process
    shares, so that each rank's set-up phases read against it."""
    rank_main(rank, world, argv, dirs, device, fault, init_method, start)
    if _holds_forbidden(f"rank {rank}"):
        sys.exit(3)


def _holds_forbidden(where: str) -> bool:
    """Whether this process holds a forbidden module (named on stderr)."""
    found = harness.forbidden_modules()
    if found:
        print(f"cfmbench: modules of the JAX stack or package are loaded on {where}: {found}",
              file=sys.stderr)
    return bool(found)


def main(argv: Optional[Sequence[str]] = None, dirs: Sequence[str] = (),
         device: Optional[str] = None, fault: Optional[str] = None) -> int:
    """The run; ``device`` "cpu" (tests) skips the look for a card."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload, [Path(d) for d in dirs])
    world = cell.chips
    procs = []
    init_method = None
    if world > 1:
        # The other ranks start before this process imports torch, so that
        # their imports and start-up overlap its own.
        import multiprocessing as mp

        init_method = f"tcp://localhost:{_free_port()}"
        ctx = mp.get_context("spawn")
        target = importlib.import_module("cfmbench.run")._spawned
        procs = [ctx.Process(target=target, args=(r, world, argv, list(dirs), device or "cuda",
                                                  fault, init_method, PROCESS_START))
                 for r in range(1, world)]
        for p in procs:
            p.start()
    try:
        import torch

        if device is None:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if have < cell.chips:
                print(f"cfmbench: {args.workload} needs {cell.chips} CUDA device(s); "
                      f"this machine has {have}", file=sys.stderr)
                for p in procs:
                    p.terminate()
                return 2
            device = "cuda"
        out = rank_main(0, world, argv, list(dirs), device, fault, init_method, PROCESS_START)
    except BaseException:
        for p in procs:  # ranks waiting in a collective would never end
            p.terminate()
        raise
    finally:
        for p in procs:
            p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        print(f"cfmbench: a rank exited with {bad}", file=sys.stderr)
        return 1
    if _holds_forbidden("rank 0"):
        return 3
    result = assemble(cell, args, out, torch, world)
    data = out.get("trace")
    if data is not None:
        print(f"trace: {data.steps} steps traced on the card over {data.window_s:.4f} s, busy "
              f"{data.busy_s:.4f} s; {data.host_steps} with the host: device time placed "
              f"{data.linked_device_s:.4f} s, not placed {data.unlinked_s:.4f} s; calls hooked "
              f"{len(data.calls)}, with device time {len(data.call_device_s)}", file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def assemble(cell, args, out, torch, world) -> dict:
    """The result line from the driver's outcome and BENCHMARK.json."""
    listed = harness.benchmark_metrics(cell.name)
    units = harness.benchmark_units()
    metrics = {}
    if not args.trace:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        wanted = [m["name"] for m in listed["end_to_end"]] if listed else list(values)
        for name in wanted:
            metrics[name] = {"value": values[name], "unit": units[name]}
    else:
        data = out["trace"]
        if listed:
            wanted = [m["name"] for m in listed["per_layer"]]
        else:  # every reader of the driver's kind
            kind = ".train" if cell.driver == "train" else ".gen"
            wanted = [p.stem for p in sorted((harness.HERE / "metrics").glob("*.py"))
                      if p.stem.endswith(kind)]
        for name in wanted:
            reader = harness.metric_reader(name)
            value = None if reader is None else reader.read(data, out)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    device = harness.device_record(torch, world, out["peak_bytes"])
    # A failed step or batch in the window fails the run, whatever the checks read.
    correct = out["failed"] == 0 and all(c.ok for c in out["checks"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace and out["trace"] is not None:
        device["busy_s"] = out.get("busy_s", out["trace"].busy_s)
        device["window_s"] = out.get("trace_window_s", out["trace"].window_s)
        result["breakdown"] = {"device_ops": [[n, s] for n, s in out["trace"].top_ops],
                               "idle_gaps": [[n, s] for n, s in out["trace"].idle_gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out["checks"]}
    return result


if __name__ == "__main__":
    sys.exit(main())
