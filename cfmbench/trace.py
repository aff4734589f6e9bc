"""The traced stretch of a ``--trace 1`` run and its reduction.

A traced run profiles, inside its measured window, two short sessions one
after the other:

1. the card's operations alone (``torch.profiler`` with CUDA activity and no
   host operators, so the tracer adds almost no host time): the card's busy
   time over the session, the device time of each kernel group
   (``kernels/*.json``) a step, the largest groups and the longest idle gaps;
2. host operators too, while forward hooks of the benchmark's own open a
   ``record_function`` range around each call of the model's attention
   blocks and of its GroupNorms outside them. Each range notes the call's
   shape and the autograd sequence numbers of the nodes the call created;
   the backward's operators (``autograd::engine::evaluate_function: ...``)
   carry their node's number. Each operation on the card has the runtime
   call that launched it (the same correlation id), and that call's time and
   thread place it inside a range or a backward node, and so in a call. This
   session's host time is slow (the tracer records every operator), so only
   device times and counts are read from it: the calls' device time, for the
   rooflines, and the host synchronisations a step.

Each session ends with ``torch.autograd._disable_profiler()``, which hands
back the raw events without parsing them; they are reduced once the window
has closed. :class:`TraceData` is what the readers in ``metrics/`` read.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from cfmbench import harness

STEP = "cfmbench.step"
# Host calls that wait for the card: the synchronisations and a blocking copy.
SYNC_NAMES = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
# The profiler's activity types of work on the card (not its annotations).
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME = re.compile(r"^(cuda[A-Z]|cu[A-Z])")


@dataclasses.dataclass
class Call:
    """One hooked call: its kind ("attention" or "groupnorm"), the numbers
    its bound is computed from, and the autograd sequence numbers of the
    nodes it created, ``(lo, hi]`` (empty without autograd)."""

    kind: str
    shape: Dict[str, int]
    seq_lo: int = -1
    seq_hi: int = -1


class _Hooks:
    """Forward pre- and post-hooks on the model's attention blocks and on
    its GroupNorms outside them; a range ``cfmbench.<kind>/<i>`` each call."""

    def __init__(self, torch, model):
        self.torch, self.calls, self.handles, self.open = torch, [], [], []
        self.probe = torch.zeros((), requires_grad=True)
        for name, module in model.named_modules():
            kind = _kind_of(name, module, model)
            if kind is not None:
                self.handles.append(module.register_forward_pre_hook(self._pre(kind)))
                self.handles.append(module.register_forward_hook(self._post))

    def _seq(self) -> int:
        """The next autograd sequence number (a node made on the host)."""
        if not self.torch.is_grad_enabled():
            return -1
        return (self.probe * 1.0).grad_fn._sequence_nr()

    def _pre(self, kind):
        def hook(mod, args):
            call = Call(kind, _shape(kind, mod, args[0]), seq_lo=self._seq())
            self.calls.append(call)
            rf = self.torch.autograd.profiler.record_function(
                f"cfmbench.{kind}/{len(self.calls) - 1}")
            rf.__enter__()
            self.open.append((call, rf))
        return hook

    def _post(self, mod, args, out):
        call, rf = self.open.pop()
        rf.__exit__(None, None, None)
        fn = getattr(out, "grad_fn", None)
        call.seq_hi = fn._sequence_nr() if fn is not None and call.seq_lo >= 0 else -1

    def remove(self):
        for h in self.handles:
            h.remove()


def _kind_of(name: str, module, model) -> Optional[str]:
    cls = type(module).__name__
    if cls == "AttentionBlock":
        return "attention"
    if cls == "GroupNorm32":
        parent = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        return None if type(parent).__name__ == "AttentionBlock" else "groupnorm"
    return None


def _shape(kind: str, module, x) -> Dict[str, int]:
    if kind == "attention":
        n, h, w, c = x.shape
        return dict(N=n, S=h * w, C=c, H=module.heads, itemsize=x.element_size())
    hw = 1
    for d in x.shape[1:-1]:
        hw *= d
    return dict(N=x.shape[0], HW=hw, C=x.shape[-1], itemsize=x.element_size())


@dataclasses.dataclass
class Op:
    name: str
    start: int      # ns
    end: int        # ns
    corr: int       # a host operator's id; a runtime call's and its device operation's
    seq: int
    thread: int
    device: bool    # an operation on the card
    host: bool      # a host operator or range
    runtime: bool   # a call of the CUDA runtime or driver


class Tracer:
    """Two sessions in a traced run, driven by ``advance(i)`` before each
    step (or evaluation) i of the window: the card's alone over steps
    ``first`` .. ``first + n - 1``, then with the host over the next ``n``
    (each inside ``step()``). ``finish(i)`` after the last step closes a
    session left open; ``reduce()`` after the window."""

    def __init__(self, torch, model=None, first: int = 3, n: int = 2):
        self.torch, self.model, self.first, self.n = torch, model, first, n
        self._hooks, self._raw, self._open = None, {}, None
        self.steps = {"device": 0, "host": 0}
        for host in (False, True):  # the profiler's first start costs seconds
            self._start(host)
            torch.zeros(8, device=self._dev()).add_(1)
            self._stop("warm")

    def _dev(self) -> str:
        return "cuda" if self.torch.cuda.is_available() else "cpu"

    def _start(self, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if host or not self.torch.cuda.is_available() else []
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            self.torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.start()

    def _stop(self, key: str):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._raw[key] = self.torch.autograd._disable_profiler()
        self._prof = None

    def advance(self, i: int):
        first, n = self.first, self.n
        if i == first:
            self._start(host=False)
            self._open = ("device", i)
        elif i == first + n:
            self.finish(i)
            self._start(host=True)
            if self.model is not None:
                self._hooks = _Hooks(self.torch, self.model)
            self._open = ("host", i)
        elif i == first + 2 * n:
            self.finish(i)

    def step(self, i: int):
        """The range around step ``i`` (a host session's step)."""
        import contextlib

        if self._open is not None and self._open[0] == "host":
            return self.torch.autograd.profiler.record_function(STEP)
        return contextlib.nullcontext()

    def finish(self, i: int):
        if self._open is None:
            return
        key, since = self._open
        if key == "host" and self._hooks is not None:
            self._hooks.remove()
        self._stop(key)
        self.steps[key] = i - since
        self._open = None

    def reduce(self) -> Optional["TraceData"]:
        if "device" not in self._raw:
            return None
        data = TraceData.from_device(_ops(self._raw["device"]), self.steps["device"])
        if "host" in self._raw:
            data.add_host(_ops(self._raw["host"]), self._hooks.calls if self._hooks else [],
                          self.steps["host"])
        return data


def _ops(result) -> List[Op]:
    """The profiler's events. Work on the card is a kernel, a copy or a
    fill (the card's copies of the benchmark's own ranges are left out); a
    host operation is a PyTorch operator or a range, not a call of the CUDA
    runtime or driver. Where the profiler names each event's activity type
    it is used; otherwise the names tell."""
    from torch.autograd import DeviceType

    out = []
    for e in result.events():
        name, on_card = e.name(), e.device_type() != DeviceType.CPU
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        runtime = not on_card and bool(_RUNTIME.match(name))
        if kind is not None:
            dev = on_card and kind in DEVICE_KINDS
            host = not on_card and kind in ("cpu_op", "user_annotation")
        else:
            annotation = name.startswith("cfmbench.") or (
                hasattr(e, "is_user_annotation") and e.is_user_annotation())
            dev = on_card and not annotation
            host = not on_card and not runtime and name != "Activity Buffer Request"
        out.append(Op(name, e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                      e.sequence_nr(), e.start_thread_id(), dev, host, runtime))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def classify(name: str, groups: List[Dict[str, Any]]) -> str:
    """The kernel group of a device operation: the first ``kernels/*.json``
    (by ``order``) one of whose patterns the name holds; ``"rest"`` if none."""
    lower = name.lower()
    for g in groups:
        if any(p.lower() in lower for p in g["patterns"]):
            return g["key"]
    return "rest"


@dataclasses.dataclass
class TraceData:
    """The reduced trace. Times in seconds unless named otherwise."""

    window_s: float                        # the card's span over the device session
    busy_s: float
    steps: int                             # steps (or evaluations) of the device session
    group_s: Dict[str, float]              # device time by kernel group key
    group_names: Dict[str, str]
    top_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    host_steps: int = 0
    host_syncs: int = 0                    # inside the host session's step ranges
    calls: List[Call] = dataclasses.field(default_factory=list)
    call_device_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    unlinked_s: float = 0.0                # device time with no launching call found
    linked_device_s: float = 0.0

    @classmethod
    def from_device(cls, ops: List[Op], steps: int) -> "TraceData":
        groups = harness.kernel_groups()
        names = {g["key"]: g["name"] for g in groups}
        names["rest"] = "other device operations"
        dev = sorted((o for o in ops if o.device), key=lambda o: o.start)
        if not dev:
            return cls(0.0, 0.0, steps, {}, names, [], [])
        w0, w1 = dev[0].start, max(o.end for o in dev)
        busy = _union([(o.start, o.end) for o in dev])
        group_s: Dict[str, float] = defaultdict(float)
        for o in dev:
            group_s[classify(o.name, groups)] += (o.end - o.start) * 1e-9
        # Each idle gap is named by the operation that ended it: what the
        # host launched next.
        gaps: Dict[str, float] = defaultdict(float)
        starts = [o.start for o in dev]
        for (_, e), (s, _) in zip(busy[:-1], busy[1:]):
            nxt = dev[bisect.bisect_left(starts, s)]
            gaps[names[classify(nxt.name, groups)] + ": " + nxt.name[:80]] += (s - e) * 1e-9
        top = sorted(group_s.items(), key=lambda kv: -kv[1])[:10]
        return cls(window_s=(w1 - w0) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                   steps=steps, group_s=dict(group_s), group_names=names,
                   top_ops=[(names[k], v) for k, v in top],
                   idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])

    def add_host(self, ops: List[Op], calls: List[Call], steps: int) -> None:
        """The host session: host synchronisations a step, and each hooked
        call's device time."""
        host = [o for o in ops if o.host]
        spans = sorted((o.start, o.end) for o in host if o.name == STEP)
        self.host_steps = steps
        self.host_syncs = sum(1 for o in ops if o.runtime and o.name in SYNC_NAMES
                              and any(s <= o.start <= e for s, e in spans))
        launches = {o.corr: o for o in ops if o.runtime and
                    any(k in o.name for k in ("Launch", "Memcpy", "Memset"))}
        ranges: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
        nodes: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
        for o in host:
            if o.name.startswith(("cfmbench.attention/", "cfmbench.groupnorm/")):
                ranges[o.thread].append((o.start, o.end, int(o.name.rsplit("/", 1)[1])))
            elif o.name.startswith("autograd::engine::evaluate_function") and o.seq >= 0:
                nodes[o.thread].append((o.start, o.end, o.seq))
        for d in (ranges, nodes):
            for t in d:
                d[t].sort()
        owners = sorted((c.seq_lo, c.seq_hi, i) for i, c in enumerate(calls)
                        if c.seq_lo >= 0 and c.seq_hi > c.seq_lo)
        call_s: Dict[int, float] = defaultdict(float)
        for o in ops:
            if not o.device:
                continue
            dur = (o.end - o.start) * 1e-9
            launch = launches.get(o.corr)
            if launch is None:
                self.unlinked_s += dur
                continue
            self.linked_device_s += dur
            owner = _enclosing(ranges.get(launch.thread, []), launch.start)
            if owner is None:
                seq = _enclosing(nodes.get(launch.thread, []), launch.start)
                if seq is not None and seq >= 0:
                    owner = _owner_of_seq(owners, seq)
            if owner is not None:
                call_s[owner] += dur
        self.calls, self.call_device_s = calls, dict(call_s)

    def per_step_ms(self, group: str) -> Optional[float]:
        """Device ms a traced step of the kernels of ``kernels/<group>.json``;
        None where the group ran nothing or no step was traced."""
        if not self.steps or self.group_s.get(group, 0.0) <= 0.0:
            return None
        return 1e3 * self.group_s[group] / self.steps

    def roofline_pct(self, kind: str, backward: bool) -> Optional[float]:
        """The bound of the hooked calls of ``kind`` (forward, and with
        ``backward`` the backward too) over the device time attributed to
        them, in %. None where nothing was attributed, or where device time
        was left without its launching call (the attribution would then be
        partial)."""
        group = json.loads((harness.HERE / "kernels" / f"{kind}.json").read_text())
        if self.unlinked_s > 0.001 * max(self.linked_device_s, 1e-12):
            return None
        bound = spent = 0.0
        for i, c in enumerate(self.calls):
            if c.kind != kind or i not in self.call_device_s:
                continue
            if backward and not (c.seq_lo >= 0 and c.seq_hi > c.seq_lo):
                return None
            bound += _bound(group["forward"], c.shape)
            if backward:
                bound += _bound(group["backward"], c.shape)
            spent += self.call_device_s[i]
        if spent <= 0.0:
            return None
        return 100.0 * bound / spent


def _bound(counts: Dict[str, str], shape: Dict[str, int]) -> float:
    """Seconds: the larger of operations over the bf16 tensor-core peak (and
    ``f32_operations`` over the f32 peak) and bytes over the memory peak."""
    env = {"__builtins__": {}}
    flops = eval(counts.get("operations", "0"), env, dict(shape))
    f32 = eval(counts.get("f32_operations", "0"), env, dict(shape))
    nbytes = eval(counts["bytes"], env, dict(shape))
    return max(flops / harness.PEAK_BF16_FLOPS + f32 / harness.PEAK_F32_FLOPS,
               nbytes / harness.PEAK_BYTES)


def _enclosing(spans: List[Tuple[int, int, int]], t: int) -> Optional[int]:
    """The tag of the innermost span holding time ``t`` (spans sorted)."""
    i = bisect.bisect_right(spans, (t, float("inf"), float("inf")))
    best = None
    for s, e, tag in reversed(spans[max(0, i - 64):i]):
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, tag)
    return None if best is None else best[1]


def _owner_of_seq(owners: List[Tuple[int, int, int]], seq: int) -> Optional[int]:
    i = bisect.bisect_left(owners, (seq, -1, -1)) - 1
    for lo, hi, idx in owners[max(0, i - 1):i + 2]:
        if lo < seq <= hi:
            return idx
    return None
