"""Reduce a ``torch.profiler`` chrome trace to what the per-layer readers
read.

Device operations are the events of category ``kernel``, ``gpu_memcpy``
and ``gpu_memset``.  The per-layer metrics read a trace of device activity
alone, started and stopped around a synchronized stretch, so every device
operation in it is the stretch's (``device_ops``).  Busy time is the union
of their intervals (operations on other streams may overlap).

Idle gaps are named from a second trace with the host's operations, whose
stretch is one ``record_function`` span named ``WINDOW`` that starts and
ends with a ``synchronize()`` (``reduce_events``): a gap is named by the
host operation that launched the device operation that ends it, the
innermost ``cpu_op`` around the runtime call of the same correlation id.
"""
from __future__ import annotations

import re
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
US = 1e-6


@dataclass
class TraceView:
    """What a per-layer metric reads: device operations (name, start s,
    end s) inside the traced stretch, its length, the steps in it, the
    host's seconds a step outside it, and the cell."""

    ops: list
    window_s: float
    steps: int
    host_s_per_step: float
    step_s: float  # seconds a step of the untraced window (host clock)
    cell: dict
    config: dict
    step_flops: float
    library_kernels: tuple = ()

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.ops])

    def seconds_of(self, names) -> tuple[float, int]:
        """(device seconds, operations) of the ops whose name holds one of
        ``names``."""
        secs, count = 0.0, 0
        for name, s, e in self.ops:
            if any(n in name for n in names):
                secs += e - s
                count += 1
        return secs, count


def union_length(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def library_kernel_names(csrc: Path) -> tuple:
    """The ``__global__`` function names of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
    names = set()
    for src in sorted(Path(csrc).glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return tuple(sorted(names))


def device_ops(events: list) -> list:
    """Every device operation of a trace as (name, start_s, end_s), by start."""
    ops = [(e["name"], float(e["ts"]) * US, (float(e["ts"]) + float(e.get("dur", 0.0))) * US)
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(ops, key=lambda o: o[1])


def reduce_events(events: list):
    """chrome-trace events → (window_s, device ops inside the window as
    (name, start_s, end_s), idle gaps as (host op name, seconds))."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            if s >= w0 and t <= w1:
                ops.append((e["name"], s, t, (e.get("args") or {}).get("correlation")))
    ops.sort(key=lambda o: o[1])

    # the host op behind each launch: runtime call by correlation, then the
    # innermost cpu_op around it on the same thread
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (float(e["ts"]), e.get("tid"))
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_tid[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                         e["name"]))
    starts = {}
    for tid, spans in by_tid.items():
        spans.sort()
        starts[tid] = [s for s, _, _ in spans]

    def host_op(corr):
        """Spans on a thread nest, so the latest-starting span that still
        covers the launch is the innermost."""
        if corr not in launch:
            return "unknown"
        ts, tid = launch[corr]
        spans = by_tid.get(tid, [])
        first = bisect_right(starts.get(tid, []), ts) - 1
        for i in range(first, max(-1, first - 4096), -1):
            s, t, name = spans[i]
            if t >= ts and name != WINDOW:
                return name
        return "unknown"

    gaps = []
    end = w0
    for name, s, t, corr in ops:
        if s > end:
            gaps.append((host_op(corr), (s - end) * US))
        end = max(end, t)
    if w1 > end:
        gaps.append(("synchronize", (w1 - end) * US))
    return (w1 - w0) * US, [(n, s * US, t * US) for n, s, t, _ in ops], gaps


def top(pairs, n=10):
    """[[name, seconds], ...] summed by name, largest first, at most n."""
    acc = defaultdict(float)
    for name, secs in pairs:
        acc[name[:160]] += secs
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
