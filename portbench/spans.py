"""Device time and idle gaps of a traced stretch by the program's spans.

The program marks each phase of its MH step and set-up with a span
(``icp_proposal_tpu_torch.utils.profiling.span``): with tracing on, a
``record_function`` range, which a ``torch.profiler`` trace of the host's
operations holds as a ``user_annotation`` event on the launching thread.
``reduce_spans`` maps each device operation inside the ``trace.WINDOW``
span to the innermost program span around its launch, the runtime call of
the same correlation id on the same thread: the span's *self* device time
is the sum over the operations mapped to it.  An operation launched under
no program span, or whose launch the trace lacks, counts as ``OUTSIDE``.
Each idle gap is named by the span of the launch that ends it, as
``trace.reduce_events`` names it by the host operation; the gap from the
last operation to the window's end is ``"synchronize"``.
"""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field

from portbench.trace import DEVICE_CATS, US, WINDOW

OUTSIDE = "(outside)"


@dataclass
class SpanTimes:
    """A stretch's device time by program span: ``self_s`` and ``ops`` (the
    operations) by span name, ``OUTSIDE`` included; ``gaps`` as (span name,
    seconds) in the order they occur; ``window_s`` the stretch's length."""

    window_s: float
    self_s: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)

    def total_s(self) -> float:
        return sum(self.self_s.values())

    def per_step_ms(self, steps: int) -> dict:
        """{span: [self device ms a step, operations a step]}, largest first."""
        return {name: [1e3 * secs / steps, self.ops[name] / steps]
                for name, secs in sorted(self.self_s.items(), key=lambda kv: -kv[1])}


class SpanIndex:
    """The program spans of a trace (every ``user_annotation`` but the
    window) by thread, to find the innermost span around a host timestamp
    (µs)."""

    def __init__(self, events: list):
        self.by_tid = defaultdict(list)
        for e in events:
            if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") != WINDOW):
                s = float(e["ts"])
                self.by_tid[e.get("tid")].append((s, s + float(e["dur"]), e["name"]))
        self.starts = {}
        for tid, spans in self.by_tid.items():
            spans.sort()
            self.starts[tid] = [s for s, _, _ in spans]

    def innermost(self, ts: float, tid) -> str:
        """Spans on a thread nest, so the latest-starting span that still
        covers ``ts`` is the innermost; ``OUTSIDE`` when none does."""
        spans = self.by_tid.get(tid, [])
        for i in range(bisect_right(self.starts.get(tid, []), ts) - 1, -1, -1):
            s, t, name = spans[i]
            if t >= ts:
                return name
        return OUTSIDE


def reduce_spans(events: list) -> SpanTimes:
    """chrome-trace events → ``SpanTimes`` of the device operations inside
    the ``WINDOW`` span."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (float(e["ts"]), e.get("tid"))
    index = SpanIndex(events)
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            if s >= w0 and t <= w1:
                corr = (e.get("args") or {}).get("correlation")
                name = index.innermost(*launch[corr]) if corr in launch else OUTSIDE
                ops.append((s, t, name))
    ops.sort()
    out = SpanTimes(window_s=(w1 - w0) * US)
    self_s, count = defaultdict(float), defaultdict(int)
    end = w0
    for s, t, name in ops:
        self_s[name] += (t - s) * US
        count[name] += 1
        if s > end:
            out.gaps.append((name, (s - end) * US))
        end = max(end, t)
    if w1 > end:
        out.gaps.append(("synchronize", (w1 - end) * US))
    out.self_s, out.ops = dict(self_s), dict(count)
    return out


def setup_seconds(kept) -> dict:
    """Host seconds of each root ``setup.*`` span among the kept spans
    (``profiling.spans()``), summed by name."""
    out = defaultdict(float)
    for sp in kept:
        if sp.parent is None and sp.name.startswith("setup."):
            out[sp.name] += (sp.end_ns - sp.start_ns) * 1e-9
    return dict(out)
