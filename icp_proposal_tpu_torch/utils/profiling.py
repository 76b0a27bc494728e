"""Timing: the reference's wall-clock prints, and the program's spans.

``wall_timer`` is the counterpart of ``wall_timer`` in
``icp_proposal_tpu/utils/profiling.py`` (reference
``IcpProposalRegistration.scala:41-46``).

``span(name)`` marks one phase of the MH step or of the set-up (the names
are listed in ``STEP_SPANS`` and ``SETUP_SPANS``).  Tracing is off unless a
``tracing()`` block turns it on; then each span is a
``torch.profiler.record_function`` range, so it lands in a running
profiler's trace on the device operations' clock, and it is kept on the
host clock until ``spans()`` hands the kept list over.  Off, a span is one
shared no-op context.  A span never synchronizes, reads a tensor or
changes a launch.  The benchmark reads them (device time by phase, idle
gaps by phase, set-up seconds by phase):

    python3 portbench/phases.py --workload <cell> --seed <n>
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

import torch

# phase of the MH step → what it covers (innermost wins)
STEP_SPANS = {
    "mh.step": "a step; its own time is the fused pass's gathers",
    "mh.propose": "candidate generation and the per-chain selection (K2/K7 draws)",
    "mh.decode": "the candidates' points and vertex normals",
    "mh.anchor": "the reverse anchors: correspondences, assembly, factor",
    "icp.correspond": "an ICP component's correspondences, masks and observations",
    "gpmm.assemble": "the posterior system M and its right-hand side",
    "chol.factor": "symmetrize M, factor and solve (K1/K6)",
    "surface.query": "closest-point and nearest-vertex queries (K3/K4/K8/K5)",
    "mh.density": "the forward and reverse mixture densities",
    "mh.evaluate": "the likelihood and prior arithmetic",
    "mh.accept": "log α, the accept test, the new carry and the record",
}
SETUP_SPANS = {
    "setup.model": "models.gpmm.make_gpmm",
    "setup.context": "sampling.context.build_target_context (the K9 index)",
    "setup.mixture": "the mixture's tables (ICP's float64 Gram)",
    "setup.evaluator": "the evaluator's tables",
    "setup.step": "make_mh_step: fusion plan, vertex-face adjacency",
    "setup.carry": "init_carry: the first evaluation and anchors",
    "setup.kernels": "the kernel library's build or load",
}


class Span(NamedTuple):
    """A kept span: its name, its parent's name (None at the root) and its
    host-clock bounds (``time.perf_counter_ns``)."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int


_on = False
_kept: list = []
_local = threading.local()  # each thread's stack of open span names
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _local.stack.pop()
        _kept.append(Span(self.name, self.parent, self.start, end))
        return False


def span(name: str):
    """A context marking the phase ``name``; a shared no-op while tracing
    is off."""
    if not _on:
        return _OFF
    return _Open(name)


@contextlib.contextmanager
def tracing(enabled: bool = True):
    """Turn the spans on (or off) for the block, restoring the previous
    state after it."""
    global _on
    before, _on = _on, bool(enabled)
    try:
        yield
    finally:
        _on = before


def spans() -> list:
    """The spans kept since the last call, in the order they closed, as
    ``Span`` tuples; the kept list is cleared."""
    out = _kept[:]
    del _kept[: len(out)]
    return out


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def wall_timer(tag: str = "ICP", verbose: bool = True, device=None):
    """Time the block and print the reference's ``{tag}-Timing: N sec``;
    the seconds go into the yielded dict as ``"seconds"``.  With a CUDA
    ``device`` the card is synchronized before each clock reading, so the
    time covers the block's device work, not only its launches."""
    _sync(device)
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        _sync(device)
        holder["seconds"] = time.perf_counter() - t0
        if verbose:
            print(f"{tag}-Timing: {holder['seconds']} sec")
