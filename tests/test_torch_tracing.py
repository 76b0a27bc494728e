"""The program's spans (``utils/profiling.span``) and the benchmark's
reduction of a traced stretch by span (``portbench/spans.py``).

Spans are off by default and then record nothing; on, one MH step of the
flagship, partial-face and random-walk setups records the span tree of
``profiling.STEP_SPANS`` and launches and computes exactly what it does
off.  The reduction is held to a canned chrome trace, and the spans to a
real CPU ``torch.profiler`` trace of a step: every operation the step
launches lies under a phase span."""
import json
import math
import os
import time
from collections import Counter

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.utils import profiling
from portbench import phases, spans, trace
from portbench.inputs import make_inputs
from portbench.run import Noise
from portbench.system import System
from portbench.tests.helpers import tiny_root

CPU = torch.device("cpu")
SETUPS = [  # cell, rank, chains, face subdivisions
    ("femur100.flagship.c4096", 11, 4, None),
    ("face200.partial.c2048", 8, 3, 2),
    ("femur100.rw.c16384", 11, 4, None),
]
IDS = [s[0].split(".")[1] for s in SETUPS]

# (span, parent) of one step; surface.query under mh.step is the fused pass
STEP_TREE = {"mh.step": None, "mh.propose": "mh.step", "mh.decode": "mh.step",
             "mh.anchor": "mh.step", "mh.density": "mh.step",
             "mh.evaluate": "mh.step", "mh.accept": "mh.step"}
ICP_TREE = {("icp.correspond", "mh.anchor"), ("gpmm.assemble", "mh.anchor"),
            ("chol.factor", "mh.anchor"), ("surface.query", "icp.correspond")}
TREES = {
    "flagship": set(STEP_TREE.items()) | ICP_TREE | {("surface.query", "mh.step")},
    "partial": set(STEP_TREE.items()) | ICP_TREE | {("surface.query", "mh.evaluate")},
    "rw": set(STEP_TREE.items()) | {("surface.query", "mh.evaluate")},
}
SETUP_ROOTS = {"setup.model", "setup.context", "setup.mixture", "setup.evaluator",
               "setup.step", "setup.carry"}
# operations a step may launch under mh.step itself: the fused pass's gathers
STEP_OWN_OPS = {"aten::index"}


class Built:
    def __init__(self, tmp, name, rank, chains, subdiv):
        man, self.cell = tiny_root(tmp, name, rank, chains, subdivisions=subdiv)
        config = man.config(self.cell["config"])
        inputs = make_inputs(config, CPU)
        profiling.spans()
        with profiling.tracing():
            self.system = System(inputs, config, self.cell, CPU)
            center = np.asarray(inputs["ref_points"], np.float32).mean(axis=0)
            weights = [c["weight"] for c in self.cell["mixture"]]
            self.noise = Noise(2 ** 31 + 4242, CPU, chains, int(config["rank"]), weights,
                               0.3)
            self.carry = self.system.init_carry({
                "scale": torch.ones(chains), "rot": torch.zeros((chains, 3)),
                "trans": torch.zeros((chains, 3)),
                "center": torch.as_tensor(center).expand(chains, 3).clone(),
                "coeffs": self.noise.init.clone()})
        self.setup_spans = profiling.spans()

    def step(self, carry=None):
        z, idx, log_u = self.noise.draw()
        return self.system.step(self.carry if carry is None else carry,
                                noise=self.system.noise(z, idx, log_u))


@pytest.fixture(scope="module", params=SETUPS, ids=IDS)
def built(request, tmp_path_factory):
    name, rank, chains, subdiv = request.param
    b = Built(tmp_path_factory.mktemp("tracing"), name, rank, chains, subdiv)
    b.kind = name.split(".")[1]
    return b


# ---------------------------------------------------------------------------
# the spans in the program


def test_tracing_is_off_by_default():
    profiling.spans()
    assert span_is_noop()
    with profiling.span("mh.step"):
        with profiling.span("mh.propose"):
            pass
    assert profiling.spans() == []


def span_is_noop() -> bool:
    return profiling.span("a") is profiling.span("b")


def test_tracing_block_turns_on_and_restores():
    profiling.spans()
    with profiling.tracing():
        assert not span_is_noop()
        with profiling.tracing(False):
            assert span_is_noop()
            with profiling.span("hidden"):
                pass
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    assert span_is_noop()
    kept = profiling.spans()
    assert [(s.name, s.parent) for s in kept] == [("inner", "outer"), ("outer", None)]
    assert kept[1].start_ns <= kept[0].start_ns <= kept[0].end_ns <= kept[1].end_ns
    assert profiling.spans() == []


def test_span_closes_on_an_exception():
    profiling.spans()
    with profiling.tracing():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                raise ValueError("inside")
        with profiling.span("after"):
            pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [
        ("outer", None), ("after", None)]


def test_step_records_no_spans_when_off(built):
    profiling.spans()
    built.step()
    assert profiling.spans() == []


def test_step_records_the_span_tree(built):
    profiling.spans()
    with profiling.tracing():
        built.step()
    kept = profiling.spans()
    assert {(s.name, s.parent) for s in kept} == TREES[built.kind]
    assert set(STEP_TREE) | {s.name for s in kept} <= set(profiling.STEP_SPANS)
    assert [s.name for s in kept if s.parent is None] == ["mh.step"]
    root = kept[-1]
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in kept)


def test_setup_records_the_setup_spans(built):
    roots = {s.name for s in built.setup_spans if s.parent is None}
    assert roots == SETUP_ROOTS
    assert {s.name for s in built.setup_spans} <= set(profiling.SETUP_SPANS) | set(
        profiling.STEP_SPANS)
    secs = spans.setup_seconds(built.setup_spans)
    assert set(secs) == SETUP_ROOTS and all(v >= 0 for v in secs.values())
    nested = [s for s in built.setup_spans if s.parent is not None]
    assert all(s.parent.startswith("setup.") or s.parent in profiling.STEP_SPANS
               for s in nested)


def test_tracing_leaves_the_step_bit_identical(built):
    noise_state = built.noise.gen.get_state()
    runs = []
    for on in (False, True):
        built.noise.gen.set_state(noise_state)
        with profiling.tracing(on):
            runs.append(built.step())
    profiling.spans()
    assert phases.same_bits(runs[0], runs[1])
    carry, record = runs[0]
    assert record.accepted.shape == carry.log_post.shape


def test_same_bits():
    a = torch.tensor([1.0, float("nan"), 0.0])
    assert phases.same_bits((a, None, (a,)), (a.clone(), None, (a.clone(),)))
    assert not phases.same_bits(a, torch.tensor([1.0, float("nan"), -0.0]))
    assert not phases.same_bits(a, a.double())
    assert not phases.same_bits((a,), (a, a))


def _step_trace(built, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.tracing():
            with torch.profiler.record_function(trace.WINDOW):
                built.step()
    profiling.spans()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_every_op_of_a_step_lies_under_a_phase(built, tmp_path):
    """On a real CPU trace, every operation the step calls itself (an
    ``aten`` op inside no other) lies under a phase span; under ``mh.step``
    alone only the fused pass's gathers."""
    events = _step_trace(built, tmp_path)
    index = spans.SpanIndex(events)
    step = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "mh.step"]
    assert len(step) == 1
    s0, s1 = float(step[0]["ts"]), float(step[0]["ts"]) + float(step[0]["dur"])
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
                 for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                 and s0 <= float(e["ts"]) <= s1)
    owner, end = Counter(), -math.inf
    for s, t, name, tid in ops:
        if s >= end:  # called by the program, not by another op
            owner[index.innermost(s, tid), name] += 1
            end = t
    assert owner
    assert {span for span, _ in owner} <= set(profiling.STEP_SPANS)
    assert {name for span, name in owner if span == "mh.step"} <= STEP_OWN_OPS
    phases_seen = {span for span, _ in owner}
    assert {"mh.propose", "mh.decode", "mh.density", "mh.evaluate", "mh.accept"} <= phases_seen


# ---------------------------------------------------------------------------
# the reduction on a canned trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur), "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


CANNED = [
    _x("user_annotation", trace.WINDOW, 1000, 1000),
    _x("user_annotation", "mh.step", 1005, 900),
    _x("user_annotation", "mh.anchor", 1010, 300),
    _x("user_annotation", "chol.factor", 1100, 50),
    _x("user_annotation", "mh.evaluate", 1400, 100),
    _x("cpu_op", "aten::mm", 1020, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 1022, 2, corr=1),  # mh.anchor
    _x("cuda_runtime", "cudaLaunchKernel", 1120, 2, corr=2),  # chol.factor
    _x("cuda_runtime", "cudaLaunchKernel", 1350, 2, corr=3),  # mh.step itself
    _x("cuda_runtime", "cudaLaunchKernel", 1450, 2, corr=4),  # mh.evaluate
    _x("cuda_runtime", "cudaLaunchKernel", 1950, 2, corr=5),  # no span
    _x("cuda_runtime", "cudaLaunchKernel", 1460, 2, tid=2, corr=6),  # another thread
    _x("kernel", "gemm", 1030, 100, tid=7, corr=1),
    _x("kernel", "chol_solve_tiled_kernel", 1130, 40, tid=7, corr=2),
    _x("gpu_memcpy", "Memcpy DtoD", 1400, 20, tid=7, corr=3),
    _x("kernel", "reduce", 1460, 30, tid=7, corr=4),
    _x("kernel", "noise", 1500, 10, tid=7, corr=6),
    _x("gpu_memset", "Memset", 1955, 5, tid=7, corr=5),
    _x("kernel", "unlaunched", 1970, 10, tid=7, corr=99),
    _x("kernel", "after the window", 2100, 10, tid=7, corr=5),
]


def test_reduce_spans_innermost_span_wins():
    out = spans.reduce_spans(CANNED)
    assert math.isclose(out.window_s, 1e-3)
    assert out.ops == {"mh.anchor": 1, "chol.factor": 1, "mh.step": 1, "mh.evaluate": 1,
                       spans.OUTSIDE: 3}
    assert out.self_s["mh.anchor"] == pytest.approx(100e-6)
    assert out.self_s["chol.factor"] == pytest.approx(40e-6)
    assert out.self_s["mh.step"] == pytest.approx(20e-6)
    assert out.self_s["mh.evaluate"] == pytest.approx(30e-6)


def test_reduce_spans_counts_ops_under_no_span_as_outside():
    out = spans.reduce_spans(CANNED)
    # the other thread's launch, the launch after mh.step, the op without a launch
    assert out.self_s[spans.OUTSIDE] == pytest.approx((10 + 5 + 10) * 1e-6)


def test_reduce_spans_sums_to_the_device_time():
    out = spans.reduce_spans(CANNED)
    window_ops = trace.reduce_events(CANNED)[1]
    assert out.total_s() == pytest.approx(sum(e - s for _, s, e in window_ops))
    assert sum(out.ops.values()) == len(window_ops)
    split = out.per_step_ms(2)
    assert list(split)[0] == "mh.anchor"
    assert split["mh.anchor"] == pytest.approx([0.05, 0.5])
    assert sum(ms for ms, _ in split.values()) == pytest.approx(1e3 * out.total_s() / 2)


def test_reduce_spans_names_gaps_by_the_span_that_ends_them():
    out = spans.reduce_spans(CANNED)
    assert [(name, round(secs * 1e6, 6)) for name, secs in out.gaps] == [
        ("mh.anchor", 30.0), ("mh.step", 230.0), ("mh.evaluate", 40.0),
        (spans.OUTSIDE, 10.0), (spans.OUTSIDE, 445.0), (spans.OUTSIDE, 10.0),
        ("synchronize", 20.0)]
    by_host_op = trace.reduce_events(CANNED)[2]
    assert sum(g for _, g in by_host_op) == pytest.approx(sum(g for _, g in out.gaps))


def test_reduce_spans_needs_the_window():
    with pytest.raises(ValueError):
        spans.reduce_spans([e for e in CANNED if e["name"] != trace.WINDOW])


def test_setup_seconds_sums_root_setup_spans():
    kept = [profiling.Span("setup.kernels", "setup.context", 10, 30),
            profiling.Span("setup.context", None, 0, 1_000_000_000),
            profiling.Span("setup.model", None, 0, 500_000_000),
            profiling.Span("setup.model", None, 0, 250_000_000),
            profiling.Span("mh.step", None, 0, 10)]
    assert spans.setup_seconds(kept) == pytest.approx({"setup.context": 1.0,
                                                       "setup.model": 0.75})


# ---------------------------------------------------------------------------
# the measurement script, rehearsed on the CPU


def test_phases_measure_on_the_cpu(tmp_path):
    man, cell = tiny_root(tmp_path, "femur100.flagship.c4096", 11, 3)
    result, lines = phases.measure(man, cell, 2 ** 31 + 17, 0.05, CPU, time.monotonic())
    assert result["same_kernels_on_off"] and result["same_results_on_off"]
    setup = result["setup"]
    assert set(setup["spans_s"]) == SETUP_ROOTS
    assert setup["program_setup_s"] <= setup["system_s"] <= setup["setup_s"]
    assert not setup["kernels_compiled"]
    assert len(result["windows_off"]) == len(result["windows_on"]) == 2
    assert all(w["steps"] >= 1 and w["samples_per_s"] > 0
               for w in result["windows_off"] + result["windows_on"])
    assert result["idle_gaps_by_span"][-1][0] == "synchronize"
    assert any(line.startswith("[phases] setup span setup.context") for line in lines)
