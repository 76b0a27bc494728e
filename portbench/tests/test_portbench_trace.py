"""The trace reduction on a canned ``torch.profiler`` chrome-trace event
list, and the per-layer readers over it."""
import math

import pytest

from portbench import trace
from portbench.manifest import ROOT, Manifest

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 1000.0,
     "dur": 1000.0, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1010.0, "dur": 50.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1020.0,
     "dur": 5.0, "tid": 1, "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "void gemm_kernel<float>", "ts": 1100.0,
     "dur": 200.0, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1300.0, "dur": 30.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1310.0,
     "dur": 5.0, "tid": 1, "args": {"correlation": 2}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1320.0,
     "dur": 5.0, "tid": 1, "args": {"correlation": 3}},
    {"ph": "X", "cat": "kernel", "name": "void nearest_vertices_kernel<EuclidPair, 4>(NvParams)",
     "ts": 1350.0, "dur": 100.0, "args": {"correlation": 2}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 1400.0, "dur": 100.0,
     "args": {"correlation": 3}},
    {"ph": "X", "cat": "kernel", "name": "late", "ts": 2500.0, "dur": 10.0,
     "args": {"correlation": 9}},
    {"ph": "i", "cat": "cpu_instant_event", "name": "ignored", "ts": 1500.0},
]


def view(**kw):
    window_s, ops, _ = trace.reduce_events(EVENTS)
    base = dict(ops=ops, window_s=window_s, steps=2, host_s_per_step=0.004,
                step_s=0.01, cell={"chains": 2048}, config={"rank": 101},
                step_flops=6.7e9, library_kernels=("nearest_vertices_kernel",))
    base.update(kw)
    return trace.TraceView(**base)


def test_reduce_events():
    window_s, ops, gaps = trace.reduce_events(EVENTS)
    assert math.isclose(window_s, 1e-3)
    assert [o[0] for o in ops] == ["void gemm_kernel<float>",
                                   "void nearest_vertices_kernel<EuclidPair, 4>(NvParams)",
                                   "Memcpy DtoD"]
    assert [g[0] for g in gaps] == ["aten::mm", "aten::add", "synchronize"]
    assert [round(g[1] * 1e6, 6) for g in gaps] == [100.0, 50.0, 500.0]
    assert math.isclose(view().busy_s(), 350e-6)


def test_device_ops_takes_every_device_op():
    ops = trace.device_ops(EVENTS)
    assert [o[0] for o in ops] == ["void gemm_kernel<float>",
                                   "void nearest_vertices_kernel<EuclidPair, 4>(NvParams)",
                                   "Memcpy DtoD", "late"]
    assert ops[-1][1:] == pytest.approx((2500e-6, 2510e-6))


def test_reduce_events_needs_the_window():
    with pytest.raises(ValueError):
        trace.reduce_events(EVENTS[1:])


def test_top_sums_by_name():
    assert trace.top([("a", 1.0), ("b", 3.0), ("a", 2.5)], n=1) == [["a", 3.5]]
    assert trace.top([("a", 1.0), ("b", 3.0)]) == [["b", 3.0], ["a", 1.0]]


def test_union_length():
    assert trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


@pytest.mark.parametrize("metric,expected", [
    ("device_idle_share", 100 * (1 - 350e-6 / 2 / 0.01)),
    ("library_ms_per_step", 0.15),
    ("index_ms_per_step", 0.05),
    ("host_ms_per_step", 4.0),
    ("step_mfu", 100 * 6.7e9 / 0.01 / 67e12),
    ("factor_ms_per_step", None),
    ("factor_roofline", None),
    ("dense_cp_ms_per_step", None),
])
def test_readers(metric, expected):
    got = Manifest(ROOT).reader(metric)(view())
    if expected is None:
        assert got is None
    else:
        assert math.isclose(got, expected, rel_tol=1e-9)


def test_factor_roofline_counts_launches():
    from portbench.flops import factor_bound_s

    ops = [("void chol_solve_tiled_kernel<4>(...)", 0.0, 1e-3),
           ("void chol_solve_tiled_kernel<4>(...)", 2e-3, 3e-3)]
    v = view(ops=ops)
    got = Manifest(ROOT).reader("factor_roofline")(v)
    assert math.isclose(got, 100 * 2 * factor_bound_s(2048, 101) / 2e-3)
    assert Manifest(ROOT).reader("factor_ms_per_step")(v) == pytest.approx(1.0)


def test_library_kernel_names_read_from_the_sources():
    names = trace.library_kernel_names(ROOT / "icp_proposal_tpu_torch" / "csrc")
    for k in ("chol_solve_tiled_kernel", "chol_solve_streamed_kernel",
              "nearest_vertices_kernel", "refine_shortlist_kernel",
              "surface_distances_kernel", "tile_boxes_kernel", "tri_solve_lt_rows_kernel"):
        assert k in names
