"""The benchmark's femur GPMM-400 cell, ``femur400.flagship.c2048``: the
configuration ``femur-gpmm400`` (rank 401, the reference's CreateGPModel
recipe at i = 400) under the flagship mixture.

* the cell cut to rank 11 and 4 chains, judged by the plain reference as a
  run on the card is judged;
* the configuration at its real rank 401 with 2 chains for a few steps:
  the port's float32 assembly at full width against the float64 reference;
* the two readers of the streamed K6 on a synthetic trace;
* the manifest's entries and the cell's sizes (2·rank ICP points, 4·rank
  evaluator points);
* on the card, one step of the cell's system routes every factor to the
  streamed K6 and every draw to the row kernel.
"""
import copy
import json
import time

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from portbench import flops, trace
from portbench.manifest import ROOT, Manifest
from portbench.run import run_cell
from portbench.tests.helpers import tiny_root

CELL = "femur400.flagship.c2048"
CONFIG = "femur-gpmm400"
METRICS = ("streamed_factor_ms_per_step", "streamed_factor_roofline")
SEED = 2 ** 31 + 40_104
CPU = torch.device("cpu")
MAN = Manifest(ROOT)


def _assert_agrees(result, lines, steps, chains):
    assert result["correct"], lines
    check = result["check"]
    assert check["lp_gap_p90"]["value"] < 1e-3, lines
    assert check["log_alpha_gap_p90"]["value"] < 1e-3, lines
    assert check["bad_step_share"]["value"] == 0, lines
    assert result["attempted"] == steps * chains and result["failed"] == 0
    assert set(result["metrics"]) == {
        "samples_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"}


def test_cell_at_rank_11_agrees_with_the_reference(tmp_path):
    man, cell = tiny_root(tmp_path, CELL, 11, 4)
    assert man.config(cell["config"])["rank"] == 11
    result, lines = run_cell(man, cell, SEED, 60.0, False, CPU, time.monotonic(),
                             max_steps=6)
    _assert_agrees(result, lines, 6, 4)


def full_width_root(tmp, chains: int, pairs: int):
    """A root under ``tmp`` whose cell is the real one with ``chains``
    chains and a small check; the configuration is copied as it is."""
    data = copy.deepcopy(MAN.data)
    cell = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json").read_text())
    cell.update(chains=chains, warmup_steps=1, segment_steps=2)
    cell["check"].update(chains=chains, pairs=pairs, batch=pairs)
    for sub in ("workloads", "configs"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    entry = next(c for c in data["configs"] if c["name"] == CONFIG)
    (tmp / entry["file"]).write_text((ROOT / entry["file"]).read_text())
    (tmp / "portbench" / "workloads" / f"{CELL}.json").write_text(json.dumps(cell))
    (tmp / "BENCHMARK.json").write_text(json.dumps(data))
    man = Manifest(tmp)
    return man, man.workload(CELL)


def test_config_at_rank_401_agrees_with_the_reference(tmp_path):
    """The float32 assembly of 802 observations at r = 401 (the target
    direction's gathered [B, 802, 3, 401] tensors, the model direction's
    Gram table) against the float64 reference, 2 chains for 4 steps, 4
    chain-steps judged (the reference's float64 geometry takes most of the
    test's time)."""
    man, cell = full_width_root(tmp_path, chains=2, pairs=4)
    assert man.config(cell["config"])["rank"] == 401
    result, lines = run_cell(man, cell, SEED, 600.0, False, CPU, time.monotonic(),
                             max_steps=4)
    _assert_agrees(result, lines, 4, 2)


# ---------------------------------------------------------------------------
# the readers


def _view(ops, steps=4):
    return trace.TraceView(ops=ops, window_s=1.0, steps=steps, host_s_per_step=0.01,
                           step_s=0.18, cell={"chains": 2048}, config={"rank": 401},
                           step_flops=1e12)


STREAMED = "chol_solve_streamed_kernel(float const*, float const*, float*, int)"
OTHERS = [("chol_solve_tiled_kernel<8>(float const*)", 0.0, 0.5),
          ("tri_solve_lt_rows_kernel(float const*)", 0.5, 0.6),
          ("sm90_xmma_gemm_f32f32", 0.6, 0.9)]


def test_streamed_readers_match_only_the_streamed_kernel():
    ops = OTHERS + [(STREAMED, 1.0, 1.0055), ("void " + STREAMED, 2.0, 2.0055)]
    view = _view(ops, steps=1)
    ms = MAN.reader("streamed_factor_ms_per_step")(view)
    assert ms == pytest.approx(11.0)
    share = MAN.reader("streamed_factor_roofline")(view)
    assert share == pytest.approx(100.0 * 2 * flops.factor_bound_s(2048, 401) / 0.011)
    assert 0 < share < 100


def test_streamed_roofline_is_the_bound_over_the_time():
    secs = 5.53e-3
    share = MAN.reader("streamed_factor_roofline")(_view([(STREAMED, 0.0, secs)]))
    assert share == pytest.approx(100.0 * flops.factor_bound_s(2048, 401) / secs)
    # r = 401 at 2,048 chains is bound by its flops: B·r³/3 at the FP32 peak
    assert flops.factor_bound_s(2048, 401) == pytest.approx(
        2048 * 401 ** 3 / 3 / flops.PEAK_FP32_FLOPS)


@pytest.mark.parametrize("name", METRICS)
def test_streamed_readers_without_launches(name):
    read = MAN.reader(name)
    assert read(_view(OTHERS)) is None
    assert read(_view([])) is None


# ---------------------------------------------------------------------------
# the manifest


def test_manifest_finds_the_config_cell_and_metrics():
    cell = MAN.workload(CELL)
    config = MAN.config(cell["config"])
    entry = next(c for c in MAN.data["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and config["reduced"] == []
    assert config["name"] == CONFIG and config["rank"] == 401
    assert config["components"] == 400 and config["model"]["nystrom_points"] == 2 * 400
    assert cell["chips"] == 1 and cell["chains"] == 2048 and cell["setup"] == "flagship"
    names = {m["name"] for m in MAN.metrics_for(CELL, "per_layer")}
    assert set(METRICS) <= names
    for m in METRICS:
        assert callable(MAN.reader(m))
    # the unlisted metrics cover the cell; the kernel-listed ones stay as they were
    assert {"host_ms_per_step", "device_idle_share", "step_mfu",
            "library_ms_per_step"} <= names
    assert not {"index_ms_per_step", "factor_ms_per_step", "factor_roofline"} & names


def test_config_matches_gpmm100_but_for_the_rank():
    """The same bone, meshes, kernel and index as ``femur-gpmm100``; only
    the recipe's i (and what follows from it) differs."""
    a, b = MAN.config("femur-gpmm100"), MAN.config(CONFIG)
    differ = {k for k in a.keys() | b.keys() if a.get(k) != b.get(k)}
    assert differ == {"name", "source", "rank", "components", "model", "assumed", "standin"}
    assert b["rank"] == b["components"] + 1
    model_differ = {k for k in a["model"] if a["model"][k] != b["model"][k]}
    assert model_differ == {"nystrom_points"}


def test_cell_sizes_follow_the_rank():
    cell = MAN.workload(CELL)
    rank = int(MAN.config(cell["config"])["rank"])
    icp = [c for c in cell["mixture"] if c["kind"] == "icp"]
    assert [c["direction"] for c in icp] == ["target", "model"]
    assert all(c["n_points"] == 2 * rank for c in icp)
    assert cell["evaluator"]["n_points"] == 4 * rank
    assert 4 * rank <= MAN.config(cell["config"])["vertices"]
    assert cell["check"]["pairs"] >= 512


def test_new_metrics_name_only_accepted_cells():
    cells = {w["name"] for w in MAN.data["workloads"]}
    per_layer = {m["name"]: m for m in MAN.data["per_layer"]}
    for name in METRICS:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and set(m["workloads"]) <= cells
        assert m["layer"] == per_layer["factor_roofline"]["layer"]
        assert m["moves"] == "samples_per_s" and m["source"] == "device_trace"
    assert per_layer["streamed_factor_roofline"]["unit"] == "%"


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_routes_to_the_streamed_factor(cuda):
    """One step of the cell's system on the card: 2 streamed K6 launches
    (each ICP direction's factor) and 2 of the row kernel (each draw), no
    K1, tiled K6, K2 or streamed K7."""
    from icp_proposal_tpu_torch.ops import chol_cuda
    from portbench.inputs import make_inputs
    from portbench.run import Noise
    from portbench.system import System

    cell = MAN.workload(CELL)
    config = MAN.config(cell["config"])
    inputs = make_inputs(config, cuda)
    system = System(inputs, config, cell, cuda)
    chains, rank = 256, int(config["rank"])
    noise = Noise(SEED, cuda, chains, rank, [c["weight"] for c in cell["mixture"]], 0.3)
    center = torch.as_tensor(inputs["ref_points"]).mean(0).to(cuda)
    carry = system.init_carry({
        "scale": torch.ones(chains, device=cuda), "rot": torch.zeros((chains, 3), device=cuda),
        "trans": torch.zeros((chains, 3), device=cuda),
        "center": center.expand(chains, 3).clone(), "coeffs": noise.init.clone()})
    counters = {name: getattr(chol_cuda, name) for name in (
        "chol_solve", "chol_solve_blocked", "chol_solve_streamed", "tri_solve_lt",
        "tri_solve_lt_blocked", "tri_solve_lt_streamed")}
    before = {name: f.launches for name, f in counters.items()}
    carry, record = system.step(carry, noise=system.noise(*noise.draw()))
    torch.cuda.synchronize()
    launched = {name: f.launches - before[name] for name, f in counters.items()}
    assert launched == {"chol_solve": 0, "chol_solve_blocked": 0, "chol_solve_streamed": 2,
                        "tri_solve_lt": 0, "tri_solve_lt_blocked": 2,
                        "tri_solve_lt_streamed": 0}
    assert bool(torch.isfinite(record.log_product).all())
