"""The posterior-evidence tools (``icp_proposal_tpu_torch.tools``) against the
repository's JAX tools (``tools/``), on the CPU.

* The host copies are bitwise: ``np_ess``, ``np_split_rhat`` and ``compare``
  of ``tools/posterior_parity.py``, ``chain_state_traces`` of
  ``tools/quality_run.py``, and the numpy sampler of
  ``tools/reference_baseline_port.py`` (a chain on a small sphere, one seed).
* ``mixing_sweep._setup`` builds JAX's mixture (names, weights, parity,
  adaptation, observed ids) for every configuration of the sweep's grid
  (its step parity is in ``tests/test_torch_evidence_runs.py``).
* ``validate_index`` on the stand-in target at K = 16 and 64 gives JAX's
  ``ops/surface_index.validate_index`` numbers on the same queries (the
  tool's regimes, two states each; max_abs_err_mm within 1e-4,
  frac_mismatched equal), JAX computed in a child process whose XLA targets
  SSE4.2 (no FMA: ids round as the twins').
  Run as a script, this file is that child:

      python tests/test_torch_evidence.py QUERIES.npz OUT.json

* Every tool's ``main`` runs at a tiny size with ``--device cpu`` and
  ``--out`` under ``tmp_path``: its JSON has the keys of the JAX tool's
  committed artifact (or of the JAX tool's output where none is committed),
  and no file under ``artifacts/`` changes.
"""
import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax_native import child_env, inject_from_env
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / "artifacts"
RANK = 6
EV_KS = (16, 64)


def _sphere(jax_model: bool = False):
    """``tests/test_mh.py``'s sphere as a port ``FemurData`` on the CPU
    (icosphere of subdivision 2, radius 50, rank-6 synthetic GPMM, target
    at α = (1.5, −1, 0, …)); with ``jax_model`` also the JAX model and
    target (the port's model holds JAX's arrays)."""
    from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.apps.femur import FemurData

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jm = make_synthetic_gpmm(points, cells, rank=RANK, sigma=40.0, scale=5.0)
    alpha = np.zeros(RANK, np.float32)
    alpha[:2] = 1.5, -1.0
    target = TriangleMesh(points=np.asarray(jgp.instance_points(jm, alpha)),
                          cells=np.asarray(jm.cells))
    mask = boundary_vertex_mask(np.asarray(cells), len(points))
    pm = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                  device="cpu")
    data = FemurData(model=pm, target=target, target_boundary_mask=mask,
                     model_boundary_mask=mask)
    return (data, jm) if jax_model else data


def _nested_function(path: Path, outer: str, name: str):
    """The function ``name`` defined inside ``outer`` in the source file
    ``path``, compiled on its own with numpy as ``np``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(next(n for n in tree.body if getattr(n, "name", "") == outer))
              if isinstance(n, ast.FunctionDef) and n.name == name)
    scope = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), scope)
    return scope[name]


@pytest.fixture
def jax_tools():
    """The repository's ``tools`` modules the copies are held to, imported
    with the environment restored afterwards (``reference_baseline_port``
    pins the BLAS variables when imported)."""
    import importlib

    saved = dict(os.environ)
    try:
        yield {name: importlib.import_module(f"tools.{name}") for name in
               ("posterior_parity", "quality_run", "reference_baseline_port", "mixing_sweep")}
    finally:
        os.environ.clear()
        os.environ.update(saved)


# ---------------------------------------------------------------------------
# host copies, bitwise
# ---------------------------------------------------------------------------


def test_diagnostics_and_compare_are_bitwise_jax(jax_tools):
    """``np_ess`` (at max_lag 500 and 3), ``np_split_rhat`` and ``compare``
    give JAX's arrays bitwise on seeded AR(1)-like traces."""
    from icp_proposal_tpu_torch.tools import posterior_parity as pp

    jpp = jax_tools["posterior_parity"]
    rng = np.random.RandomState(5)
    x = np.cumsum(rng.randn(6, 301, 8), axis=1) * 0.1 + rng.randn(6, 301, 8)
    for max_lag in (500, 3):
        np.testing.assert_array_equal(pp.np_ess(x, max_lag), jpp.np_ess(x, max_lag))
    np.testing.assert_array_equal(pp.np_split_rhat(x), jpp.np_split_rhat(x))
    jcompare = _nested_function(REPO / "tools" / "posterior_parity.py", "main", "compare")
    a = {"label": "a", "posterior_mean_first8": rng.randn(8).tolist(),
         "mcse_first8": rng.rand(8).tolist()}
    b = {"label": "b", "posterior_mean_first8": rng.randn(8).tolist(),
         "mcse_first8": rng.rand(8).tolist()}
    assert pp.compare(a, b) == jcompare(a, b)


def test_chain_state_traces_is_bitwise_jax(jax_tools):
    from icp_proposal_tpu_torch.sampling.mh import ChainRecord
    from icp_proposal_tpu_torch.tools import quality_run as qr

    rng = np.random.RandomState(1)
    rec = ChainRecord(accepted=rng.rand(3, 7) > 0.5, proposal_idx=None, log_product=None,
                      named=None, coeffs=rng.randn(3, 7, 4).astype(np.float32))
    for got, want in zip(qr.chain_state_traces(rec),
                         jax_tools["quality_run"].chain_state_traces(rec)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_port_sampler_is_bitwise_jax(jax_tools):
    """The numpy sampler built from the JAX model and from the port's copy of
    it (same arrays), with the numpy id subsets and boundary masks: the same
    chain (trace and acceptance) for one seed, 40 steps on the sphere."""
    from icp_proposal_tpu_torch.tools import reference_baseline_port as rbp

    jrbp = jax_tools["reference_baseline_port"]
    data, jm = _sphere(jax_model=True)
    tpts = np.asarray(data.target.points)
    tcells = np.asarray(data.target.cells)
    np.testing.assert_array_equal(rbp.port_boundary_mask(tcells, len(tpts)),
                                  jrbp.port_boundary_mask(tcells, len(tpts)))
    np.testing.assert_array_equal(rbp.port_vertex_subset(162, 12, 1025),
                                  jrbp.port_vertex_subset(162, 12, 1025))
    runs = []
    for mod, model in ((rbp, data.model), (jrbp, jm)):
        sampler = mod.PortSampler(
            model, tpts, tcells, mod.port_boundary_mask(tcells, len(tpts)),
            mod.port_boundary_mask(np.asarray(jm.cells), 162),
            icp_model_ids=mod.port_vertex_subset(162, 2 * RANK, 1024),
            icp_target_ids=mod.port_vertex_subset(len(tpts), 2 * RANK, 1025),
            eval_ids=mod.port_vertex_subset(162, 4 * RANK, 1024))
        runs.append(sampler.run(40, seed=3, record_from=5, record_every=2)[:2])
    (trace, acc), (jtrace, jacc) = runs
    np.testing.assert_array_equal(trace, jtrace)
    assert acc == jacc and 0 < acc < 1


# ---------------------------------------------------------------------------
# mixing_sweep._setup against JAX's
# ---------------------------------------------------------------------------


def test_setup_matches_jax_for_every_config(jax_tools):
    """Every configuration of the sweep's grid (the JAX tool's, in its
    order): the same component names, weights, parity and adaptation as
    JAX's ``tools.mixing_sweep._setup`` on the sphere."""
    from icp_proposal_tpu.apps.femur import FemurData as JFemurData

    from icp_proposal_tpu_torch.tools import mixing_sweep as ms

    data, jm = _sphere(jax_model=True)
    jdata = JFemurData(model=jm, target=data.target, model_landmarks={},
                       target_landmarks={}, target_boundary_mask=data.target_boundary_mask,
                       model_boundary_mask=data.model_boundary_mask)
    grid = ms.grid()
    assert [label for label, _ in grid][:3] == [label for label, _ in ms.grid(quick=True)]
    assert len(grid) == 12
    for label, kw in grid:
        _, mix, ev = ms._setup(data, **kw)
        _, jmix, jev = jax_tools["mixing_sweep"]._setup(jdata, **kw)
        assert mix.names == jmix.names, label
        np.testing.assert_allclose(mix.weights, jmix.weights, rtol=1e-12, err_msg=label)
        assert mix.parity == jmix.parity, label
        assert (None if mix.adapt is None else vars(mix.adapt)) == (
            None if jmix.adapt is None else vars(jmix.adapt)), label
        np.testing.assert_array_equal(ev.model_ids("distance"), jev.model_ids("distance"))
        for i, comp in mix.icp_components.items():
            if hasattr(comp, "model_ids"):
                np.testing.assert_array_equal(comp.model_ids,
                                              jmix.icp_components[i].model_ids)


# ---------------------------------------------------------------------------
# validate_index against JAX's, JAX in an FMA-free child
# ---------------------------------------------------------------------------


def _jax_validate(queries_path, out_path):
    """Child: JAX's ``build_surface_index`` and ``validate_index`` on the
    stand-in target at ``EV_KS`` for each regime's queries."""
    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.ops.surface_index import build_surface_index, validate_index

    pts, cells = read_stl(ARTIFACTS / "posterior" / "map.stl")
    queries = dict(np.load(queries_path))
    rows = []
    for k in EV_KS:
        index = build_surface_index(np.asarray(pts, np.float32), np.asarray(cells), k=k)
        for regime, q in queries.items():
            err, rel, frac = validate_index(index, q, with_rel=True)
            rows.append({"k": k, "regime": regime, "max_abs_err_mm": err,
                         "max_rel_err": rel, "frac_mismatched": frac})
    Path(out_path).write_text(json.dumps(rows))


def test_validate_index_matches_jax(tmp_path):
    """The port's index (the stand-in target at K = 16 and 64, on the CPU
    twins of K3, K4 and K5) against JAX's ``validate_index`` on the same
    queries: the tool's ``perturbed_queries`` of each regime (2 states of
    the GPMM-50, the tool's default width; seed 1024); max_abs_err_mm
    within 1e-4, frac_mismatched equal."""
    from icp_proposal_tpu_torch.apps.femur import load_standin_femur_data
    from icp_proposal_tpu_torch.ops.surface_index import build_surface_index, validate_index
    from icp_proposal_tpu_torch.tools import validate_index as vi

    data = load_standin_femur_data(device="cpu", model_components=50)
    gen = torch.Generator().manual_seed(1024)
    queries = {name: vi.perturbed_queries(data, gen, n_states=2, **kw)
               for name, kw in vi.REGIMES.items()}
    np.savez(tmp_path / "q.npz", **queries)
    # the child builds JAX's index with its native builder, its default
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=str(REPO), **child_env())
    proc = subprocess.run([sys.executable, __file__, str(tmp_path / "q.npz"),
                           str(tmp_path / "jax.json")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads((tmp_path / "jax.json").read_text())
    pts, cells = np.asarray(data.target.points, np.float32), np.asarray(data.target.cells)
    indices = {k: build_surface_index(pts, cells, k=k, device="cpu") for k in EV_KS}
    mismatched = 0
    for w in want:
        err, _, frac = validate_index(indices[w["k"]], queries[w["regime"]], with_rel=True)
        assert abs(err - w["max_abs_err_mm"]) <= 1e-4, (w, err)
        assert frac == w["frac_mismatched"], (w, frac)
        mismatched += frac > 0
    assert [(w["k"], w["regime"]) for w in want] == [
        (k, r) for k in EV_KS for r in vi.REGIMES]
    assert mismatched  # the index misses faces somewhere: the comparison is not vacuous


# ---------------------------------------------------------------------------
# every tool's main: the JAX artifact's keys, nothing written under artifacts/
# ---------------------------------------------------------------------------


def _artifact_hashes():
    return {str(p.relative_to(ARTIFACTS)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(ARTIFACTS.rglob("*")) if p.is_file()}


def _keys(path):
    return json.loads((ARTIFACTS / path).read_text())


# the JAX tools' output keys where no artifact of the tool is committed
QUALITY_BFM_ROW_KEYS = {"samples", "chains", "rank", "elapsed_s", "wall_excludes_compile",
                        "samples_per_sec", "map_avg_distance_vs_full_target",
                        "map_hausdorff_vs_full_target", "best_log_product", "acceptance",
                        "ess_first8_mean", "ess_coeff0"}
CONVERGED_KEYS = {"devices", "mesh", "chains", "components", "setup", "init", "round_steps",
                  "rhat_target", "rounds", "converged", "converged_at_round",
                  "total_steps_run", "burn_in_discarded_steps", "trace", "diagnostics_via",
                  "total_wall_s", "host_split_rhat_max_first8_postburn",
                  "host_ess_first8_postburn", "host_ess_first8_mean",
                  "posterior_mean_coeffs_first8", "posterior_mean_coeffs_norm",
                  "posterior_sd_mean"}
CONVERGED_ROUND_KEYS = {"round", "steps", "collective_split_rhat_max_first8",
                        "collective_ess_coeff0", "pooled_acceptance", "wall_s"}


def _run_tool(name, monkeypatch, tmp_path):
    """The tool's main at a tiny size on the CPU → its output (read back
    from ``--out``)."""
    import importlib

    tool = importlib.import_module(f"icp_proposal_tpu_torch.tools.{name}")
    out = tmp_path / f"{name}.json"
    argv = ["--out", str(out)]
    if hasattr(tool, "femur_data") and name not in ("crossimpl_parity",
                                                     "reference_baseline_port"):
        monkeypatch.setattr(tool, "femur_data", lambda *a, **k: _sphere())
    if name == "validate_index":
        argv += ["--ks", "8"]
    elif name == "mixing_sweep":
        argv += ["--quick", "--chains", "4", "--steps", "20"]
    elif name == "posterior_parity":
        argv += ["--chains", "4", "--steps", "40", "--segment", "15", "--thin", "2"]
    elif name == "quality_run":
        argv += ["--chains", "4", "--samples", "50"]
    elif name == "quality_bfm":
        argv += ["--chains", "4", "--samples", "30", "--rank", "6"]
    elif name == "converged_run":
        argv += ["--chains", "8", "--round-steps", "30", "--max-rounds", "2",
                 "--segment-steps", "10", "--diag-max-lag", "20"]
    elif name == "reference_baseline_port":
        argv += ["--components", "50", "--steps", "3"]
    elif name == "crossimpl_parity":
        # the numpy chains in this process (the pool's worker function), cached
        cfg = (50, 12, 2, 2)
        data = tool.femur_data(50, device="cpu")
        chains = {s: tool._run_port_chain((data, *cfg[1:], s)) for s in (1000, 1001)}
        cache = tmp_path / "cache.npz"
        tool.save_cache(cache, np.asarray(cfg), tool.fingerprint(data.model), chains)
        argv += ["--port-cache", str(cache), "--port-chains", "2", "--steps", "12",
                 "--burn", "2", "--thin", "2", "--chains", "4"]
    if name != "reference_baseline_port":
        argv += ["--device", "cpu"]
    tool.main(argv)
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", ["validate_index", "mixing_sweep", "posterior_parity",
                                  "quality_run", "quality_bfm", "converged_run",
                                  "reference_baseline_port", "crossimpl_parity"])
def test_tool_main_schema_and_no_writes(name, monkeypatch, tmp_path):
    """The tool's ``main`` on the CPU at a tiny size (the femur tools on the
    sphere, the numpy sampler and its check on the stand-in GPMM-50; at
    most 8 chains × 50 steps): its JSON has the JAX artifact's keys, its
    extra files lie beside ``--out``, and no file under ``artifacts/``
    changes."""
    before = _artifact_hashes()
    out = _run_tool(name, monkeypatch, tmp_path)
    assert _artifact_hashes() == before
    if name == "validate_index":
        assert [set(r) for r in out] == [set(_keys("index_validation.json")[0])] * 4
        assert [r["regime"] for r in out] == ["prior-s1.0", "prior-s2.5", "random-init",
                                              "far-init"]
    elif name == "mixing_sweep":
        want = _keys("mixing_sweep.json")
        assert [set(r) for r in out] == [set(want[0])] * 3
        assert [r["label"] for r in out] == [r["label"] for r in want[:3]]
        assert set(out[1]["per_component"]) == set(want[1]["per_component"])
    elif name == "posterior_parity":
        want = _keys("posterior_parity.json")
        assert set(out) == set(want)
        assert [set(r) for r in out["runs"]] == [set(r) for r in want["runs"]]
        assert [r["label"] for r in out["runs"]] == [r["label"] for r in want["runs"]]
        assert [set(c) for c in out["comparisons"]] == [set(c) for c in want["comparisons"]]
        assert [c["pair"] for c in out["comparisons"]] == [c["pair"]
                                                           for c in want["comparisons"]]
    elif name == "quality_run":
        want = _keys("quality_femur.json")
        assert set(out) == set(want) | {"recommended_by_ess_per_wall_second"}
        assert {k: set(r) for k, r in out["rows"].items()} == {
            k: set(r) for k, r in want["rows"].items()}
        assert set(out["index_check"]) == set(want["index_check"])
        assert out["recommended_by_ess_per_wall_second"] in out["rows"]
        assert sorted(p.name for p in (tmp_path / "posterior").iterdir()) == [
            "map.stl", "mean.stl", "variability_normal.ply", "variability_total.ply"]
        assert (tmp_path / "quality_femur_chain.json").is_file()
    elif name == "quality_bfm":
        assert set(out) == {"workload", "density", "rows"}
        assert {k: set(r) for k, r in out["rows"].items()} == {
            "complete": QUALITY_BFM_ROW_KEYS, "partial": QUALITY_BFM_ROW_KEYS}
    elif name == "converged_run":
        assert set(out) == CONVERGED_KEYS
        assert [set(r) for r in out["rounds"]] == [CONVERGED_ROUND_KEYS] * 2
        # one process: the pooled R-hat of round 1 is the host R-hat of its traces
        np.testing.assert_allclose(out["rounds"][1]["collective_split_rhat_max_first8"],
                                   out["host_split_rhat_max_first8_postburn"], rtol=1e-4)
    elif name == "reference_baseline_port":
        assert set(out) == set(_keys("cpu_baseline.json"))
        assert out["threads"] == {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    else:
        want = _keys("posterior_parity_crossimpl.json")
        # the committed artifact carries two notes written by hand
        assert set(out) == set(want) - {"self_control", "acceptance_note"}
        assert set(out["config"]) == set(want["config"])
        assert set(out["port"]) == set(want["port"]) and set(out["jax"]) == set(want["jax"])


def test_crossimpl_cache_needs_the_same_basis(tmp_path):
    """Cached numpy chains are reused only for the configuration and the
    model basis they were sampled on."""
    from icp_proposal_tpu_torch.tools import crossimpl_parity as cx

    cfg, fp = np.asarray([50, 12, 2, 2]), np.arange(4.0)
    chains = {1000: (np.ones(4), np.ones(4), 0.5)}
    cx.save_cache(tmp_path / "c.npz", cfg, fp, chains)
    path = tmp_path / "c.npz"
    assert set(cx._load_cache([path], cfg, fp)) == {1000}
    assert cx._load_cache([path], cfg, fp[::-1]) == {}
    assert cx._load_cache([path], cfg + 1, fp) == {}


def test_crossimpl_refuses_a_cache_under_artifacts():
    from icp_proposal_tpu_torch.tools import crossimpl_parity

    before = _artifact_hashes()
    with pytest.raises(ValueError, match="artifacts"):
        crossimpl_parity.main(["--port-cache", str(ARTIFACTS / "crossimpl_port_moments.npz"),
                               "--device", "cpu"])
    assert _artifact_hashes() == before


if __name__ == "__main__":
    inject_from_env()
    _jax_validate(sys.argv[1], sys.argv[2])
