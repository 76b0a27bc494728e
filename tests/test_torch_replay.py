"""The port's chain replay, posterior analysis and variability maps against
the JAX package's, on the CPU.

Both packages read the same JSON records: the 600-step log of JAX's own
``test_posterior_variability_and_replay`` (a rank-4 GPMM on a subdivision-1
icosphere of radius 50, random-shape walk, Euclidean evaluator).  The port
decodes the replayed states as one batch where JAX decodes them one by one,
so points and maps are held within rtol 1e-5 and atol 1e-4 times the
largest magnitude of the quantity (the coordinates' scale for points, the
map's for maps); state counts, file names and everything read from the log
are exact.
"""
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert

RTOL = 1e-5


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=1e-4 * max(np.abs(want).max(), 1e-12), err_msg=err_msg)


@pytest.fixture(scope="module")
def chain():
    """(JAX model, port model on the CPU, JAX's JSON records): JAX's test's
    model, target, mixture, evaluator and 600 steps from PRNGKey(0)."""
    from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask
    from icp_proposal_tpu.models import gpmm as gp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu.sampling import loggers, mh
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import IndependentPointsSpec, build_evaluator
    from icp_proposal_tpu.sampling.proposals import MixtureProgram, RandomShapeSpec
    from icp_proposal_tpu.sampling.state import init_state

    points, cells = make_icosphere(subdivisions=1, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=4)
    target = TriangleMesh(points=gp.instance_points(model, jnp.ones(4) * 0.5),
                          cells=model.cells)
    ctx = build_target_context(target)
    mixture = MixtureProgram([(1.0, RandomShapeSpec(sigma=0.3))], model, ctx,
                             jnp.asarray(boundary_vertex_mask(np.asarray(cells), len(points))))
    evaluator = build_evaluator(model, ctx, [IndependentPointsSpec(sigma=1.0, n_points=12)])
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry = mh.init_carry(model, evaluator, init_state(model), mixture)
    _, records = mh.run_chain(step, carry, jax.random.PRNGKey(0), 600)
    recs = loggers.records_to_json_list(records, evaluator.named_keys, mixture.names)
    recs = json.loads(json.dumps(recs))  # as a log file holds them
    pmodel = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                         model._asdict().items()}, device="cpu")
    return model, pmodel, recs


def test_replay_states_and_meshes_match_jax(chain):
    """``replay_states`` rebuilds JAX's states from the log (one-chain
    states, the same values); ``replay_meshes`` at JAX's test's stride (6
    snapshots) and at stride 7 gives JAX's meshes within tolerance."""
    from icp_proposal_tpu.analysis.replay import replay_meshes as jreplay_meshes
    from icp_proposal_tpu.analysis.replay import replay_states as jreplay_states
    from icp_proposal_tpu_torch.analysis.replay import replay_meshes, replay_states

    jmodel, model, recs = chain
    states, jstates = replay_states(recs, 7, device="cpu"), jreplay_states(recs, 7)
    assert len(states) == len(jstates) > 50
    for s, js in zip(states, jstates):
        for name in ("scale", "rot", "trans", "center", "coeffs"):
            got = getattr(s, name)
            assert got.shape[0] == 1
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(getattr(js, name)))
    for stride in (100, 7):
        meshes, jmeshes = replay_meshes(model, recs, stride), jreplay_meshes(jmodel, recs,
                                                                            stride)
        assert len(meshes) == len(jmeshes) == (6 if stride == 100 else len(states))
        assert meshes[0].shape == (model.num_points, 3)
        _close(np.stack(meshes), np.stack(jmeshes), f"stride {stride}")


def test_posterior_analysis_matches_jax(chain, tmp_path):
    """``posterior_analysis`` at JAX's test's burn-in 100 and thinning 20:
    the same number of samples; MAP, mean and both maps within tolerance;
    JAX's own assertions hold for the port (non-negative total map, normal
    map below it, the same four files)."""
    from icp_proposal_tpu.analysis.replay import posterior_analysis as jposterior
    from icp_proposal_tpu_torch.analysis.replay import posterior_analysis

    jmodel, model, recs = chain
    out = posterior_analysis(model, recs, burn_in=100, take_every_n=20,
                             out_dir=str(tmp_path / "port"))
    want = jposterior(jmodel, recs, burn_in=100, take_every_n=20,
                      out_dir=str(tmp_path / "jax"))
    assert out["num_samples"] == want["num_samples"] > 5
    for key in ("map_points", "mean_points", "variability_total", "variability_normal"):
        assert out[key].shape == np.asarray(want[key]).shape, key
        _close(out[key], want[key], key)
    assert out["variability_total"].shape == (model.num_points,)
    assert (out["variability_total"] >= 0).all()
    assert (out["variability_normal"] <= out["variability_total"] + 1e-5).all()
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    with pytest.raises(ValueError, match="no accepted samples"):
        posterior_analysis(model, recs, burn_in=len(recs))


def test_variability_maps_population_variance():
    """The maps are population statistics (divisor S, as ``jnp.var``): on 3
    samples the port's maps equal JAX's and a float64 numpy reference with
    ``ddof=0``; ``torch.var``'s default (divisor S − 1) would be 1.5 times
    larger.  Normals from a reference mesh (``use_mean_normals=False``) too."""
    from icp_proposal_tpu.analysis import posterior_variability as jpv
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu_torch.analysis import (
        variability_map_normal,
        variability_map_total,
    )
    from icp_proposal_tpu_torch.mesh import vertex_normals

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    rng = np.random.RandomState(3)
    samples = (points[None] + rng.randn(3, len(points), 3).astype(np.float32)).astype(
        np.float32)
    ref = points + rng.randn(*points.shape).astype(np.float32) * 0.1
    x = torch.as_tensor(samples)
    total = variability_map_total(x).numpy()
    normal = variability_map_normal(x, cells).numpy()
    normal_ref = variability_map_normal(x, cells, use_mean_normals=False,
                                        reference_points=ref).numpy()
    _close(total, jpv.variability_map_total(jnp.asarray(samples)), "total")
    _close(normal, jpv.variability_map_normal(jnp.asarray(samples), cells), "normal")
    _close(normal_ref, jpv.variability_map_normal(
        jnp.asarray(samples), cells, use_mean_normals=False, reference_points=ref),
        "normal, reference normals")

    s64 = samples.astype(np.float64)
    np.testing.assert_allclose(total, (s64.var(axis=0, ddof=0)).sum(-1), rtol=1e-4)
    normals = vertex_normals(x.mean(0), torch.as_tensor(cells).long()).double().numpy()
    proj = np.einsum("svi,vi->sv", s64 - s64.mean(0), normals)
    np.testing.assert_allclose(normal, proj.var(axis=0, ddof=0), rtol=1e-4, atol=1e-6)
    assert np.all(np.abs(normal - proj.var(axis=0, ddof=1)) > 0.1 * proj.var(axis=0, ddof=0))


def _read_ply_fields(path):
    """A scalar-field PLY → (header lines without the range comment,
    points, colours, values, faces)."""
    lines = Path(path).read_text().splitlines()
    end = lines.index("end_header")
    header = [l for l in lines[:end + 1] if not l.startswith("comment")]
    n_vert = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
    rows = np.array([l.split() for l in lines[end + 1:end + 1 + n_vert]], np.float64)
    faces = np.array([l.split() for l in lines[end + 1 + n_vert:]], np.int64)
    return header, rows[:, :3], rows[:, 3:6], rows[:, 6], faces


def _assert_same_files(port_dir, jax_dir):
    """The same file names; STL meshes (read back) and scalar-field PLYs
    (header, faces exactly; points and values within tolerance; colours
    within one step of the ramp) as JAX's."""
    from icp_proposal_tpu_torch.io.stl import read_stl

    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        got, want = port_dir / name, jax_dir / name
        if name.endswith(".stl"):
            (gp, gc), (wp, wc) = read_stl(got), read_stl(want)
            assert gp.shape == wp.shape
            np.testing.assert_array_equal(gc, wc)
            _close(gp, wp, name)
        else:
            g, w = _read_ply_fields(got), _read_ply_fields(want)
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[4], w[4])
            _close(g[1], w[1], name)
            assert np.abs(g[2] - w[2]).max() <= 1, name
            _close(g[3], w[3], name)


def _femur_dir(tmp_path, jmodel, components):
    """A femur asset directory in the reference's layout around a model:
    the statismo file, the model's and the target's landmarks, the target
    (the mean shape moved rigidly)."""
    from icp_proposal_tpu.io.landmarks import write_landmarks
    from icp_proposal_tpu.io.statismo import write_statismo_gpmm
    from icp_proposal_tpu.io.stl import write_stl

    d = tmp_path / "femur"
    os.makedirs(d)
    write_statismo_gpmm(d / f"femur_gp_model_{components}-components.h5", jmodel)
    pts = np.asarray(jmodel.ref_points)
    lms = {f"lm{i}": pts[v].astype(np.float64) for i, v in enumerate((0, 5, 17, 33))}
    write_landmarks(d / "femur_reference.json", lms)
    write_landmarks(d / "femur_target.json", {k: v + 2.0 for k, v in lms.items()})
    write_stl(d / "femur_target.stl", pts + 2.0, np.asarray(jmodel.cells))
    return d


def test_replay_cli_writes_jax_files(chain, tmp_path, monkeypatch):
    """The port's replay CLI (``replay`` and ``posterior``, ``--data-dir``
    on a directory holding the model as ``femur_gp_model_4-components.h5``,
    ``--device cpu``) writes the files that JAX's ``replay_meshes`` (written
    as the JAX CLI writes them) and ``posterior_analysis`` write for the model
    read from the same file and the same log."""
    from icp_proposal_tpu.analysis.replay import posterior_analysis as jposterior
    from icp_proposal_tpu.analysis.replay import replay_meshes as jreplay_meshes
    from icp_proposal_tpu.io.statismo import read_statismo_gpmm
    from icp_proposal_tpu.io.stl import write_stl
    from icp_proposal_tpu_torch.apps import replay as pcli

    jmodel, _, recs = chain
    data_dir = _femur_dir(tmp_path, jmodel, 4)
    log = tmp_path / "chain.json"
    log.write_text(json.dumps(recs))
    common = ["--components", "4", "--data-dir", str(data_dir), "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["replay", "replay", str(log), "--stride", "37",
                                      "--max-snapshots", "5", "--out-dir",
                                      str(tmp_path / "port_replay"), *common])
    pcli.main()
    pcli.main(["posterior", str(log), "--burn-in", "100", "--take-every", "20",
               "--out-dir", str(tmp_path / "port_posterior"), *common])

    model = read_statismo_gpmm(data_dir / "femur_gp_model_4-components.h5")
    os.makedirs(tmp_path / "jax_replay")
    for i, pts in enumerate(jreplay_meshes(model, recs, stride=37)[:5]):
        write_stl(tmp_path / "jax_replay" / f"replay_{i:05d}.stl", pts,
                  np.asarray(model.cells))
    jposterior(model, recs, burn_in=100, take_every_n=20,
               out_dir=str(tmp_path / "jax_posterior"))
    assert len(os.listdir(tmp_path / "jax_replay")) == 5
    for name in ("replay", "posterior"):
        _assert_same_files(tmp_path / f"port_{name}", tmp_path / f"jax_{name}")
