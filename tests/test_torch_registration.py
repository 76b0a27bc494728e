"""The registration slice: JSON chain logs, MAP extraction, diagnostics,
mesh metrics and winding numbers against the JAX package on the same
seeded data, and the port's ``runfitting`` on the CPU (stand-in
femur GPMM-100, rank 101)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.sampling import loggers as ploggers
from icp_proposal_tpu_torch.sampling import mh as pmh

NAMED_KEYS = ["product", "prior", "distance"]
PROPOSALS = ["IcpProposal-TargetSampling-0.1Step", "IcpProposal-ModelSampling-0.1Step",
             "RandomShape-0.1"]


def _records(rng, c, t, r=6):
    """Seeded stacked records [c, t, ...] as host arrays, in both packages'
    ``ChainRecord``."""
    from icp_proposal_tpu.sampling import mh as jmh

    fields = dict(
        accepted=rng.rand(c, t) < 0.4,
        proposal_idx=rng.randint(0, 2, (c, t)).astype(np.int32),  # no RandomShape
        log_product=rng.randn(c, t).astype(np.float32) * 10 - 500,
        named=rng.randn(c, t, 3).astype(np.float32),
        coeffs=rng.randn(c, t, r).astype(np.float32),
        pose=rng.randn(c, t, 9).astype(np.float32),
    )
    return jmh.ChainRecord(**fields), pmh.ChainRecord(**fields)


def _one_chain(rec, chain=0):
    return type(rec)(*(None if x is None else x[chain] for x in rec))


def test_json_log_utilities_match_jax(tmp_path):
    """records_to_json_list (all but the timestamp), write/load, the best
    record, best/last resume states, thinning and acceptance summaries."""
    from icp_proposal_tpu.sampling import loggers as jloggers

    jrec, prec = _records(np.random.RandomState(0), 1, 300)
    jl = jloggers.records_to_json_list(_one_chain(jrec), NAMED_KEYS, PROPOSALS, 7)
    pl = ploggers.records_to_json_list(_one_chain(prec), NAMED_KEYS, PROPOSALS, 7)
    for a, b in zip(jl, pl, strict=True):
        a.pop("datetime")
        assert set(b.pop("datetime")) <= set("0123456789-: ")
        assert a == b
    assert [r["index"] for r in pl] == list(range(7, 307))
    assert all(r["rigid"] == [] and r["coeff"] == [] for r in pl if not r["status"])

    path = tmp_path / "log.json"
    ploggers.write_log(path, pl)
    log = ploggers.load_log(path)
    assert log == json.loads(path.read_text()) == pl
    assert ploggers.best_fitting_record(log) == jloggers.best_fitting_record(log)
    for mode in ("best", "last"):
        js = jloggers.state_from_log(log, mode)
        ps = ploggers.state_from_log(log, mode, device="cpu")
        for name in ("scale", "rot", "trans", "center", "coeffs"):
            got = getattr(ps, name)
            assert got.shape[0] == 1
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(getattr(js, name)))
    with pytest.raises(ValueError, match="resume mode"):
        ploggers.state_from_log(log, "first", device="cpu")
    with pytest.raises(ValueError, match="no accepted"):
        ploggers.best_fitting_record([r for r in log if not r["status"]])
    for every, burn in ((50, 100), (7, 3)):
        assert (ploggers.samples_from_log(log, every, burn_in=burn)
                == jloggers.samples_from_log(log, every, burn_in=burn))
    ja = jloggers.acceptance_summary(_one_chain(jrec), PROPOSALS)
    pa = ploggers.acceptance_summary(_one_chain(prec), PROPOSALS)
    assert ja.keys() == pa.keys()
    np.testing.assert_array_equal(list(pa.values()), list(ja.values()))  # NaN included


def test_extract_best_matches_jax():
    """The same chain, step and value as the JAX package's ``_extract_best``."""
    from icp_proposal_tpu.registration.sampling_registration import (
        SamplingRegistration as JReg,
    )
    from icp_proposal_tpu_torch.registration.sampling_registration import extract_best

    jrec, prec = _records(np.random.RandomState(1), 8, 40)
    jstate, jval = JReg._extract_best(None, jrec)
    state, val, (c, t) = extract_best(prec, torch.device("cpu"))
    assert val == jval == float(prec.log_product[c, t])
    np.testing.assert_array_equal(state.coeffs[0].numpy(), np.asarray(jstate.coeffs))
    np.testing.assert_array_equal(state.coeffs[0].numpy(), prec.coeffs[c, t])
    for name in ("scale", "rot", "trans", "center"):
        np.testing.assert_array_equal(getattr(state, name)[0].numpy(),
                                      np.asarray(getattr(jstate, name)))
    none = prec._replace(accepted=np.zeros_like(prec.accepted))
    with pytest.raises(ValueError, match="no accepted sample"):
        extract_best(none, torch.device("cpu"))


def test_diagnostics_match_jax():
    """split-R̂ and ESS on seeded AR(1) chains [8, 200, 5], to rtol 1e-5."""
    from icp_proposal_tpu.sampling import diagnostics as jdiag
    from icp_proposal_tpu_torch.sampling import diagnostics as pdiag

    rng = np.random.RandomState(2)
    x = np.zeros((8, 200, 5), np.float32)
    phi = np.array([0.0, 0.5, 0.9, 0.97, 0.2], np.float32)
    for t in range(1, 200):
        x[:, t] = phi * x[:, t - 1] + rng.randn(8, 5).astype(np.float32)
    x += rng.randn(8, 1, 5).astype(np.float32) * 0.3  # some between-chain spread
    np.testing.assert_allclose(pdiag.split_rhat(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.jit(jdiag.split_rhat)(x)), rtol=1e-5)
    np.testing.assert_allclose(pdiag.ess(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.jit(jdiag.ess)(x)), rtol=1e-5)
    acc = rng.rand(8, 200) < 0.3
    np.testing.assert_allclose(float(pdiag.pooled_acceptance(torch.as_tensor(acc))),
                               float(jdiag.pooled_acceptance(jnp.asarray(acc))), rtol=1e-6)


@pytest.fixture(scope="module")
def meshes():
    """(port meshes, JAX meshes): mean.stl and map.stl, and a seeded
    boundary mask on map.stl (the meshes are closed, so a real mask would
    exclude nothing)."""
    from icp_proposal_tpu.mesh import make_mesh as jmake_mesh
    from icp_proposal_tpu_torch.apps.femur import STANDIN_DIR
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.mesh import make_mesh

    mp, mc = read_stl(STANDIN_DIR / "mean.stl")
    tp, tc = read_stl(STANDIN_DIR / "map.stl")
    mask = np.random.RandomState(3).rand(len(tp)) < 0.1
    return ((make_mesh(mp, mc), make_mesh(tp, tc)),
            (jmake_mesh(mp, mc), jmake_mesh(tp, tc)), mask)


def test_metrics_match_jax(meshes):
    """avg, Hausdorff and the boundary-aware (avg, max) of mean.stl against
    map.stl, through K5's plain version, to rtol 1e-5."""
    from icp_proposal_tpu.ops import metrics as jm
    from icp_proposal_tpu_torch.ops import metrics as pm

    (a, b), (ja, jb), mask = meshes
    np.testing.assert_allclose(float(pm.avg_distance(a, b, device="cpu")),
                               float(jm.avg_distance(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(pm.hausdorff_distance(a, b, device="cpu")),
                               float(jm.hausdorff_distance(ja, jb)), rtol=1e-5)
    got = pm.avg_and_max_distance_boundary_aware(a, b, mask, device="cpu")
    want = jm.avg_and_max_distance_boundary_aware(ja, jb, jnp.asarray(mask))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                               rtol=1e-5)
    # meshes held as tensors run where the tensors lie
    ta = a._replace(points=torch.as_tensor(a.points), cells=torch.as_tensor(a.cells))
    assert float(pm.avg_distance(ta, b)) == float(pm.avg_distance(a, b, device="cpu"))


def test_winding_numbers_and_dice_match_jax(meshes):
    """Winding numbers of points near and off map.stl to atol 1e-4; the
    voxel Dice of two offset spheres as in the JAX package; the Monte-Carlo
    Dice of a mesh with itself is 1."""
    from icp_proposal_tpu.mesh import make_mesh as jmake_mesh
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu.ops import inside as jinside
    from icp_proposal_tpu.ops import metrics as jm
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.ops import inside as pinside
    from icp_proposal_tpu_torch.ops import metrics as pm

    (a, b), _, _ = meshes
    rng = np.random.RandomState(4)
    q = (a.points[rng.randint(0, len(a.points), 300)]
         + rng.randn(300, 3).astype(np.float32) * 5.0).astype(np.float32)
    tri = b.points[b.cells]
    w = pinside.winding_numbers(torch.as_tensor(q), torch.as_tensor(tri)).numpy()
    np.testing.assert_allclose(w, np.asarray(jinside.winding_numbers(q, tri)), atol=1e-4)
    assert 0 < pinside.points_inside(torch.as_tensor(q), torch.as_tensor(tri)).sum() < 300

    sp, sc = make_icosphere(subdivisions=2, radius=10.0)
    sp = np.asarray(sp, np.float32)
    s1, s2 = make_mesh(sp, sc), make_mesh(sp + np.float32(4.0), sc)
    np.testing.assert_allclose(
        float(pm.dice_coefficient_voxel(s1, s2, grid_n=12, chunk=500, device="cpu")),
        float(jm.dice_coefficient_voxel(jmake_mesh(sp, sc), jmake_mesh(sp + 4.0, sc),
                                        grid_n=12, chunk=500)), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    assert float(pm.dice_coefficient(s1, s1, gen, n_samples=2000, device="cpu")) == 1.0


def test_state_helpers_match_jax():
    """init_state with given coefficients and center, flat_parameters and
    transformed_mesh against the JAX package's."""
    from icp_proposal_tpu.sampling import state as jstate
    from icp_proposal_tpu_torch.convert import gpmm_from_arrays
    from icp_proposal_tpu_torch.sampling import state as pstate

    rng = np.random.RandomState(5)
    v, r = 12, 4
    model = dict(ref_points=rng.randn(v, 3).astype(np.float32),
                 cells=np.array([[0, 1, 2], [2, 3, 4]], np.int32),
                 mean_disp=rng.randn(v, 3).astype(np.float32) * 0.1,
                 basis=rng.randn(v, 3, r).astype(np.float32),
                 variance=np.ones(r, np.float32), noise_variance=np.float32(0.0))
    pm_ = gpmm_from_arrays(**model, sbasis=model["basis"], coeff_chol=np.eye(r),
                           device="cpu")
    from icp_proposal_tpu.models.gpmm import make_gpmm

    jm_ = make_gpmm(model["ref_points"], model["cells"], model["mean_disp"],
                    model["basis"], model["variance"])
    coeffs, center = rng.randn(r).astype(np.float32), rng.randn(3).astype(np.float32)
    ps = pstate.init_state(pm_, 3, coeffs=coeffs, center=center)
    js = jstate.init_state(jm_, coeffs=coeffs, center=center)
    ps = ps._replace(rot=torch.as_tensor(np.tile([0.1, -0.2, 0.3], (3, 1)),
                                         dtype=torch.float32))
    js = js._replace(rot=np.asarray([0.1, -0.2, 0.3], np.float32))
    flat = pstate.flat_parameters(ps)
    assert flat.shape == (3, 1 + 9 + r)
    np.testing.assert_array_equal(flat[2].numpy(), np.asarray(jstate.flat_parameters(js)))
    mesh = pstate.transformed_mesh(pm_, ps, chain=1)
    np.testing.assert_allclose(mesh.points.numpy(),
                               np.asarray(jstate.transformed_mesh(jm_, js).points),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(mesh.cells, pm_.cells)


@pytest.fixture(scope="module")
def standin():
    from icp_proposal_tpu_torch.apps.femur import load_standin_femur_data

    return load_standin_femur_data(device="cpu")


def _run(standin, tmp_path, name, **kw):
    from icp_proposal_tpu_torch.apps.femur import run_icp_proposal_registration

    path = tmp_path / f"{name}.json"
    result, _ = run_icp_proposal_registration(
        setup="flagship", n_chains=4, data=standin, accept_info_interval=3,
        json_path=str(path), seed=11, verbose=False, device="cpu", **kw)
    return result, path


def test_runfitting_is_deterministic_and_logs(standin, tmp_path):
    """Two runs of 2 segments × 3 steps from one seed agree bitwise; chain
    0's JSON log has one record per step."""
    r1, p1 = _run(standin, tmp_path, "a", num_samples=6)
    r2, _ = _run(standin, tmp_path, "b", num_samples=6)
    for x, y in zip(r1.records, r2.records):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert r1.records.coeffs.shape == (4, 6, 101) and r1.records.pose.shape == (4, 6, 9)
    assert torch.equal(r1.final_states.coeffs, r2.final_states.coeffs)
    assert r1.best_log_value == r2.best_log_value and np.isfinite(r1.best_log_value)
    log = ploggers.load_log(p1)
    assert len(log) == len(r1.json_records) == 6
    assert [rec["status"] for rec in log] == r1.records.accepted[0].tolist()
    assert r1.samples_per_sec > 0 and 0 <= r1.acceptance["overall"] <= 1
    # the records hold the post-step state: the final state is the last one
    np.testing.assert_array_equal(r1.records.coeffs[:, -1], r1.final_states.coeffs.numpy())


def test_runfitting_resumes_from_the_last_accepted_state(standin, tmp_path):
    """resume_mode="last" starts every chain from chain 0's last accepted
    record; an explicit initial state wins over the log."""
    from icp_proposal_tpu_torch.apps.femur import make_icp_proposal_setup
    from icp_proposal_tpu_torch.registration.sampling_registration import (
        SamplingRegistration,
    )
    from icp_proposal_tpu_torch.sampling.state import init_state

    first, path = _run(standin, tmp_path, "first", num_samples=6)
    acc0 = first.records.accepted[0]
    assert acc0.any()
    last = int(np.nonzero(acc0)[0][-1])
    resumed, _ = _run(standin, tmp_path, "resumed", num_samples=3, resume_log=str(path),
                      resume_mode="last")
    start = resumed.initial_state
    assert start.coeffs.shape == (4, 101)
    for c in range(4):
        np.testing.assert_array_equal(start.coeffs[c].numpy(), first.records.coeffs[0, last])
        np.testing.assert_array_equal(
            torch.cat([start.trans[c], start.rot[c], start.center[c]]).numpy(),
            first.records.pose[0, last])
    _, mixture, evaluator = make_icp_proposal_setup(standin)
    reg = SamplingRegistration(standin.model, standin.target, mixture, evaluator,
                               verbose=False)
    explicit = init_state(standin.model, 1)
    given = reg.runfitting(3, n_chains=4, initial_state=explicit, resume_log=str(path),
                           resume_mode="last")
    assert torch.equal(given.initial_state.coeffs, explicit.coeffs.expand(4, -1))


def test_femur_cli_runs_on_the_cpu(tmp_path, capsys):
    """``python -m icp_proposal_tpu_torch.apps.femur proposal ...`` on the
    CPU: the reference's progress and reconstruction lines, and the log;
    ``--setup`` takes hybrid, mala and rw-adapt as well; the ``icp`` mode
    runs the deterministic ICP (``--iterations 3``) on the stand-in
    GPMM-50 with the reference's timing and reconstruction lines."""
    from icp_proposal_tpu_torch.apps import femur

    log = tmp_path / "cli.json"
    femur.main(["proposal", "--samples", "2", "--chains", "2", "--setup", "flagship",
                "--json", str(log), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[2/2] chains=2" in out and "ID: SAMPLE average2surface:" in out
    assert len(ploggers.load_log(log)) == 2
    for setup in ("hybrid", "mala", "rw-adapt"):
        log = tmp_path / f"{setup}.json"
        femur.main(["proposal", "--samples", "2", "--chains", "4", "--setup", setup,
                    "--json", str(log), "--device", "cpu"])
        assert "[2/2] chains=4" in capsys.readouterr().out
        assert len(ploggers.load_log(log)) == 2
    femur.main(["icp", "--iterations", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ICP-Timing:" in out and "ID: SAMPLE average2surface:" in out


def test_runfitting_carries_adaptation_across_segments():
    """``runfitting`` in segments of 2 steps carries MALA's gradient anchors
    and the adaptive log-scales and step counts from one segment to the
    next: 6 steps of 3 chains equal, record for record, the port's own step
    loop from the same carry (one chain's, repeated, as ``runfitting``
    builds it) and seed."""
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu_torch.registration.sampling_registration import (
        SamplingRegistration,
        _expand,
    )
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu_torch.sampling.proposals import (
        AdaptConfig,
        MalaSpec,
        MixtureProgram,
        RandomShapeSpec,
    )
    from icp_proposal_tpu_torch.sampling.state import init_state

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0, device="cpu")
    alpha = torch.tensor([1.5, -1.0, 0.0, 0.0, 0.0, 0.0])
    target = make_mesh(instance_points(model, alpha).numpy(), model.cells.numpy())
    ctx = build_target_context(target, device="cpu")
    evaluator = proximity_and_independent(model, ctx, sigma=1.0, n_points=60)
    mixture = MixtureProgram([(0.5, MalaSpec(0.3)), (0.5, RandomShapeSpec(0.2))], model,
                             ctx, np.zeros(model.num_points, bool), adapt=AdaptConfig())
    reg = SamplingRegistration(model, target, mixture, evaluator, accept_info_interval=2,
                               verbose=False)
    result = reg.runfitting(6, seed=9, n_chains=3)

    step = pmh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry = _expand(pmh.init_carry(model, evaluator, init_state(model, 1), mixture), 3)
    carry, recs = pmh.run_chains(step, carry, 6, torch.Generator().manual_seed(9))
    want = pmh.stack_records(recs)
    for got, w in zip(result.records, want):
        if w is not None:
            np.testing.assert_array_equal(got, w.numpy())
    assert torch.equal(result.final_states.coeffs, carry.state.coeffs)
    assert float(carry.step_idx[0]) == 6.0 and bool((carry.adapt_log_scales != 0).any())
