"""The BFM face slice of the port against the JAX package, at a small size
(rank 12, subdivision 2: 127 vertices, 232 faces): the host copies, the
evaluators and the pose proposal densities.  The MH step itself is held to
the JAX step in ``test_torch_bfm_step.py``.

The JAX side forces its kernels (``ICP_TPU_FORCE_PALLAS=1``,
``ICP_TPU_FORCE_CHOL_PALLAS=1``: interpret mode, shortlist index on); the
port runs its plain twins on the CPU and builds its data from the JAX
arrays through ``convert.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.apps import bfm as pbfm
from icp_proposal_tpu_torch.sampling import evaluators as pev
from icp_proposal_tpu_torch.sampling import proposals as pprop

RANK, SUBDIV = 12, 2
N_CHAINS = 4


@pytest.fixture
def kernels_forced(monkeypatch):
    monkeypatch.setenv("ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    monkeypatch.setenv("ICP_TPU_NO_NATIVE", "1")
    # the JAX package caches its native library once any test loads it;
    # drop that cache too, so the numpy index build runs in every order
    monkeypatch.setattr("icp_proposal_tpu.native._lib", None)


@pytest.fixture(scope="module")
def jdata():
    from icp_proposal_tpu.apps import bfm as jbfm

    return jbfm.load_synthetic_face_data(rank=RANK, subdiv=SUBDIV)


def _jax_target_coeffs(seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (RANK,)) * 0.8)


def _port_data(jdata):
    return convert.bfm_data_from_arrays(
        {k: np.asarray(v) for k, v in jdata.model._asdict().items()},
        jdata.target.points, jdata.target.cells, jdata.target_partial.points,
        jdata.target_partial.cells, jdata.model_boundary_mask,
        jdata.target_boundary_mask, jdata.partial_boundary_mask, device="cpu")


def _pair_states(r, seed):
    """A batch of states with pose, scale and shape set (numpy arrays)."""
    rng = np.random.RandomState(seed)
    return dict(
        scale=(1.0 + 0.02 * rng.randn(N_CHAINS)).astype(np.float32),
        rot=(0.05 * rng.randn(N_CHAINS, 3)).astype(np.float32),
        trans=(0.003 * rng.randn(N_CHAINS, 3)).astype(np.float32),
        center=np.tile(rng.randn(3).astype(np.float32) * 0.01, (N_CHAINS, 1)),
        coeffs=(0.7 * rng.randn(N_CHAINS, r)).astype(np.float32),
    )


def _jstate(arrays):
    from icp_proposal_tpu.sampling.state import FitState

    return FitState(**{k: jnp.asarray(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

def test_face_kernel_matrices_identical():
    from icp_proposal_tpu.models import build_face as jface
    from icp_proposal_tpu.models.synthetic import make_open_patch as jpatch
    from icp_proposal_tpu_torch.models import build_face as pface
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch as ppatch

    pp, pc = ppatch(SUBDIV, 0.1, 0.55)
    jp, jc = jpatch(SUBDIV, 0.1, 0.55)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pc, jc)
    pts = np.asarray(pp, np.float64)
    pk = pface.FaceKernel(pface.FaceMask.trivial(len(pts)), pts)
    jk = jface.FaceKernel(jface.FaceMask.trivial(len(pts)), pts)
    x, y = pts[::3, None], pts[None, ::5] * 1.01
    np.testing.assert_array_equal(pk(x, y), jk(x, y))


def test_face_standin_matches_jax(jdata):
    """The face GPMM field by field, the target within float32 rounding of
    the JAX decode, the partial target and all three masks exactly."""
    pdata = pbfm.load_synthetic_face_data(rank=RANK, subdiv=SUBDIV,
                                          target_coeffs=_jax_target_coeffs(),
                                          device="cpu")
    assert pdata.model.rank == RANK
    for name, want in jdata.model._asdict().items():
        np.testing.assert_array_equal(getattr(pdata.model, name).numpy(),
                                      np.asarray(want), err_msg=name)
    np.testing.assert_allclose(pdata.target.points, jdata.target.points, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(pdata.target.cells, jdata.target.cells)
    np.testing.assert_allclose(pdata.target_partial.points, jdata.target_partial.points,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pdata.target_partial.cells, jdata.target_partial.cells)
    for name in ("model_boundary_mask", "target_boundary_mask", "partial_boundary_mask"):
        np.testing.assert_array_equal(getattr(pdata, name), getattr(jdata, name))


def test_synthesize_partial_target_matches_jax(jdata):
    from icp_proposal_tpu.apps.bfm import synthesize_partial_target as jsyn

    pts, cells = jdata.target.points, jdata.target.cells
    args = (pts, cells, pts[7], 30, (1, 2, 3, 500))
    for got, want in zip(pbfm.synthesize_partial_target(*args), jsyn(*args)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# evaluators and proposal densities
# ---------------------------------------------------------------------------

EVAL_SPECS = {
    "collective_symmetric": ("CollectiveAvgMaxSpec",
                             dict(sigma_avg=0.3, rate_max=1.0, mean=0.1,
                                  mode="symmetric", n_points=4 * RANK)),
    "collective_model_to_target": ("CollectiveAvgMaxSpec",
                                   dict(sigma_avg=0.3, rate_max=1.0, mean=0.1,
                                        mode="model_to_target", n_points=4 * RANK)),
    "collective_target_to_model": ("CollectiveAvgMaxSpec",
                                   dict(sigma_avg=0.3, rate_max=1.0, mean=0.1,
                                        mode="target_to_model", n_points=4 * RANK)),
    "hausdorff": ("HausdorffSpec", dict(rate=1.0)),
    "independent_target_to_model": ("IndependentPointsSpec",
                                    dict(sigma=3.0, mode="target_to_model",
                                         n_points=4 * RANK)),
    "independent_symmetric": ("IndependentPointsSpec",
                              dict(sigma=3.0, mode="symmetric", n_points=4 * RANK)),
    "accept_all": ("AcceptAllSpec", {}),
}


@pytest.mark.parametrize("case", sorted(EVAL_SPECS))
def test_evaluator_matches_jax(jdata, kernels_forced, case):
    """Each likelihood on the partial target, at states with pose, scale
    and shape moved: named values within rtol 1e-4."""
    from icp_proposal_tpu.sampling import evaluators as jev
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.state import transformed_points as jtp
    from icp_proposal_tpu_torch.sampling.state import transformed_points as ptp

    cls, kw = EVAL_SPECS[case]
    jctx = build_target_context(jdata.target_partial, jdata.partial_boundary_mask,
                                build_index=True)
    jprog = jev.build_evaluator(jdata.model, jctx, [getattr(jev, cls)(**kw)])
    pdata = _port_data(jdata)
    pctx = convert.context_from_arrays(
        jctx.points, jctx.cells, jctx.tri, jctx.boundary, jctx.index.cand, device="cpu")
    pprog = pev.build_evaluator(pdata.model, pctx, [getattr(pev, cls)(**kw)])
    assert pprog.named_keys == jprog.named_keys
    arrays = _pair_states(RANK, seed=3)
    js = _jstate(arrays)
    jprod, jnamed = jax.jit(jax.vmap(lambda s: jprog(s, jtp(jdata.model, s))))(js)
    ps = convert.state_from_arrays(**arrays, device="cpu")
    pprod, pnamed = pprog(ps, ptp(pdata.model, ps))
    np.testing.assert_allclose(pnamed.numpy(), np.asarray(jnamed), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pprod.numpy(), np.asarray(jprod), rtol=1e-4, atol=1e-5)


def test_pose_log_q_and_guards_match_jax(jdata):
    """The pose and random-shape mixture's transition densities at every
    component's candidate (and at a pair no component reaches), and the
    single-axis guards, against the JAX package."""
    from icp_proposal_tpu.sampling import proposals as jprop
    from icp_proposal_tpu.sampling.context import build_target_context

    specs = jprop.nest((0.4, jprop.mixed_random_pose_proposal()),
                       (0.05, jprop.mixed_random_shape_proposal()))
    jctx = build_target_context(jdata.target, jdata.target_boundary_mask,
                                build_index=False)
    jmix = jprop.MixtureProgram(specs, jdata.model, jctx, jdata.model_boundary_mask)
    pdata = _port_data(jdata)
    pctx = convert.context_from_arrays(jctx.points, jctx.cells, jctx.tri, jctx.boundary,
                                       device="cpu")
    pspecs = pprop.nest((0.4, pprop.mixed_random_pose_proposal()),
                        (0.05, pprop.mixed_random_shape_proposal()))
    assert [s.name for _, s in pspecs] == [s.name for _, s in specs]
    pmix = pprop.MixtureProgram(pspecs, pdata.model, pctx, pdata.model_boundary_mask)
    assert np.allclose(pmix.weights, jmix.weights)

    arrays = _pair_states(RANK, seed=5)
    ps = convert.state_from_arrays(**arrays, device="cpu")
    z = torch.as_tensor(np.random.RandomState(6).randn(N_CHAINS, pmix.num_components,
                                                        RANK).astype(np.float32))
    cands = pmix.propose_all(ps, {}, z)
    cands.append(ps._replace(coeffs=ps.coeffs + 1.0, rot=ps.rot + 0.1))  # no one's
    js = _jstate(arrays)
    for cand in cands:
        jc = _jstate({k: v.numpy() for k, v in cand._asdict().items()})
        want = jax.vmap(lambda a, b: jmix.log_q_mixture(a, b, {}))(js, jc)
        got = pmix.log_q_mixture(ps, cand, {})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for axis in range(3):
            for field in ("rot", "trans"):
                jguard = getattr(jprop, f"_all_but_{field}_axis_equal")
                jg = jax.vmap(lambda a, b: jguard(a, b, axis))(js, jc)
                pg = pprop._all_but_axis_equal(ps, cand, field, axis)
                np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    # a pose move is out of the ICP and shape components' reach
    assert not pprop._pose_scale_equal(ps, cands[0]).any()
