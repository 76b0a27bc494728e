"""The port's device geometry against the JAX package's, to float32 tolerance.

Normals, pose transforms, decode and prior, both posterior-factor forms,
the posterior draw and ``transition_logpdf``, on the stand-in femur
GPMM-100 (rank 101) with 3 chains.  The JAX side is vmapped over chains and
reaches the K1/K2 Pallas kernels in interpret mode
(ICP_TPU_FORCE_CHOL_PALLAS=1).  Tolerance rtol 1e-4 (atol 1e-4 for values
near zero): float32 results of the same math summed in other orders.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu import mesh as jmesh
from icp_proposal_tpu.io.stl import read_stl
from icp_proposal_tpu.models import gpmm as jgp
from icp_proposal_tpu.models.build_femur import build_femur_gpmm
from icp_proposal_tpu.sampling import state as jstate
from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch import mesh as pmesh
from icp_proposal_tpu_torch.models import gpmm as pgp
from icp_proposal_tpu_torch.sampling import state as pstate

STANDIN = Path(__file__).resolve().parents[1] / "artifacts" / "posterior"
B = 3
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    points, cells = read_stl(STANDIN / "mean.stl")
    jm = build_femur_gpmm(points, cells, 100)
    pm = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                 device="cpu")
    return jm, pm


def _states(r, seed=0):
    rng = np.random.RandomState(seed)
    arrays = dict(
        scale=(1.0 + 0.05 * rng.randn(B)).astype(np.float32),
        rot=(0.1 * rng.randn(B, 3)).astype(np.float32),
        trans=rng.randn(B, 3).astype(np.float32),
        center=(rng.randn(B, 3) * 10).astype(np.float32),
        coeffs=rng.randn(B, r).astype(np.float32),
    )
    return jstate.FitState(**{k: jnp.asarray(v) for k, v in arrays.items()}), \
        convert.state_from_arrays(**arrays, device="cpu")


def test_decode_pose_and_prior(models):
    jm, pm = models
    js, ps = _states(pm.rank)
    np.testing.assert_allclose(pgp.instance_points(pm, ps.coeffs).numpy(),
                               np.asarray(jax.vmap(lambda c: jgp.instance_points(jm, c))(
                                   js.coeffs)), **TOL)
    np.testing.assert_allclose(pgp.prior_logpdf(ps.coeffs).numpy(),
                               np.asarray(jgp.prior_logpdf(js.coeffs)), **TOL)
    np.testing.assert_allclose(pstate.euler_matrix(ps.rot).numpy(),
                               np.asarray(jax.vmap(jstate.euler_matrix)(js.rot)), **TOL)
    pts = np.random.RandomState(1).randn(B, 50, 3).astype(np.float32) * 30
    for pfn, jfn in ((pstate.pose_apply, jstate.pose_apply),
                     (pstate.pose_inverse_apply, jstate.pose_inverse_apply)):
        np.testing.assert_allclose(pfn(ps, torch.as_tensor(pts)).numpy(),
                                   np.asarray(jax.vmap(jfn)(js, jnp.asarray(pts))),
                                   **TOL)
    np.testing.assert_allclose(
        pstate.transformed_points(pm, ps).numpy(),
        np.asarray(jax.vmap(lambda s: jstate.transformed_points(jm, s))(js)), **TOL)


def test_normals(models):
    jm, pm = models
    _, ps = _states(pm.rank, seed=2)
    pts = pstate.transformed_points(pm, ps)
    cells = np.asarray(jm.cells)
    adj = pmesh.vertex_face_adjacency(cells, pm.num_points)
    got = pmesh.vertex_normals_gather(pts, pm.cells, torch.as_tensor(adj).long())
    want = jax.vmap(lambda p: jmesh.vertex_normals_gather(p, jnp.asarray(cells), adj))(
        jnp.asarray(pts.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        pmesh.face_normals(pts, pm.cells).numpy(),
        np.asarray(jax.vmap(lambda p: jmesh.face_normals(p, jnp.asarray(cells)))(
            jnp.asarray(pts.numpy()))), **TOL)


def _obs(pm, m, seed):
    rng = np.random.RandomState(seed)
    n = rng.randn(B, m, 3)
    return dict(
        ids=np.stack([rng.choice(pm.num_points, m, False) for _ in range(B)]).astype(
            np.int32),
        obs_disp=(rng.randn(B, m, 3) * 2).astype(np.float32),
        normals=(n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32),
        mask=(rng.rand(B, m) > 0.1).astype(np.float32),
    )


def _target_obs(pm, m, seed):
    """The target direction's inputs: the port's tables (about a tenth of
    the vertices and each chain's first three ids on the boundary, weight
    0), ids [B, m] int32, target points [B, m, 3] and unit vertex normals
    [B, V, 3]; and JAX's per-observation obs_disp, normals and mask, the
    port's rows at each id."""
    rng = np.random.RandomState(seed)
    v = pm.num_points
    ids = np.stack([rng.choice(v, m, False) for _ in range(B)]).astype(np.int32)
    ref = pm.ref_points.numpy()
    tp = (ref[ids] + rng.randn(B, m, 3) * 2).astype(np.float32)
    n = rng.randn(B, v, 3)
    vnormals = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    boundary = rng.rand(v) < 0.1
    boundary[ids[:, :3]] = True
    port = dict(tables=pgp.target_tables(pm, torch.as_tensor(boundary)),
                ids=torch.as_tensor(ids), target_points=torch.as_tensor(tp),
                normals=torch.as_tensor(vnormals))
    jax_obs = dict(ids=ids, obs_disp=tp - ref[ids],
                   normals=vnormals[np.arange(B)[:, None], ids],
                   mask=(~boundary[ids]).astype(np.float32))
    return port, jax_obs


def _assert_factors(got, want):
    np.testing.assert_allclose(got.chol_m.numpy(), np.asarray(want.chol_m), **TOL)
    np.testing.assert_allclose(got.alpha_hat.numpy(), np.asarray(want.alpha_hat), **TOL)
    np.testing.assert_allclose(got.logdet_m.numpy(), np.asarray(want.logdet_m), **TOL)


def test_posterior_factors_and_densities(models, monkeypatch):
    """Both factor forms (dynamic ids: ICP target direction, the tables'
    plain assembly and factor on the CPU; static ids: model direction), the
    draw α̂ + L⁻ᵀz and transition_logpdf."""
    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    jm, pm = models
    m = 2 * pm.rank
    port, jo = _target_obs(pm, m, seed=3)
    assert 0 < jo["mask"].sum() < jo["mask"].size
    got = pgp.posterior_factors_anisotropic(**port, noise_along_normal=5.0,
                                            tangential_noise=10.0)
    want = jax.vmap(lambda i, d, n, k: jgp.posterior_factors_anisotropic(
        jm, i, d, n, 5.0, 10.0, k))(*(jnp.asarray(jo[k]) for k in
                                      ("ids", "obs_disp", "normals", "mask")))
    _assert_factors(got, want)

    o = _obs(pm, m, seed=3)
    t = {k: torch.as_tensor(v) for k, v in o.items()}

    ids = o["ids"][0]
    q = np.asarray(jm.sbasis)[ids]
    gram = np.einsum("mir,mis->mrs", q.astype(np.float64), q.astype(np.float64)).astype(
        np.float32)
    mean = np.asarray(jm.mean_disp)[ids]
    got_s = pgp.posterior_factors_anisotropic_static(
        pm, torch.as_tensor(q), torch.as_tensor(gram), torch.as_tensor(mean),
        t["obs_disp"], t["normals"], 5.0, 10.0, t["mask"])
    want_s = jax.vmap(lambda d, n, k: jgp.posterior_factors_anisotropic_static(
        jm, q, gram, mean, d, n, 5.0, 10.0, k))(
        *(jnp.asarray(o[k]) for k in ("obs_disp", "normals", "mask")))
    _assert_factors(got_s, want_s)

    keys = jax.random.split(jax.random.PRNGKey(4), B)
    z = np.array(jax.vmap(lambda k: jax.random.normal(k, (pm.rank,), jnp.float32))(
        keys))
    draw = pgp.sample_posterior_coeffs(got, torch.as_tensor(z))
    want_draw = jax.vmap(jgp.sample_posterior_coeffs)(keys, want)
    np.testing.assert_allclose(draw.numpy(), np.asarray(want_draw), **TOL)
    np.testing.assert_allclose(
        pgp.transition_logpdf(got, draw).numpy(),
        np.asarray(jax.vmap(jgp.transition_logpdf)(want, want_draw)), **TOL)
