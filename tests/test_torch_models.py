"""The port's model, mesh and IO helpers against the JAX package's, on the
same input: GPMM decode, instance mesh and projection; face areas, scatter
vertex normals and adjacency counts; the STL writer; the synthetic GPMM
constructor; and the model-building variance diagnostics.  Host (numpy) copies must
agree bitwise, tensor functions to float32 tolerance.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu import mesh as jmesh
from icp_proposal_tpu.io import stl as jstl
from icp_proposal_tpu.models import build_femur as jbuild
from icp_proposal_tpu.models import gpmm as jgp
from icp_proposal_tpu.models import nystrom as jnystrom
from icp_proposal_tpu.models import synthetic as jsyn
from icp_proposal_tpu_torch import mesh as pmesh
from icp_proposal_tpu_torch.io import stl as pstl
from icp_proposal_tpu_torch.models import build_femur as pbuild
from icp_proposal_tpu_torch.models import gpmm as pgp
from icp_proposal_tpu_torch.models import nystrom as pnystrom
from icp_proposal_tpu_torch.models import synthetic as psyn

STANDIN = Path(__file__).resolve().parents[1] / "artifacts" / "posterior"


@pytest.fixture(scope="module")
def sphere():
    """The icosphere (2 subdivisions, radius 50) and its rank-6 synthetic
    GPMM in both packages."""
    points, cells = jsyn.make_icosphere(subdivisions=2, radius=50.0)
    jmodel = jsyn.make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0)
    model = psyn.make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0,
                                     device="cpu")
    return points, cells, jmodel, model


def test_make_synthetic_gpmm_identical(sphere):
    """Same kernel, Nyström points and float64 host math: every field of
    the GPMM is bitwise the reference's."""
    _, _, jmodel, model = sphere
    for name, want in jmodel._asdict().items():
        np.testing.assert_array_equal(getattr(model, name).numpy(), np.asarray(want),
                                      err_msg=name)


def test_decode_and_projection_match(sphere):
    """``instance_displacement``, ``instance_points``, ``instance_mesh`` and
    ``coefficients`` (one shape and a batch of three) against JAX; the
    projection inverts the decode."""
    _, _, jmodel, model = sphere
    alpha = np.random.RandomState(0).randn(3, model.rank).astype(np.float32)
    a = torch.as_tensor(alpha)
    disp = pgp.instance_displacement(model, a)
    np.testing.assert_allclose(
        disp.numpy(), np.asarray(jgp.instance_displacement(jmodel, jnp.asarray(alpha))),
        rtol=1e-5, atol=1e-4)
    pts = pgp.instance_points(model, a)
    np.testing.assert_allclose(pts.numpy(), np.stack(
        [np.asarray(jgp.instance_points(jmodel, jnp.asarray(x))) for x in alpha]),
        rtol=1e-5, atol=1e-4)
    mesh = pgp.instance_mesh(model, a[0])
    jm = jgp.instance_mesh(jmodel, jnp.asarray(alpha[0]))
    np.testing.assert_allclose(mesh.points.numpy(), np.asarray(jm.points), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(mesh.cells.numpy(), np.asarray(jm.cells))
    coeffs = pgp.coefficients(model, pts)
    for got, x, p in zip(coeffs.numpy(), alpha, pts.numpy()):
        np.testing.assert_allclose(got, np.asarray(jgp.coefficients(jmodel, jnp.asarray(p))),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, x, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pgp.coefficients(model, pts[1]).numpy(), coeffs[1].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_mesh_helpers_match():
    """On the stand-in femur mesh: adjacency counts bitwise; face areas and
    scatter vertex normals against JAX to float32 tolerance, batched over
    two meshes; the scatter normals equal the gather form's."""
    points, cells = jstl.read_stl(STANDIN / "mean.stl")
    np.testing.assert_array_equal(pmesh.vertex_adjacency_counts(cells, len(points)),
                                  jmesh.vertex_adjacency_counts(cells, len(points)))
    batch = np.stack([points, points * 1.1 + 3.0]).astype(np.float32)
    pts = torch.as_tensor(batch)
    cells_t = torch.as_tensor(cells, dtype=torch.int64)
    areas = pmesh.face_areas(pts, cells_t)
    normals = pmesh.vertex_normals(pts, cells_t)
    adjacency = torch.as_tensor(pmesh.vertex_face_adjacency(cells, len(points)),
                                dtype=torch.int64)
    gathered = pmesh.vertex_normals_gather(pts, cells_t, adjacency)
    for i in range(2):
        np.testing.assert_allclose(
            areas[i].numpy(), np.asarray(jmesh.face_areas(jnp.asarray(batch[i]), cells)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            normals[i].numpy(),
            np.asarray(jmesh.vertex_normals(jnp.asarray(batch[i]), jnp.asarray(cells))),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(normals.numpy(), gathered.numpy(), rtol=1e-5, atol=1e-6)


def test_write_stl_identical(tmp_path):
    """The port's binary STL is byte for byte the reference writer's and
    reads back to the same mesh."""
    points, cells = jstl.read_stl(STANDIN / "map.stl")
    pstl.write_stl(tmp_path / "port.stl", points, cells)
    jstl.write_stl(tmp_path / "ref.stl", points, cells)
    assert (tmp_path / "port.stl").read_bytes() == (tmp_path / "ref.stl").read_bytes()
    back_points, back_cells = pstl.read_stl(tmp_path / "port.stl")
    np.testing.assert_array_equal(back_points, points)
    np.testing.assert_array_equal(back_cells, cells)


def test_variance_diagnostics_identical():
    """``total_variance_estimate`` and ``variance_capture_ratio`` with the
    femur kernel on the stand-in mesh: the same floats as the reference."""
    points, cells = jstl.read_stl(STANDIN / "mean.stl")
    pts = np.asarray(points, np.float64)[::8]
    pkernel, jkernel = pbuild.femur_kernel(points), jbuild.femur_kernel(points)
    assert pnystrom.total_variance_estimate(pkernel, pts) == \
        jnystrom.total_variance_estimate(jkernel, pts)
    variance = np.linspace(100.0, 1.0, 20)
    ratio = pbuild.variance_capture_ratio(pkernel, pts, variance)
    assert ratio == jbuild.variance_capture_ratio(jkernel, pts, variance)
    assert 0.0 < ratio
