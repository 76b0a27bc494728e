"""The port's numpy host modules against the JAX package's, on the same input.

These modules are copies (the port cannot import the JAX package on a
machine without JAX), so their results must be bitwise equal: STL reading,
Morton orders, seeded subsets, topology tables and the stand-in femur
GPMM-100.  The shortlist index build must agree on each vertex's sorted
candidate distances to 1e-6 relative, which allows for tie order.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu import mesh as jmesh
from icp_proposal_tpu.io.stl import read_stl as jread_stl
from icp_proposal_tpu.models import build_femur as jbuild
from icp_proposal_tpu.ops import morton as jmorton
from icp_proposal_tpu.ops import surface_index as jindex
from icp_proposal_tpu.ops import surface_sampling as jsampling
from icp_proposal_tpu_torch import mesh as pmesh
from icp_proposal_tpu_torch.io.stl import read_stl as pread_stl
from icp_proposal_tpu_torch.models import build_femur as pbuild
from icp_proposal_tpu_torch.ops import morton as pmorton
from icp_proposal_tpu_torch.ops import surface_index as pindex
from icp_proposal_tpu_torch.ops import surface_sampling as psampling
from icp_proposal_tpu_torch.ops.closest_point_cuda import face_table

STANDIN = Path(__file__).resolve().parents[1] / "artifacts" / "posterior"


@pytest.fixture(scope="module")
def meshes():
    return {name: jread_stl(STANDIN / f"{name}.stl") for name in ("mean", "map")}


@pytest.mark.parametrize("name", ["mean", "map"])
def test_read_stl_identical(meshes, name):
    points, cells = pread_stl(STANDIN / f"{name}.stl")
    assert points.shape == (1622, 3) and cells.shape == (3240, 3)
    np.testing.assert_array_equal(points, meshes[name][0])
    np.testing.assert_array_equal(cells, meshes[name][1])


def test_morton_and_subsets_identical(meshes):
    points, cells = meshes["mean"]
    np.testing.assert_array_equal(pmorton.morton_sort_faces(points, cells),
                                  jmorton.morton_sort_faces(points, cells))
    for seed in (1024, 1025, 2048):
        ids_p = psampling.seeded_vertex_subset(len(points), 202, seed)
        ids_j = jsampling.seeded_vertex_subset(len(points), 202, seed)
        np.testing.assert_array_equal(ids_p, ids_j)
        np.testing.assert_array_equal(pmorton.morton_sort_ids(points, ids_p),
                                      jmorton.morton_sort_ids(points, ids_j))
    np.testing.assert_array_equal(
        psampling.area_weighted_vertex_subset(points, cells, 200, 1024),
        jsampling.area_weighted_vertex_subset(points, cells, 200, 1024))


def test_topology_tables_identical(meshes):
    points, cells = meshes["map"]
    np.testing.assert_array_equal(pmesh.boundary_vertex_mask(cells, len(points)),
                                  jmesh.boundary_vertex_mask(cells, len(points)))
    np.testing.assert_array_equal(
        pmesh.vertex_face_adjacency(cells, len(points)),
        np.asarray(jmesh.vertex_face_adjacency(cells, len(points))))
    # an open patch: the first 600 faces leave a boundary
    sub = cells[:600]
    mask = pmesh.boundary_vertex_mask(sub, len(points))
    assert mask.any()
    np.testing.assert_array_equal(mask, jmesh.boundary_vertex_mask(sub, len(points)))


def test_standin_gpmm_identical(meshes):
    """The stand-in femur GPMM-100 (rank 101), field by field."""
    points, cells = meshes["mean"]
    pts = points[::40].astype(np.float64)
    np.testing.assert_array_equal(pbuild.femur_kernel(points)(pts[:, None], pts[None]),
                                  jbuild.femur_kernel(points)(pts[:, None], pts[None]))
    ref = jbuild.build_femur_gpmm(points, cells, 100)
    got = pbuild.build_femur_gpmm(points, cells, 100, device="cpu")
    assert got.rank == 101
    for name, want in ref._asdict().items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(want),
                                      err_msg=name)


def test_index_build_agrees(meshes, monkeypatch):
    """Per-vertex sorted shortlist distances agree to 1e-6 relative."""
    monkeypatch.setenv("ICP_TPU_NO_NATIVE", "1")  # never rebuild a tracked library
    monkeypatch.setattr("icp_proposal_tpu.native._lib", None)  # nor use a loaded one
    points, cells = meshes["map"]
    cells = cells[jmorton.morton_sort_faces(points, cells)]
    ref = jindex.build_surface_index(points, cells, k=64)
    cand = pindex.build_shortlist(points, cells, k=64)
    assert cand.shape == (1622, 64) and cand.dtype == np.int32
    tri = points[cells].astype(np.float64)
    rows = np.arange(0, len(points), 7)
    p64 = points[rows].astype(np.float64)

    def sorted_d2(c):
        d2 = pindex._np_point_tri_dist2(p64, tri)
        return np.sort(np.take_along_axis(d2, c[rows], axis=1), axis=1)

    np.testing.assert_allclose(sorted_d2(cand), sorted_d2(ref.cand), rtol=1e-6,
                               atol=1e-12)
    # the face table's rows of the shortlist, component-major, are the
    # reference's corner table: the gather of the shortlist
    faces = face_table(torch.as_tensor(points[cells])).numpy()
    np.testing.assert_array_equal(
        faces[cand][..., :9].transpose(0, 2, 1).reshape(1622, 576),
        points[cells][cand].transpose(0, 2, 3, 1).reshape(1622, 576))


def test_loader_host_copies_identical(meshes, tmp_path):
    """The real-femur loaders' host copies: landmark JSON reading and
    matching, Kabsch alignment and its application to a mesh, and the
    statismo reader's arrays, bitwise the JAX package's on the same files
    (written by the JAX package's writers)."""
    from icp_proposal_tpu.io import landmarks as jlm
    from icp_proposal_tpu.io import statismo as jst
    from icp_proposal_tpu.models.synthetic import make_synthetic_gpmm
    from icp_proposal_tpu.ops.rigid import rigid_landmark_alignment as jalign
    from icp_proposal_tpu_torch.io import landmarks as plm
    from icp_proposal_tpu_torch.io import statismo as pst
    from icp_proposal_tpu_torch.ops.rigid import rigid_landmark_alignment as palign

    points, cells = meshes["map"]
    rng = np.random.RandomState(4)
    ids = rng.choice(len(points), 5, replace=False)
    jlm.write_landmarks(tmp_path / "a.json", {f"p{i}": points[v] for i, v in enumerate(ids)})
    jlm.write_landmarks(tmp_path / "b.json", {f"p{i}": points[v] * 1.01 + 3.0
                                              for i, v in enumerate(ids[::-1])})
    a, b = (plm.read_landmarks(tmp_path / n) for n in ("a.json", "b.json"))
    src, dst, names = plm.common_landmarks(a, b)
    j_src, j_dst, j_names = jlm.common_landmarks(*(jlm.read_landmarks(tmp_path / n)
                                                   for n in ("a.json", "b.json")))
    assert names == j_names
    np.testing.assert_array_equal(src, j_src)
    np.testing.assert_array_equal(dst, j_dst)
    got, want = palign(src, dst), jalign(j_src, j_dst)
    np.testing.assert_array_equal(got.apply(points), np.asarray(want.apply(points)))
    jst.write_statismo_gpmm(tmp_path / "m.h5", make_synthetic_gpmm(points, cells, rank=3))
    arrays, j_arrays = (m.read_statismo_arrays(tmp_path / "m.h5") for m in (pst, jst))
    for k, v in j_arrays.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
