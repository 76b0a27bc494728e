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
from jax_native import use_native_index
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
    """The port's shortlist is the one the JAX package builds by default (its
    native builder), id for id; its sorted distances agree to 1e-6 relative
    with the JAX fallback's numpy formula, an independent check."""
    use_native_index(monkeypatch)
    points, cells = meshes["map"]
    cells = cells[jmorton.morton_sort_faces(points, cells)]
    ref = jindex.build_surface_index(points, cells, k=64)
    cand = pindex.build_shortlist(points, cells, k=64)
    assert cand.shape == (1622, 64) and cand.dtype == np.int32
    np.testing.assert_array_equal(cand, ref.cand)
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


def _binary_ply(path, points, cells, quads=()):
    """A binary little-endian PLY with an extra vertex property before and
    after x/y/z (skipped by the readers), an unknown fixed-size element
    between vertices and faces, triangles, and ``quads`` (split by the
    readers)."""
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(points)}",
            "property uchar flag", "property float x", "property float y",
            "property float z", "property double confidence", "element extra 2",
            "property int a", "property short b",
            f"element face {len(cells) + len(quads)}",
            "property list uchar int vertex_indices", "end_header"]
    vdt = np.dtype([("flag", "u1"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("confidence", "<f8")])
    verts = np.zeros(len(points), vdt)
    verts["flag"] = np.arange(len(points)) % 7
    for k, c in enumerate("xyz"):
        verts[c] = points[:, k]
    verts["confidence"] = np.linspace(0, 1, len(points))
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        f.write(verts.tobytes())
        f.write(b"\x01" * (2 * 6))
        for face in [*cells, *quads]:
            f.write(np.uint8(len(face)).tobytes() + np.asarray(face, "<i4").tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_ply_io_identical(meshes, tmp_path, fmt):
    """``read_ply`` of an ascii file (written by each package's
    ``write_ply``, whose bytes must be equal) and of a binary little-endian
    file with extra properties, an unknown element and quads: the same
    points and cells as the JAX package's reader, bitwise."""
    from icp_proposal_tpu.io import ply as jply
    from icp_proposal_tpu_torch.io import ply as pply

    points, cells = meshes["map"]
    path = tmp_path / f"m_{fmt}.ply"
    if fmt == "ascii":
        jply.write_ply(tmp_path / "j.ply", points, cells)
        pply.write_ply(path, points, cells)
        assert path.read_bytes() == (tmp_path / "j.ply").read_bytes()
    else:
        quads = [[0, 1, 2, 3], [10, 11, 12, 13]]
        _binary_ply(path, points * 1000.0, cells, quads)
    got, want = pply.read_ply(path), jply.read_ply(path)
    assert got[1].shape == (len(cells) + (0 if fmt == "ascii" else 4), 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _open_patch(subdivisions):
    from icp_proposal_tpu.models.synthetic import make_open_patch

    return make_open_patch(subdivisions=subdivisions, radius=0.1, z_cut=0.55)


@pytest.mark.parametrize("case", ["sphere-642-to-200", "open-patch-1977-to-800"])
def test_decimate_identical(case):
    """``decimate`` on JAX's ``test_decimate_sphere`` input and on the
    subdivision-4 open patch (the face stand-in's mesh): the same kept ids,
    cells and points, bitwise (heap ties and set order decide which vertices
    survive)."""
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu.ops.decimate import decimate as jdecimate
    from icp_proposal_tpu_torch.ops.decimate import decimate as pdecimate

    if case.startswith("sphere"):
        (points, cells), target = make_icosphere(subdivisions=3, radius=50.0), 200
    else:
        (points, cells), target = _open_patch(4), 800
    assert len(points) == int(case.split("-")[-3])
    got, want = pdecimate(points, cells, target), jdecimate(points, cells, target)
    assert len(got[2]) == target
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_decimate_gpmm_identical():
    """``decimate_gpmm`` on JAX's ``test_decimate_gpmm`` model (sphere, rank
    5, to 80 vertices), the port starting from JAX's arrays: the kept ids and
    every array of the decimated model bitwise."""
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu.ops.decimate import decimate_gpmm as jdecimate_gpmm
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.ops.decimate import decimate_gpmm as pdecimate_gpmm

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jmodel = make_synthetic_gpmm(points, cells, rank=5)
    model = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                        jmodel._asdict().items()}, device="cpu")
    (small, kept), (jsmall, jkept) = (pdecimate_gpmm(model, 80, device="cpu"),
                                      jdecimate_gpmm(jmodel, 80))
    assert small.num_points == 80 and small.rank == 5 and small.device.type == "cpu"
    np.testing.assert_array_equal(kept, jkept)
    for name, want in jsmall._asdict().items():
        np.testing.assert_array_equal(getattr(small, name).numpy(), np.asarray(want),
                                      err_msg=name)


def test_scalar_field_ply_bytes_identical(meshes, tmp_path):
    """``write_scalar_field_ply`` writes the JAX package's bytes, from host
    arrays and from CPU tensors (converted to numpy before formatting), and
    for a constant field (the zero colour ramp)."""
    from icp_proposal_tpu.io.scalar_field import write_scalar_field_ply as jwrite
    from icp_proposal_tpu_torch.io.scalar_field import write_scalar_field_ply as pwrite

    points, cells = meshes["mean"]
    values = np.random.RandomState(2).gamma(2.0, 0.3, len(points)).astype(np.float32)
    for tag, vals in (("field", values), ("constant", np.full(len(points), 0.5))):
        jwrite(tmp_path / f"j_{tag}.ply", points, cells, vals)
        want = (tmp_path / f"j_{tag}.ply").read_bytes()
        pwrite(tmp_path / f"p_{tag}.ply", points, cells, vals)
        pwrite(tmp_path / f"t_{tag}.ply", torch.as_tensor(points), torch.as_tensor(cells),
               torch.as_tensor(vals))
        assert (tmp_path / f"p_{tag}.ply").read_bytes() == want
        assert (tmp_path / f"t_{tag}.ply").read_bytes() == want
    assert b"tensor(" not in want
