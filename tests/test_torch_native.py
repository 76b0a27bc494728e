"""The port's shortlist-index builder (``icp_proposal_tpu_torch.native``: K9
``shortlist_topk``, K10 ``point_tri_d2``) against the JAX package's own C++
source, ``icp_proposal_tpu/native/point_tri.cpp``, on the CPU.

The source is compiled with g++ into a temporary directory
(``tests/jax_native.py``; the JAX loader, which rebuilds the tracked
library in place, is never called) twice:

  (a) the JAX loader's flags and -ffp-contract=off: ids and d² bitwise;
  (b) the loader's flags unchanged (-march=native lets GCC fuse a·b + c):
      d² within rtol 1e-12, ids equal in every slot whose d² lies more than
      1e-9·max(1, d²) from its neighbours' in the row.

Meshes: the femur stand-in target (``artifacts/posterior/map.stl``, 1,622
vertices × 3,240 faces) and the face stand-in's target and partial target
(subdivision 4: 1,977 × 3,872 and 1,648 × 3,202), faces in Morton order as
every context sorts them.  The twin runs once per mesh at the largest K
(plus one slot, for the neighbours of the last) and every smaller K is
held as its prefix: a top-K of a total order is the K-prefix of any larger
top-K.  The kernels themselves run only on the card (marker ``cuda``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from jax_native import LOADER_FLAGS, bind, compile_native, default_build
from jax_native import point_tri_d2 as native_d2
from jax_native import shortlist_topk as native_topk
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import native
from icp_proposal_tpu_torch.ops.morton import morton_sort_faces

REPO = Path(__file__).resolve().parents[1]
FEMUR_KS = (16, 32, 64, 128)
KS = {"femur": FEMUR_KS, "face": (64,), "partial": (64,)}


def _queries_tri(points, cells):
    """(queries [V, 3], tri [F, 9]) float64 numpy, as the index builds them:
    float32 points, faces in Morton order, corners gathered, then float64."""
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells)
    cells = cells[morton_sort_faces(points, cells)]
    return points.astype(np.float64), points[cells].reshape(-1, 9).astype(np.float64)


@pytest.fixture(scope="module")
def meshes():
    from icp_proposal_tpu_torch.apps.bfm import load_synthetic_face_data
    from icp_proposal_tpu_torch.io.stl import read_stl

    face = load_synthetic_face_data(subdiv=4, device="cpu")
    return {"femur": _queries_tri(*read_stl(REPO / "artifacts" / "posterior" / "map.stl")),
            "face": _queries_tri(face.target.points, face.target.cells),
            "partial": _queries_tri(face.target_partial.points, face.target_partial.cells)}


@pytest.fixture(scope="module")
def twin(meshes):
    """The wrapper on CPU tensors (the twin) once per mesh at max(K) + 1."""
    return {name: tuple(x.numpy() for x in native.shortlist_topk(
        torch.as_tensor(q), torch.as_tensor(tri), max(KS[name]) + 1))
        for name, (q, tri) in meshes.items()}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("point_tri")
    return {"a": default_build(), "b": compile_native(out, LOADER_FLAGS, "point_tri_b")}


def _bits(x):
    return np.ascontiguousarray(x, np.float64).view(np.int64)


def _away_from_ties(d2):
    """Slots whose d² lies more than 1e-9·max(1, d²) from both neighbours'."""
    gap = np.diff(d2, axis=1)
    inf = np.full((d2.shape[0], 1), np.inf)
    nearest = np.minimum(np.concatenate([inf, gap], 1), np.concatenate([gap, inf], 1))
    return nearest > 1e-9 * np.maximum(1.0, d2)


CASES = [(name, k) for name in KS for k in KS[name]]


@pytest.mark.parametrize("name,k", CASES, ids=[f"{n}-K{k}" for n, k in CASES])
def test_shortlist_topk_bitwise_native_without_contraction(meshes, twin, libs, name, k):
    q, tri = meshes[name]
    idx, d2 = native_topk(bind(libs["a"]), q, tri, k)
    np.testing.assert_array_equal(twin[name][0][:, :k], idx)
    np.testing.assert_array_equal(_bits(twin[name][1][:, :k]), _bits(d2))


@pytest.mark.parametrize("name,k", CASES, ids=[f"{n}-K{k}" for n, k in CASES])
def test_shortlist_topk_near_native_with_loader_flags(meshes, twin, libs, name, k):
    q, tri = meshes[name]
    idx, d2 = native_topk(bind(libs["b"]), q, tri, k)
    t_idx, t_d2 = twin[name]
    np.testing.assert_allclose(d2, t_d2[:, :k], rtol=1e-12, atol=0)
    away = _away_from_ties(t_d2)[:, :k]
    assert away.mean() > 0.2  # not vacuous (a query vertex ties its faces at d² = 0)
    np.testing.assert_array_equal(idx[away], t_idx[:, :k][away])


def test_point_tri_d2_against_native(meshes, libs):
    """K10's twin on 64 queries of the femur stand-in against native's full
    matrix: bitwise under (a), within rtol 1e-12 under (b)."""
    q, tri = meshes["femur"]
    q = np.ascontiguousarray(q[::25][:64])
    got = native.point_tri_d2(torch.as_tensor(q), torch.as_tensor(tri)).numpy()
    assert got.shape == (64, len(tri))
    np.testing.assert_array_equal(_bits(got), _bits(native_d2(bind(libs["a"]), q, tri)))
    np.testing.assert_allclose(got, native_d2(bind(libs["b"]), q, tri), rtol=1e-12, atol=0)


def _small_mesh():
    from icp_proposal_tpu_torch.models.synthetic import make_icosphere

    points, cells = make_icosphere(subdivisions=1, radius=10.0)  # 42 vertices, 80 faces
    rng = np.random.RandomState(0)
    q = np.concatenate([np.asarray(points, np.float64), rng.randn(20, 3) * 12])
    return q, np.asarray(points, np.float64)[np.asarray(cells)].reshape(-1, 9)


@pytest.mark.parametrize("k", [80, 100], ids=["K=F", "K>F"])
def test_shortlist_topk_k_at_and_above_f(libs, k):
    """K = F returns every face in order; K > F takes F, as native does."""
    q, tri = _small_mesh()
    idx, d2 = native.shortlist_topk(torch.as_tensor(q), torch.as_tensor(tri), k)
    assert idx.shape == (len(q), 80) and idx.dtype == torch.int32
    want_idx, want_d2 = native_topk(bind(libs["a"]), q, tri, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(_bits(d2.numpy()), _bits(want_d2))
    assert (np.sort(idx.numpy(), axis=1) == np.arange(80)).all()


def test_shortlist_topk_nan_sorts_last():
    """A NaN vertex: every face that holds it has a NaN d² for every query,
    and those faces come after every number, by face id; the numbers before
    them are the shortlist of the faces without the NaN vertex.  A NaN query
    has only NaN d²: its shortlist is faces 0, 1, 2, ...  (Native's order
    is undefined with a NaN d².)"""
    from icp_proposal_tpu_torch.models.synthetic import make_icosphere

    points, cells = make_icosphere(subdivisions=1, radius=10.0)
    points = np.asarray(points, np.float64)
    cells = np.asarray(cells)
    points[5] = np.nan
    tri = points[cells].reshape(-1, 9)
    bad = (cells == 5).any(axis=1)
    rng = np.random.RandomState(1)
    q = np.concatenate([rng.randn(12, 3) * 12, np.full((1, 3), np.nan)])
    idx, d2 = (x.numpy() for x in native.shortlist_topk(torch.as_tensor(q),
                                                         torch.as_tensor(tri), 80))
    n_bad = int(bad.sum())
    assert n_bad == 5
    np.testing.assert_array_equal(idx[:-1, -n_bad:], np.tile(np.flatnonzero(bad), (12, 1)))
    assert np.isnan(d2[:-1, -n_bad:]).all() and not np.isnan(d2[:-1, :-n_bad]).any()
    good = np.flatnonzero(~bad)
    sub_idx, sub_d2 = native.shortlist_topk(torch.as_tensor(q[:-1]),
                                            torch.as_tensor(tri[good]), 80)
    np.testing.assert_array_equal(idx[:-1, :-n_bad], good[sub_idx.numpy()])
    np.testing.assert_array_equal(d2[:-1, :-n_bad], sub_d2.numpy())
    np.testing.assert_array_equal(idx[-1], np.arange(80))
    assert np.isnan(d2[-1]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, tri = (torch.as_tensor(x) for x in _small_mesh())
    with pytest.raises(ValueError, match="float64"):
        native.shortlist_topk(q.float(), tri, 8)
    with pytest.raises(ValueError, match="shape"):
        native.shortlist_topk(q, tri.reshape(-1, 3, 3), 8)
    with pytest.raises(ValueError, match="contiguous"):
        native.point_tri_d2(q, torch.cat([tri, tri], 1)[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        native.point_tri_d2(q[:, :2].contiguous(), tri)
    for k in (0, native.MAX_K + 1):
        with pytest.raises(ValueError, match="k <="):
            native.shortlist_topk(q, tri, k)


def test_max_k_is_the_kernels():
    """The wrapper's cap is K9's ``kTopkMaxK`` and ``TOPK_SORT`` its
    ``kTopkSort``; a tile then still holds faces (``kTopkSort`` − K > 0)."""
    src = (REPO / "icp_proposal_tpu_torch" / "csrc" / "point_tri.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kTopkMaxK"]) == native.MAX_K
    assert int(consts["kTopkSort"]) == native.TOPK_SORT > native.MAX_K


def test_cascade_ops_counts_each_region():
    """The bound's operation count: one pair in each of the seven regions
    of the triangle (0, 0, 0), (1, 0, 0), (0, 1, 0)."""
    tri = torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0]], dtype=torch.float64)
    q = torch.tensor([[-1.0, -1, 1], [2, -0.5, 0], [0.5, -1, 0], [-0.5, 2, 0],
                      [-1, 0.5, 0], [1, 1, 0], [0.2, 0.2, 1]], dtype=torch.float64)
    regions = native._cascade(q, tri, regions=True)[1][:, 0].tolist()
    assert regions == list(range(7))
    assert native.cascade_ops(q, tri) == sum(native.REGION_OPS)


def test_build_surface_index_on_cpu_is_the_twin(meshes, twin, monkeypatch):
    """``build_surface_index(device="cpu")`` takes the twin: its cand is the
    twin's K = 64 shortlist of the same points and Morton-sorted faces."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.ops import surface_index

    calls = []
    twin_fn = native.shortlist_topk_plain
    monkeypatch.setattr(native, "shortlist_topk_plain",
                        lambda *a: calls.append(a[2]) or twin_fn(*a))
    points, cells = read_stl(REPO / "artifacts" / "posterior" / "map.stl")
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells)[morton_sort_faces(points, np.asarray(cells))]
    index = surface_index.build_surface_index(points, cells, k=64, device="cpu")
    assert calls == [64] and index.cand.device.type == "cpu"
    np.testing.assert_array_equal(index.cand.numpy(), twin["femur"][0][:, :64])


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["femur", "face", "partial"])
def test_cuda_kernels_match_twin(cuda, meshes, twin, name):
    """K9 at each K of the mesh and K10 against the twin, bitwise."""
    q, tri = (torch.as_tensor(x, device=cuda) for x in meshes[name])
    before = native.shortlist_topk.launches
    for k in KS[name]:
        idx, d2 = native.shortlist_topk(q, tri, k)
        np.testing.assert_array_equal(idx.cpu().numpy(), twin[name][0][:, :k])
        np.testing.assert_array_equal(_bits(d2.cpu().numpy()), _bits(twin[name][1][:, :k]))
    assert native.shortlist_topk.launches == before + len(KS[name])
    full = native.point_tri_d2(q[:64], tri)
    want = native.point_tri_d2_plain(q[:64].cpu(), tri.cpu())
    np.testing.assert_array_equal(_bits(full.cpu().numpy()), _bits(want.numpy()))


@pytest.mark.cuda
def test_cuda_shortlist_topk_many_tiles_and_nan(cuda):
    """K9 where F spans several tiles (4,000 faces of a larger soup; K =
    1,024 leaves 1,024 faces a tile), with a NaN vertex and a NaN query."""
    rng = np.random.RandomState(3)
    tri = rng.randn(4000, 9) * 10
    tri[7, 3:6] = np.nan
    q = np.concatenate([rng.randn(40, 3) * 12, np.full((1, 3), np.nan)])
    for k in (64, native.MAX_K):
        got = native.shortlist_topk(torch.as_tensor(q, device=cuda),
                                    torch.as_tensor(tri, device=cuda), k)
        want = native.shortlist_topk(torch.as_tensor(q), torch.as_tensor(tri), k)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
        np.testing.assert_array_equal(_bits(got[1].cpu().numpy()), _bits(want[1].numpy()))


@pytest.mark.cuda
def test_cuda_build_surface_index_launches_k9(cuda):
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.ops import surface_index

    points, cells = read_stl(REPO / "artifacts" / "posterior" / "map.stl")
    before = native.shortlist_topk.launches
    index = surface_index.build_surface_index(points, cells, k=64, device=cuda)
    assert native.shortlist_topk.launches == before + 1
    assert index.cand.device.type == "cuda" and index.cand.dtype == torch.int32
    want = surface_index.build_shortlist(points, cells, k=64)
    np.testing.assert_array_equal(index.cand.cpu().numpy(), want)
