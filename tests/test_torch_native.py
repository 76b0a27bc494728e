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
import itertools
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
# K9's compile-time constants, as csrc/point_tri.cu defines them
K9 = {name: int(value) for name, value in re.findall(
    r"constexpr int (k\w+) = (\d+);",
    (REPO / "icp_proposal_tpu_torch" / "csrc" / "point_tri.cu").read_text())}
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
    """The wrapper's cap is K9's ``kTopkMaxK``, and K9's buffer room beyond
    K (K, at least ``kTopkMoreMin``, at most ``kTopkMoreMax``) holds a round
    of 32 after a selection and, with K, K padded to a power of two (the
    final sort) at every K up to that cap."""
    assert K9["kTopkMaxK"] == native.MAX_K
    assert K9["kTopkMoreMin"] >= 32 and 2 * K9["kTopkMoreMax"] >= K9["kTopkMaxK"]


def test_cascade_ops_counts_each_region():
    """The bound's operation count: one pair in each of the seven regions
    of the triangle (0, 0, 0), (1, 0, 0), (0, 1, 0)."""
    tri = torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0]], dtype=torch.float64)
    q = torch.tensor([[-1.0, -1, 1], [2, -0.5, 0], [0.5, -1, 0], [-0.5, 2, 0],
                      [-1, 0.5, 0], [1, 1, 0], [0.2, 0.2, 1]], dtype=torch.float64)
    regions = native._cascade(q, tri, regions=True)[1][:, 0].tolist()
    assert regions == list(range(7))
    assert native.cascade_ops(q, tri) == sum(native.REGION_OPS)


def test_cascade_ops_expands_divisions():
    """With ``expand_divisions`` each edge's division and the interior's
    reciprocal count as their SASS instructions, the other regions as
    before."""
    tri = torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0]], dtype=torch.float64)
    q = torch.tensor([[-1.0, -1, 1], [2, -0.5, 0], [0.5, -1, 0], [-0.5, 2, 0],
                      [-1, 0.5, 0], [1, 1, 0], [0.2, 0.2, 1]], dtype=torch.float64)
    extra = [(native.DIV_FP64_INSTRUCTIONS - 1) * d + (native.RCP_FP64_INSTRUCTIONS - 1) * r
             for d, r in zip(native.REGION_DIVS, native.REGION_RCPS)]
    assert extra[:2] == [0, 0] and extra[3] == 0 and min(extra[2:3] + extra[4:]) > 0
    for i in range(7):
        assert native.cascade_ops(q[i:i + 1], tri, expand_divisions=True) == (
            native.REGION_OPS[i] + extra[i])


def _grid(m=12):
    """A planar m × m grid of unit squares, two triangles each (interior
    vertices of valence 6): (points [m², 3], tri [2(m − 1)², 9]) float64,
    integer coordinates, so d² ties exactly at 0 and beyond."""
    xs, ys = np.meshgrid(np.arange(m, dtype=np.float64), np.arange(m, dtype=np.float64))
    points = np.stack([xs.ravel(), ys.ravel(), np.zeros(m * m)], 1)
    a = (np.arange(m - 1)[:, None] * m + np.arange(m - 1)[None, :]).ravel()
    cells = np.concatenate([np.stack([a, a + 1, a + m + 1], 1), np.stack([a, a + m + 1, a + m], 1)])
    return points, points[cells].reshape(-1, 9)


def _documented_order(d2, k):
    """The twin's documented order, written independently: numbers by (d²,
    face id), then every NaN by face id → ids [n, k]."""
    ids = np.broadcast_to(np.arange(d2.shape[1]), d2.shape)
    nan = np.isnan(d2)
    return np.stack([np.lexsort((i, np.where(n, 0.0, d), n))[:k]
                     for i, d, n in zip(ids, d2, nan)])


@pytest.mark.parametrize("k", [3, 5, 7])
def test_shortlist_topk_ties_straddle_kth_slot(libs, k):
    """On a regular grid every interior vertex is at d² = 0 from its six
    faces, so at K below the valence the K-th slot falls among exact ties
    (and rows tie again beyond 0): the twin keeps the lowest face ids there,
    bitwise native's (built without contraction)."""
    points, tri = _grid()
    idx, d2 = (x.numpy() for x in native.shortlist_topk(torch.as_tensor(points),
                                                         torch.as_tensor(tri), k + 1))
    straddle = d2[:, k - 1] == d2[:, k]
    assert straddle.mean() > 0.5  # not vacuous
    want_idx, want_d2 = native_topk(bind(libs["a"]), points, tri, k)
    np.testing.assert_array_equal(idx[:, :k], want_idx)
    np.testing.assert_array_equal(_bits(d2[:, :k]), _bits(want_d2))


@pytest.mark.parametrize("case", ["grid-K1", "soup-K1", "grid-KF", "soup-KF"])
def test_shortlist_topk_k_one_and_k_f(libs, case):
    """K = 1 (the lowest id among the faces at the least d²) and K = F (every
    face, in native's order) on the tie-heavy grid and a random soup."""
    mesh, which = case.split("-")
    if mesh == "grid":
        q, tri = _grid()
    else:
        rng = np.random.RandomState(11)
        q, tri = rng.randn(40, 3) * 12, rng.randn(300, 9) * 10
    k = 1 if which == "K1" else len(tri)
    idx, d2 = native.shortlist_topk(torch.as_tensor(q), torch.as_tensor(tri), k)
    want_idx, want_d2 = native_topk(bind(libs["a"]), q, tri, k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(_bits(d2.numpy()), _bits(want_d2))


def _nan_cases():
    """(queries, tri): all-NaN queries and queries with one NaN coordinate
    (every d² NaN), and ordinary queries against a grid with NaN corners
    (rows partly NaN, with ties at 0 among the numbers)."""
    points, tri = _grid(8)
    tri = tri.copy()
    tri[[3, 40, 41], 4] = np.nan
    q = points[::5].copy()
    bad = np.full((4, 3), 2.5)
    bad[0] = np.nan
    for i in range(3):
        bad[i + 1, i] = np.nan
    return np.concatenate([q, bad]), tri


@pytest.mark.parametrize("k", [1, 6, 60, 98])
def test_shortlist_topk_nan_queries_follow_documented_order(k):
    """Native's order is undefined once a d² is NaN, so the twin is held to
    its own documented order: numbers by (d², id), then NaN by id.  A query
    with any NaN coordinate has only NaN d²: faces 0, 1, 2, ..."""
    q, tri = _nan_cases()
    full = native.point_tri_d2(torch.as_tensor(q), torch.as_tensor(tri)).numpy()
    assert np.isnan(full[-4:]).all() and np.isnan(full[:-4]).any(1).all()
    assert not np.isnan(full[:-4]).all(1).any()
    idx, d2 = (x.numpy() for x in native.shortlist_topk(torch.as_tensor(q),
                                                         torch.as_tensor(tri), k))
    want = _documented_order(full, k)
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(_bits(d2), _bits(np.take_along_axis(full, want, 1)))
    np.testing.assert_array_equal(idx[-4:], np.tile(np.arange(k), (4, 1)))


# K9's selection, replayed in numpy on one query's row of d² as the kernel
# does it (csrc/point_tri.cu): the faces in parts of kTopkStep from a start
# part, wrapping around, in rounds of 32; the ballot against (tau, cut); a
# buffer of cap entries; the trie walk, the ties' lowest ids, the
# compaction; the sort of the K winners

_NAN_KEY = np.uint64(0x7FF0000000000001)
_ALL = (1 << 64) - 1


def _order_keys(d2):
    a = np.ascontiguousarray(d2, np.float64).view(np.uint64) & np.uint64(0x7FFFFFFFFFFFFFFF)
    return np.minimum(a, _NAN_KEY)


def _replay_walk(vals, k):
    """The 32-bit trie walk: the k-th smallest of vals (uint32) → (V, its
    rank among the values equal to V)."""
    vals = vals.astype(np.int64)
    a, o, r = np.bitwise_and.reduce(vals), np.bitwise_or.reduce(vals), k
    while a != o:
        bit = 1 << (int(a ^ o).bit_length() - 1)
        rng = vals[((vals ^ a) & ~(bit | (bit - 1)) & 0xFFFFFFFF) == 0]
        lo, hi = rng[(rng & bit) == 0], rng[(rng & bit) != 0]
        if r <= len(lo):
            a, o = np.bitwise_and.reduce(lo), np.bitwise_or.reduce(lo)
        else:
            r -= len(lo)
            a, o = np.bitwise_and.reduce(hi), np.bitwise_or.reduce(hi)
    return int(a), r


def _replay_select(keys, k):
    """The K-th key by a walk over the high words, then over the low words
    of those tied there → (T, r)."""
    hi, r = _replay_walk(keys >> np.uint64(32), k)
    tied = keys[(keys >> np.uint64(32)) == np.uint64(hi)]
    lo, r = _replay_walk(tied & np.uint64(0xFFFFFFFF), r)
    return hi << 32 | lo, r


def _replay_row(d2, k, cap, start=0):
    """One warp's K9 on one row with a buffer of ``cap`` (at least K + 32),
    from part ``start`` → (ids [k], d2 [k], selections made)."""
    keys, f, step = _order_keys(d2), len(d2), K9["kTopkStep"]
    parts = -(-f // step)
    bk, bi, tau, cut, selections = keys[:0], np.zeros(0, np.int64), _ALL, 2 ** 31 - 1, 0

    def reduce(bk, bi):
        t, r = _replay_select(bk, k)
        tied = bk == np.uint64(t)
        cut = bi[tied].max() if tied.sum() == r else np.sort(bi[tied])[r - 1]
        keep = (bk < np.uint64(t)) | (tied & (bi <= cut))
        return bk[keep], bi[keep], t, cut

    for t in range(parts):
        part = (start + t) % parts * step
        for base in range(part, min(f, part + step), 32):
            ks, ids = keys[base:base + 32], np.arange(base, min(base + 32, f))
            enter = (ks < np.uint64(tau)) | ((ks == np.uint64(tau)) & (ids < cut))
            if not enter.any():
                continue
            if len(bk) + int(enter.sum()) > cap:
                bk, bi, tau, cut = reduce(bk, bi)
                selections += 1
                enter = (ks < np.uint64(tau)) | ((ks == np.uint64(tau)) & (ids < cut))
            bk, bi = np.concatenate([bk, ks[enter]]), np.concatenate([bi, ids[enter]])
    if len(bk) > k:
        bk, bi, _, _ = reduce(bk, bi)
        selections += 1
    order = np.lexsort((bi, bk))
    return bi[order], d2[bi[order]], selections


def test_kernel_selection_replayed_matches_twin(meshes):
    """K9's algorithm, replayed, gives the twin's ids and d² bitwise from
    the first part and from a middle one (the kernel starts at the part
    nearest the block's queries and wraps around), with the least buffer
    the selection takes (K + 32) and a roomy one (K + 512): on femur rows
    (K = 16, 64, 1,024 beyond the rounds of one buffer), on the grid's ties
    (K = 3), on NaN rows, and on faces in decreasing distance, where every
    face enters and the buffer fills again and again."""
    q, tri = meshes["femur"]
    cases = [(np.ascontiguousarray(q[::160]), tri, (16, 64, 1024)), (*_grid(), (3, 7)),
             (*_nan_cases(), (6, 60))]
    rng = np.random.RandomState(2)
    soup = rng.randn(2000, 9) * 10
    far = soup[np.argsort(-np.linalg.norm(soup.reshape(-1, 3, 3).mean(1), axis=1))]
    cases.append((np.zeros((2, 3)), far, (1, 64, 1000)))
    many = 0
    for cq, ctri, ks in cases:
        full = native.point_tri_d2(torch.as_tensor(cq), torch.as_tensor(ctri)).numpy()
        parts = -(-len(ctri) // K9["kTopkStep"])
        for k in ks:
            t_idx, t_d2 = (x.numpy() for x in native.shortlist_topk(
                torch.as_tensor(cq), torch.as_tensor(ctri), k))
            for row, cap, start in itertools.product(range(len(cq)), (k + 32, k + 512),
                                                     (0, parts // 2)):
                ids, d2, selections = _replay_row(full[row], k, cap, start)
                np.testing.assert_array_equal(ids, t_idx[row])
                np.testing.assert_array_equal(_bits(d2), _bits(t_d2[row]))
                many = max(many, selections)
    assert many >= 5  # the buffer refilled again and again in the decreasing order


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
    """K9 where F spans many ring slots (4,000 faces of a larger soup: 32
    parts of 128, the last partial) and the buffer fills more than once
    (K = 1,024), with a NaN vertex and a NaN query."""
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


def _cuda_against_twin(dev, q, tri, k):
    got = native.shortlist_topk(torch.as_tensor(q, device=dev), torch.as_tensor(tri, device=dev), k)
    want = native.shortlist_topk(torch.as_tensor(q), torch.as_tensor(tri), k)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].numpy())
    np.testing.assert_array_equal(_bits(got[1].cpu().numpy()), _bits(want[1].numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5, 7, 64, 242])
def test_cuda_shortlist_topk_ties_and_edge_ks(cuda, k):
    """K9 against the twin on the grid's exact ties: K = 1, K below the
    valence (ties straddle the K-th slot), K = 64 and K = F."""
    _cuda_against_twin(cuda, *_grid(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 60, 98])
def test_cuda_shortlist_topk_nan_queries(cuda, k):
    """K9 against the twin on all-NaN and partly-NaN queries and NaN faces."""
    _cuda_against_twin(cuda, *_nan_cases(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 64, 700, native.MAX_K])
def test_cuda_shortlist_topk_ragged_tiles_and_refills(cuda, k):
    """F = 13 parts + 37 faces (not a multiple of a ring slot's part),
    queries in a ragged last block (one warp with a query beside idle warps
    that still refill the ring), and the same faces in decreasing distance
    from the origin, where the buffer refills again and again."""
    rng = np.random.RandomState(4)
    tri = rng.randn(13 * K9["kTopkStep"] + 37, 9) * 10
    q = rng.randn(3 * K9["kTopkWarps"] + 5, 3) * 12
    _cuda_against_twin(cuda, q, tri, k)
    far = tri[np.argsort(-np.linalg.norm(tri.reshape(-1, 3, 3).mean(1), axis=1))]
    _cuda_against_twin(cuda, np.zeros((K9["kTopkWarps"] + 1, 3)), far, k)
