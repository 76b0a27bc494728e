"""K5 ``surface_distances``: the port's plain version against the JAX
package's dense Pallas kernel (``_dist2_call``, interpret mode), and the
CUDA kernel against the plain version where a card is present.

Ids must match exactly, so both sides must round alike: the JAX references
come from a child process whose XLA targets SSE4.2, which has no FMA
(``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``), as in
``test_torch_closest_point.py``.  Run as a script, this file is that child:

    python tests/test_torch_dense_closest_point.py OUT.npz

``_replay_culled`` replays K5's culled visit logic in float32 on the CPU
(tile boxes, nearest-first order, skip margin, tie rule).  Run as

    PYTHONPATH=. python tests/test_torch_dense_closest_point.py --replay

it prints the share of (query, face) pairs the culled kernel evaluates on
the face stand-in's surfaces with 32- and 128-face tiles.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _jax_references(out_path):
    """The child: inputs from a fixed numpy seed, references from the JAX
    package's interpret-mode dense kernel; everything goes to one .npz."""
    import jax.numpy as jnp

    from icp_proposal_tpu.models.synthetic import make_icosphere, make_open_patch
    from icp_proposal_tpu.ops import closest_point_pallas as cpp

    def dense(q, tri, cull=False):
        os.environ["ICP_TPU_CULLING"] = "1" if cull else "0"
        d2, idx = cpp._dist2_call(jnp.asarray(q), cpp.pack_triangles(jnp.asarray(tri)),
                                  interpret=True)
        return np.asarray(d2), np.asarray(idx)

    rng = np.random.RandomState(0)
    out = {}
    # sphere: F = 320 and P = 37, neither a multiple of 128
    sp, sc = make_icosphere(subdivisions=2, radius=10.0)
    out["sph_points"], out["sph_cells"] = sp, np.asarray(sc, np.int32)
    out["sph_q"] = (rng.randn(3, 37, 3) * 12).astype(np.float32)
    out["sph_d2"], out["sph_idx"] = dense(out["sph_q"], sp[sc])
    out["sph_d2_cull"], out["sph_idx_cull"] = dense(out["sph_q"], sp[sc], cull=True)
    # per-chain meshes with shared topology; one query set for all chains
    pts_b = np.stack([sp, sp + 0.5, sp * 1.1]).astype(np.float32)
    out["sph_pts_b"] = pts_b
    out["sph_q1"] = (rng.randn(41, 3) * 12).astype(np.float32)
    out["sph_d2_b"], out["sph_idx_b"] = dense(
        np.broadcast_to(out["sph_q1"], (3, 41, 3)), pts_b[:, sc])
    # duplicated faces: the last 70 repeat faces 0..69
    dup = np.concatenate([sc, sc[:70]]).astype(np.int32)
    out["dup_cells"] = dup
    out["dup_d2"], out["dup_idx"] = dense(out["sph_q"], sp[dup])
    # face patch, the BFM stand-in's geometry, three tiles of faces
    fp, fc = make_open_patch(subdivisions=3, radius=0.1, z_cut=0.55)
    out["face_points"], out["face_cells"] = fp, np.asarray(fc, np.int32)
    out["face_q"] = (fp[rng.randint(0, len(fp), (2, 150))]
                     + rng.randn(2, 150, 3) * 0.01).astype(np.float32)
    out["face_d2"], out["face_idx"] = dense(out["face_q"], fp[fc])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dense_ref") / "ref.npz"
    # ICP_TPU_NO_NATIVE=1 only keeps the child from rebuilding the tracked
    # native library: the child builds no index
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               ICP_TPU_NO_NATIVE="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


CASES = {  # queries, points, cells, d2, idx
    "shared": ("sph_q", "sph_points", "sph_cells", "sph_d2", "sph_idx"),
    "shared_culled": ("sph_q", "sph_points", "sph_cells", "sph_d2_cull", "sph_idx_cull"),
    "per_chain_broadcast_queries": ("sph_q1", "sph_pts_b", "sph_cells", "sph_d2_b",
                                    "sph_idx_b"),
    "duplicated_faces": ("sph_q", "sph_points", "dup_cells", "dup_d2", "dup_idx"),
    "face_patch": ("face_q", "face_points", "face_cells", "face_d2", "face_idx"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_surface_distances_plain_matches_pallas(ref, case):
    """Same face ids exactly and bitwise-equal d² as the interpret-mode
    Pallas kernel."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import surface_distances

    q, pts, cells, d2_ref, idx_ref = (ref[k] for k in CASES[case])
    d2, idx = surface_distances(_t(q), _t(pts), _t(cells, torch.int32),
                                cull=case.endswith("culled"))
    assert idx.dtype == torch.int32 and d2.shape == idx_ref.shape
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    np.testing.assert_array_equal(d2.numpy(), d2_ref)
    if case == "duplicated_faces":  # the lower of two equal faces wins
        assert (idx.numpy() < 320).all()
        np.testing.assert_array_equal(idx.numpy(), ref["sph_idx"])


def test_cull_does_not_change_results(ref):
    """The reference's culled and dense kernels agree, and so do the port's
    calls with and without ``cull``."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import surface_distances

    np.testing.assert_array_equal(ref["sph_idx_cull"], ref["sph_idx"])
    np.testing.assert_array_equal(ref["sph_d2_cull"], ref["sph_d2"])
    args = (_t(ref["sph_q"]), _t(ref["sph_points"]), _t(ref["sph_cells"], torch.int32))
    for a, b in zip(surface_distances(*args, cull=True), surface_distances(*args)):
        assert torch.equal(a, b)


def test_closest_points_on_surface_matches_jax(ref):
    """The winner's closest point and the nearest corner, per-chain meshes."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.ops import closest_point as jcp
    from icp_proposal_tpu_torch.ops import closest_point as pcp

    q1, pts_b, cells = ref["sph_q1"], ref["sph_pts_b"], ref["sph_cells"]
    cp, d2, fidx = pcp.closest_points_on_surface(_t(q1), _t(pts_b), _t(cells, torch.int32))
    near = pcp.nearest_vertex_of_faces(_t(cells).long(), fidx, cp, _t(pts_b))
    np.testing.assert_array_equal(fidx.numpy(), ref["sph_idx_b"])

    def winner(p, f):  # the reference's recompute for the winning faces
        tri = jnp.asarray(p)[jnp.asarray(cells)][f]
        c, _ = jcp.closest_point_on_triangle(jnp.asarray(q1), tri[:, 0], tri[:, 1],
                                             tri[:, 2])
        return c, jcp.nearest_vertex_of_faces(jnp.asarray(cells), f, c, jnp.asarray(p))

    jcp_b, jnear = jax.vmap(winner)(jnp.asarray(pts_b), jnp.asarray(ref["sph_idx_b"]))
    np.testing.assert_allclose(cp.numpy(), np.asarray(jcp_b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(near.numpy(), np.asarray(jnear))


def test_surface_distances_plain_nan_query_gets_inf_and_face_0(ref):
    """A NaN d² never wins (K5's rule and the Pallas kernel's running
    minimum): a NaN query, or any query against a chain whose mesh is NaN,
    gets (+inf, face 0); the other queries are unchanged."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import surface_distances

    q = ref["sph_q"].copy()
    q[0, 3] = np.nan
    q[2, 5, 1] = np.nan
    cells = _t(ref["sph_cells"], torch.int32)
    d2, idx = surface_distances(_t(q), _t(ref["sph_points"]), cells)
    nan = np.isnan(q).any(-1)
    assert np.isposinf(d2.numpy()[nan]).all() and (idx.numpy()[nan] == 0).all()
    np.testing.assert_array_equal(d2.numpy()[~nan], ref["sph_d2"][~nan])
    np.testing.assert_array_equal(idx.numpy()[~nan], ref["sph_idx"][~nan])
    pts_b = ref["sph_pts_b"].copy()
    pts_b[1] = np.nan
    d2, idx = surface_distances(_t(ref["sph_q1"]), _t(pts_b), cells)
    assert np.isposinf(d2.numpy()[1]).all() and (idx.numpy()[1] == 0).all()
    np.testing.assert_array_equal(idx.numpy()[[0, 2]], ref["sph_idx_b"][[0, 2]])


def test_surface_distances_refuses_what_the_kernel_does_not_take():
    from icp_proposal_tpu_torch.ops.closest_point_cuda import surface_distances

    q, pts = torch.zeros(2, 5, 3), torch.zeros(4, 3)
    cells = torch.zeros(3, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        surface_distances(q[0], pts, cells)  # no chain dimension anywhere
    with pytest.raises(ValueError):
        surface_distances(q, pts, cells.long())  # int64 cells
    with pytest.raises(ValueError):
        surface_distances(q.double(), pts, cells)
    with pytest.raises(ValueError):
        surface_distances(q, torch.zeros(3, 4, 3), cells)  # 3 mesh chains, 2 query chains
    with pytest.raises(ValueError):  # the plain version counts no tile visits
        surface_distances(q, pts, cells, visits=torch.zeros(2, dtype=torch.int64))


def _replay_culled(q, pts, cells, tile=32):
    """K5's culled visit logic, warp by warp, in float32 with the kernel's
    operation order: q [P, 3] (one chain), pts [V, 3], cells [F, 3] →
    (d2 [P], idx [P], share of the (query, face) pairs evaluated).  The
    pair distances come from the plain cascade, bitwise the kernel's."""
    from icp_proposal_tpu_torch.ops.closest_point import closest_point_on_triangle

    f32, inf = np.float32, np.float32(np.inf)
    n_q, n_f = len(q), len(cells)
    n_t = -(-n_f // tile)
    tri = torch.as_tensor(pts[cells])
    _, dist = closest_point_on_triangle(torch.as_tensor(q)[:, None], tri[None, :, 0],
                                        tri[None, :, 1], tri[None, :, 2])
    dist = dist.numpy()
    corners = pts[cells].reshape(n_f * 3, 3)
    boxes = np.zeros((n_t, 7), f32)
    for t in range(n_t):
        c = corners[3 * t * tile:3 * (t + 1) * tile]
        boxes[t, :3] = np.fmin.reduce(c, axis=0, initial=inf)
        boxes[t, 3:6] = np.fmax.reduce(c, axis=0, initial=-inf)
        m = np.fmax(np.abs(boxes[t, :3]), np.abs(boxes[t, 3:6]))
        boxes[t, 6] = np.sqrt(f32(f32(f32(m[0] * m[0]) + f32(m[1] * m[1])) + f32(m[2] * m[2])))

    def box_d2(bx, lo, hi):  # lo, hi [n, 3] → [n]
        with np.errstate(invalid="ignore"):
            g = np.fmax(np.fmax(bx[:3] - hi, lo - bx[3:6]), f32(0)).astype(f32)
        return f32(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + f32(g[:, 2] * g[:, 2])

    out_d, out_i, pairs = np.zeros(n_q, f32), np.zeros(n_q, np.int64), 0
    for q0 in range(0, n_q, 32):
        qq = q[q0:q0 + 32]
        live = ~np.isnan(qq).any(-1)
        lo = np.fmin.reduce(np.where(live[:, None], qq, inf), axis=0)
        hi = np.fmax.reduce(np.where(live[:, None], qq, -inf), axis=0)
        keys = np.array([box_d2(boxes[t], lo[None], hi[None])[0] for t in range(n_t)])
        s = np.sqrt(f32(f32(qq[:, 0] * qq[:, 0]) + f32(qq[:, 1] * qq[:, 1]))
                    + f32(qq[:, 2] * qq[:, 2])) + boxes[:, 6].max()
        margin = f32(f32(2.0 ** -17) * f32(s * s)) + f32(2.0 ** -126)
        best, best_id = np.full(len(qq), inf), np.zeros(len(qq), np.int64)
        thr = np.where(live, inf, -inf).astype(f32)
        taken = np.zeros(n_t, bool)
        while not taken.all():
            left = np.flatnonzero(~taken)
            t = left[np.argmin(keys[left])]  # the first of equal keys: the lowest tile
            if keys[t] > np.fmax.reduce(thr):
                break
            taken[t] = True
            if not (box_d2(boxes[t], qq, qq) <= thr).any():
                continue
            ids = np.arange(t * tile, min((t + 1) * tile, n_f))
            pairs += len(qq) * len(ids)
            for u in ids:
                d = dist[q0:q0 + 32, u]
                win = (d < best) | ((d == best) & (u < best_id))
                best, best_id = np.where(win, d, best), np.where(win, u, best_id)
            thr = np.where(live, f32(best + margin), thr).astype(f32)
        out_d[q0:q0 + 32], out_i[q0:q0 + 32] = best, best_id
    return out_d, out_i, pairs / (n_q * n_f)


def _replay_surfaces(subdiv, n_q, seed=0):
    """The face stand-in's two K5 surfaces at ``subdiv``: the partial target
    (the V // 6 vertices nearest the top cut, as ``load_synthetic_face_data``
    does) and the full patch, Morton-sorted faces, n_q Morton-sorted
    queries from the patch's vertices with 0.002 noise."""
    from icp_proposal_tpu_torch.apps.bfm import synthesize_partial_target
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch
    from icp_proposal_tpu_torch.ops.morton import morton_sort_faces, morton_sort_ids

    rng = np.random.RandomState(seed)
    fp, fc = make_open_patch(subdivisions=subdiv, radius=0.1, z_cut=0.55)
    fp = fp.astype(np.float32)
    pp, pc, _ = synthesize_partial_target(fp, fc, fp[np.argmax(fp[:, 2])],
                                          n_cut=len(fp) // 6)
    pp = pp.astype(np.float32)
    ids = morton_sort_ids(fp, rng.choice(len(fp), n_q, replace=False))
    q = (fp[ids] + rng.randn(n_q, 3) * 0.002).astype(np.float32)
    return q, {"partial": (pp, pc[morton_sort_faces(pp, pc)].astype(np.int32)),
               "full": (fp, fc[morton_sort_faces(fp, fc)].astype(np.int32))}


def test_tile_size_matches_the_kernel_source():
    """The wrapper sizes K5's tile-box scratch with ``TILE_FACES``; it must
    be the kernel's ``kTileFaces``."""
    import re

    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    src = (REPO / "icp_proposal_tpu_torch" / "csrc" / "closest_point.cu").read_text()
    assert int(re.search(r"constexpr int kTileFaces = (\d+);", src).group(1)) == cc.TILE_FACES


@pytest.mark.parametrize("surface", ["partial", "full"])
def test_culled_replay_is_the_dense_scan(surface):
    """The float32 replay of K5's culled visit order, skip margin and tie
    rule gives the plain (dense) result bitwise on the face stand-in at
    subdiv 3, and evaluates fewer pairs with 32-face tiles than with 128."""
    from icp_proposal_tpu_torch.ops.closest_point import surface_distances

    q, surfaces = _replay_surfaces(3, 256)
    pts, cells = surfaces[surface]
    want = surface_distances(torch.as_tensor(q)[None], torch.as_tensor(pts),
                             torch.as_tensor(cells))
    shares = {}
    for tile in (32, 128):
        d2, idx, shares[tile] = _replay_culled(q, pts, cells, tile)
        np.testing.assert_array_equal(d2, want[0][0].numpy())
        np.testing.assert_array_equal(idx, want[1][0].numpy())
    assert shares[32] < shares[128] < 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_surface_distances_matches_plain(cuda):
    """K5 on the card, shared and per-chain surfaces at the BFM stand-in's
    shapes (P = 800, F = 3,199 and 3,872 faces; 8 chains), culled and not:
    ids and d² bitwise equal to the plain version on the same card."""
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    rng = np.random.RandomState(2)
    fp, fc = make_open_patch(subdivisions=4, radius=0.1, z_cut=0.55)
    b = 8
    pts = torch.as_tensor(fp, device=cuda)
    cells = torch.as_tensor(fc, device=cuda)
    shared_cells = cells[:3199].contiguous()
    pts_b = (pts + torch.as_tensor(rng.randn(b, 1, 3).astype(np.float32) * 0.005,
                                   device=cuda)).contiguous()
    q = torch.as_tensor(fp[rng.randint(0, len(fp), (b, 800))]
                        + rng.randn(b, 800, 3).astype(np.float32) * 0.01, device=cuda)
    q1 = q[0].contiguous()
    n0, c0 = cc.surface_distances.launches, cc.surface_distances.per_chain_launches
    for args in ((q, pts, shared_cells), (q1, pts_b, cells)):
        want = cc.surface_distances_plain(*args)
        for cull in (False, True):
            got = cc.surface_distances(*args, cull=cull)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert cc.surface_distances.launches == n0 + 4
    assert cc.surface_distances.per_chain_launches == c0 + 2


def _culled_dense_plain(args):
    """K5 culled and dense on the card and the plain version on the same
    card: d² and ids bitwise equal → (d2, idx)."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    culled, dense = cc.surface_distances(*args), cc.surface_distances(*args, cull=False)
    plain = cc.surface_distances_plain(*args)
    torch.cuda.synchronize()
    for got in (culled, dense):
        for g, w in zip(got, plain):
            assert torch.equal(g, w), (g != w).sum()
    return culled


def _random_triangles(rng, n, lo, hi):
    """n small triangles with centres uniform in the box [lo, hi]: [n, 3, 3]."""
    c = rng.uniform(lo, hi, (n, 1, 3))
    return (c + rng.randn(n, 3, 3) * 0.05).astype(np.float32)


def _soup(tris):
    """Triangles [F, 3, 3] → (points [3F, 3], cells [F, 3] int32)."""
    return (np.ascontiguousarray(tris.reshape(-1, 3)),
            np.arange(3 * len(tris), dtype=np.int32).reshape(-1, 3))


@pytest.mark.cuda
def test_cuda_culled_tie_goes_to_the_low_id_in_a_later_tile(cuda):
    """Face 7 (tile 0) and face 261 (tile 2) are the same triangle, the
    nearest to every query.  Tile 2's box holds the queries, so the warp
    visits it first; tile 0's box starts at the shared face's plane, so its
    bound equals the running best up to rounding.  The tie must go to 7."""
    rng = np.random.RandomState(5)
    shared = np.array([[0.5, -1.0, -1.0], [0.5, 1.0, -1.0], [0.5, 0.0, 1.0]], np.float32)
    tile0 = _random_triangles(rng, 128, (5, -2, -2), (10, 2, 2))
    tile0[7] = shared
    tile1 = _random_triangles(rng, 128, (50, -2, -2), (60, 2, 2))
    tile2 = np.concatenate([_random_triangles(rng, 64, (-3.2, -2, -2), (-3, 2, 2)),
                            _random_triangles(rng, 64, (3, -2, -2), (3.2, 2, 2))])
    tile2[5] = shared
    pts, cells = _soup(np.concatenate([tile0, tile1, tile2]))
    cells[256 + 5] = cells[7]  # the same corners, bit for bit
    q = (rng.randn(1, 64, 3) * 0.01).astype(np.float32)
    d2, idx = _culled_dense_plain((torch.as_tensor(q, device=cuda),
                                   torch.as_tensor(pts, device=cuda),
                                   torch.as_tensor(cells, device=cuda)))
    assert (idx == 7).all()


@pytest.mark.cuda
def test_cuda_culled_face_in_its_box_boundary_plane(cuda):
    """Two tiles of faces in the planes x = 0.5 − 2δ and x = 0.5, each the
    boundary plane of its own box, and queries just outside both at
    x = 0.5 − δ: both tiles give d² ≈ δ², equal up to rounding, so a
    tile's bound and the other tile's best differ by a few ulps and the
    skip margin decides.  Shared surface and per-chain meshes."""
    rng = np.random.RandomState(6)
    delta = 1e-3
    g = np.linspace(-1.0, 1.0, 9)
    quads = [(g[i], g[i + 1], g[k], g[k + 1]) for i in range(8) for k in range(8)]

    def plane(x):
        tris = []
        for y0, y1, z0, z1 in quads:
            tris += [[(x, y0, z0), (x, y1, z0), (x, y1, z1)],
                     [(x, y0, z0), (x, y1, z1), (x, y0, z1)]]
        return np.asarray(tris, np.float32)  # 128 faces, one tile

    pts, cells = _soup(np.concatenate([plane(0.5 - 2 * delta), plane(0.5),
                                       _random_triangles(rng, 100, (3, -1, -1),
                                                         (4, 1, 1))]))
    b, p = 4, 96
    q = rng.uniform(-0.9, 0.9, (b, p, 3)).astype(np.float32)
    q[..., 0] = np.float32(0.5 - delta)
    qg, pg, cg = (torch.as_tensor(a, device=cuda) for a in (q, pts, cells))
    _culled_dense_plain((qg, pg, cg))
    pts_b = (pg[None] + torch.as_tensor(rng.randn(b, 1, 3).astype(np.float32) * 1e-4,
                                        device=cuda)).contiguous()
    _culled_dense_plain((qg[0].contiguous(), pts_b, cg))


def _holed_patch(rng, permute=False):
    """The BFM stand-in's open patch (3,872 faces) with a hole like the
    partial face's occluded nose: faces near the patch centre removed, the
    rest Morton-sorted (or shuffled) → (points, cells)."""
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch
    from icp_proposal_tpu_torch.ops.morton import morton_sort_faces

    fp, fc = make_open_patch(subdivisions=4, radius=0.1, z_cut=0.55)
    centre = fp[np.argmax(fp[:, 2])]
    far = np.linalg.norm(fp[fc].mean(1) - centre, axis=-1) > 0.045
    fc = fc[far]
    order = rng.permutation(len(fc)) if permute else morton_sort_faces(fp, fc)
    return fp.astype(np.float32), np.ascontiguousarray(fc[order], dtype=np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("permute", [False, True], ids=["morton", "unsorted"])
def test_cuda_culled_on_a_holed_surface(cuda, permute):
    """A target with a hole (queries over the hole keep a far best) with
    Morton-sorted faces, and the same faces shuffled, where culling prunes
    little: shared and per-chain surfaces, bitwise the dense scan."""
    from icp_proposal_tpu_torch.ops.morton import morton_sort_ids

    rng = np.random.RandomState(7)
    fp, fc = _holed_patch(rng, permute)
    b, p = 8, 800
    ids = morton_sort_ids(fp, rng.choice(len(fp), p, replace=False))
    q = (fp[ids][None] + rng.randn(b, p, 3) * 0.005).astype(np.float32)
    pts, cells = torch.as_tensor(fp, device=cuda), torch.as_tensor(fc, device=cuda)
    _culled_dense_plain((torch.as_tensor(q, device=cuda), pts, cells))
    pts_b = (pts + torch.as_tensor(rng.randn(b, 1, 3).astype(np.float32) * 0.005,
                                   device=cuda)).contiguous()
    _culled_dense_plain((torch.as_tensor(q[0], device=cuda), pts_b, cells))


@pytest.mark.cuda
def test_cuda_culled_nan_queries_and_meshes(cuda):
    """NaN queries (one lane of a warp, and a whole warp) and per-chain
    meshes with a few NaN vertices or all NaN: (+inf, 0) where nothing is
    finite, bitwise the dense scan and the plain version everywhere."""
    rng = np.random.RandomState(8)
    fp, fc = _holed_patch(rng)
    b, p = 4, 128
    q = (fp[rng.randint(0, len(fp), (b, p))] + rng.randn(b, p, 3) * 0.005).astype(
        np.float32)
    q[0, 3, 1] = np.nan
    q[1, 32:64] = np.nan
    pts, cells = torch.as_tensor(fp, device=cuda), torch.as_tensor(fc, device=cuda)
    d2, idx = _culled_dense_plain((torch.as_tensor(q, device=cuda), pts, cells))
    nan = torch.as_tensor(np.isnan(q).any(-1), device=cuda)
    assert torch.isposinf(d2[nan]).all() and (idx[nan] == 0).all()
    assert torch.isfinite(d2[~nan]).all()
    pts_b = pts.expand(b, -1, -1).clone()
    pts_b[1] = float("nan")
    pts_b[2, rng.randint(0, len(fp), 40)] = float("nan")
    d2, idx = _culled_dense_plain((torch.as_tensor(q[2], device=cuda), pts_b, cells))
    assert torch.isposinf(d2[1]).all() and (idx[1] == 0).all()


if __name__ == "__main__":
    if sys.argv[1] == "--replay":
        q, surfaces = _replay_surfaces(4, 800)
        for name, (pts, cells) in surfaces.items():
            for tile in (32, 128):
                share = _replay_culled(q, pts, cells, tile)[2]
                print(f"{name} surface, {len(cells)} faces, {tile}-face tiles: "
                      f"{share:.4f} of the (query, face) pairs evaluated")
    else:
        _jax_references(sys.argv[1])
