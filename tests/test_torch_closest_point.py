"""K3 ``nearest_vertices`` and K4 ``refine_shortlist``: the port's plain twins
against the JAX package's Pallas kernels (interpret mode), on a sphere, on
the stand-in femur target and on a fixture that pins the tie rules; and the
CUDA kernels against the plain twins where a card is present.

Ids must match exactly, so both sides must round alike.  XLA's CPU backend
contracts a·b + c into one FMA where the CPU has FMA units; the kernels
(compiled with -fmad=false) and the plain twins round every product and sum
on its own.  The JAX references are therefore computed in a child process
whose XLA targets SSE4.2, which has no FMA (``XLA_FLAGS=
--xla_cpu_max_isa=SSE4_2``).  Run as a script, this file is that child:

    python tests/test_torch_closest_point.py OUT.npz
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
STANDIN = REPO / "artifacts" / "posterior"
K = 64


def _cand_tri(tri, cand):
    """The reference's per-vertex corner table of a shortlist: tri [F, 3, 3]
    gathered by cand [V, K] → [V, 9·K], component-major (ax[K] ay[K] ...
    cz[K])."""
    v, k = cand.shape
    return np.ascontiguousarray(
        tri[cand].transpose(0, 2, 3, 1).reshape(v, 9 * k).astype(np.float32))


def _tie_fixture():
    """Small-integer geometry, so every d² below is exact in float32.

    K3: vertices 0 and 2 coincide, as do 1 and 4; vertices 5 and 6 are
    equidistant from the last query.  K4: faces 7 and 9 are the same
    triangle T, face 8 is T with its corners rotated; one query row's
    shortlist holds face 9 (slot 5), face 7 (slots 10 and 20) and face 8
    (slot 25): the smallest face id wins over the lower slot.  A second row
    adds a strictly closer face 50 at slot 30, which wins over all."""
    verts = np.array([[0, 0, 0], [4, 0, 0], [0, 0, 0], [0, 4, 0], [4, 0, 0],
                      [10, 1, 0], [10, -1, 0]], np.float32)
    vq = np.array([[[0, 0, 1], [4, 1, 0], [0, 0, 0], [0, 3, 0], [10, 0, 0]]],
                  np.float32)
    a, b, c = [0, 0, 0], [4, 0, 0], [0, 4, 0]
    far = np.array([[40, 40, 40], [44, 40, 40], [40, 44, 40]], np.float32)
    tri = np.tile(far, (100 + K, 1, 1)) + np.arange(100 + K, dtype=np.float32)[:, None,
                                                                             None]
    tri[[7, 9]] = [a, b, c]
    tri[8] = [b, c, a]
    tri[50] = [[0, 0, 1.5], [4, 0, 1.5], [0, 4, 1.5]]
    cand = 100 + np.tile(np.arange(K, dtype=np.int32), (2, 1))
    cand[:, [5, 10, 20, 25]] = [9, 7, 7, 8]
    cand[1, 30] = 50
    rq = np.array([[[1, 1, 2], [1, 1, 2]]], np.float32)  # rows 0 and 1
    coarse = np.array([[0, 1]], np.int32)
    return dict(tie_verts=verts, tie_vq=vq, tie_tri=tri.astype(np.float32), tie_cand=cand,
                tie_cand_tri=_cand_tri(tri, cand), tie_rq=rq, tie_coarse=coarse)


def _refine_nan_fixture():
    """K4's NaN rule.  64 triangles of size ~50 (numpy seed 5), one shortlist
    row naming all of them, and 200 finite queries of magnitude 1e37: the
    cascade overflows, so some slots' d² are NaN and others not.  And 20
    ordinary queries against the same row where face 13 (at slot 7) has NaN
    corners."""
    rng = np.random.RandomState(5)
    tri = (rng.randn(K, 3, 3) * 50).astype(np.float32)
    cand = rng.permutation(K).astype(np.int32)[None]
    q37 = (rng.randn(1, 200, 3) * 1e37).astype(np.float32)
    tri_nan = tri.copy()
    tri_nan[13] = np.nan
    cand_nan = cand.copy()
    slot = int(np.nonzero(cand_nan[0] == 13)[0][0])
    cand_nan[0, [slot, 7]] = cand_nan[0, [7, slot]]
    q_nan = (rng.randn(1, 20, 3) * 50).astype(np.float32)
    return dict(rn_tri=tri, rn_cand=cand, rn_cand_tri=_cand_tri(tri, cand), rn_q=q37,
                rn_tri_nan=tri_nan, rn_cand_nan=cand_nan,
                rn_cand_tri_nan=_cand_tri(tri_nan, cand_nan), rn_q_nan=q_nan,
                rn_coarse=np.zeros((1, 200), np.int32),
                rn_coarse_nan=np.zeros((1, 20), np.int32))


def _nan_fixture():
    """40 vertices and 2 × 5 queries from numpy seed 0; vertex 7 is NaN in
    the shared set, query (1, 3) is NaN, and in the per-chain sets chain 0
    has the NaN vertex 7 and chain 1 is NaN throughout."""
    rng = np.random.RandomState(0)
    pts = rng.randn(40, 3).astype(np.float32)
    q = rng.randn(2, 5, 3).astype(np.float32)
    pts[7] = np.nan
    q[1, 3] = np.nan
    pts_b = np.stack([pts, np.full_like(pts, np.nan)])
    return dict(nan_pts=pts, nan_q=q, nan_pts_b=pts_b)


def _nearest_finite(q, pts):
    """float64 argmin over the finite vertices, 0 where none is finite."""
    d2 = ((q[..., :, None, :].astype(np.float64) - pts[..., None, :, :]) ** 2).sum(-1)
    d2 = np.where(np.isnan(d2), np.inf, d2)
    return np.argmin(d2, axis=-1)


def _jax_references(out_path):
    """The child: inputs from a fixed numpy seed, references from the JAX
    package's interpret-mode kernels; everything goes to one .npz."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import make_mesh
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu.ops import closest_point_pallas as cpp
    from icp_proposal_tpu.ops.surface_index import build_surface_index, index_closest
    from icp_proposal_tpu.sampling.context import build_target_context

    def nv(q, pts):
        return np.asarray(cpp._nv_call(jnp.asarray(q), cpp.pack_points(jnp.asarray(pts)),
                                       interpret=True))

    def refine(q, coarse, cand, cand_tri):
        f, w = cpp._refine_call(jnp.asarray(q), jnp.asarray(cand_tri[coarse]),
                                jnp.asarray(cand[coarse]), cand.shape[1],
                                interpret=True)
        return np.asarray(f), np.asarray(w)

    rng = np.random.RandomState(0)
    out = {}
    # sphere: shared and per-chain vertex sets, and a K=64 index
    sp, sc = make_icosphere(subdivisions=2, radius=10.0)
    sp = np.asarray(sp, np.float32)
    out["sph_points"], out["sph_cells"] = sp, np.asarray(sc, np.int32)
    out["sph_q"] = (rng.randn(3, 37, 3) * 12).astype(np.float32)
    out["sph_pts_b"] = np.stack([sp, sp + 0.5, sp * 1.1]).astype(np.float32)
    out["sph_nv"] = nv(out["sph_q"], sp)
    out["sph_nv_b"] = nv(out["sph_q"], out["sph_pts_b"])
    sidx = build_surface_index(sp, sc, k=K)
    out["sph_tri"] = np.asarray(sidx.tri)
    out["sph_cand"], out["sph_cand_tri"] = sidx.cand, sidx.cand_tri
    out["sph_fidx"], out["sph_wtri"] = refine(out["sph_q"], out["sph_nv"],
                                              sidx.cand, sidx.cand_tri)
    # stand-in femur: the main path's per-chain shapes
    mp, _ = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    ctx = build_target_context(make_mesh(tp, tc), build_index=True)
    for name in ("points", "cells", "tri", "boundary"):
        out[f"ctx_{name}"] = np.asarray(getattr(ctx, name))
    out["ctx_cand"], out["ctx_cand_tri"] = ctx.index.cand, ctx.index.cand_tri
    b = 4
    out["fem_q"] = (mp[rng.randint(0, len(mp), (b, 404))]
                    + rng.randn(b, 404, 3) * 0.5).astype(np.float32)
    out["fem_nv"] = nv(out["fem_q"], ctx.points)
    out["fem_tq"] = np.broadcast_to(ctx.points[rng.choice(len(tp), 202, False)],
                                    (b, 202, 3)).astype(np.float32)
    out["fem_pts_b"] = (mp[None] + rng.randn(b, 1, 3) * 0.3).astype(np.float32)
    out["fem_nv_b"] = nv(out["fem_tq"], out["fem_pts_b"])
    out["fem_fidx"], out["fem_wtri"] = refine(out["fem_q"], out["fem_nv"],
                                              ctx.index.cand, ctx.index.cand_tri)
    cp, d2, fidx = jax.vmap(lambda q: index_closest(ctx.index, q))(
        jnp.asarray(out["fem_q"]))
    out["ic_cp"], out["ic_d2"], out["ic_fidx"] = map(np.asarray, (cp, d2, fidx))
    # the NaN rule: one NaN vertex, one NaN query, an all-NaN per-chain set
    nan = _nan_fixture()
    out.update(nan)
    out["nan_nv"] = nv(nan["nan_q"], nan["nan_pts"])
    out["nan_nv_b"] = nv(nan["nan_q"], nan["nan_pts_b"])
    # tie rules
    tie = _tie_fixture()
    out.update(tie)
    out["tie_nv"] = nv(tie["tie_vq"], tie["tie_verts"])
    out["tie_fidx"], out["tie_wtri"] = refine(tie["tie_rq"], tie["tie_coarse"],
                                              tie["tie_cand"], tie["tie_cand_tri"])
    # K4's NaN rule
    rn = _refine_nan_fixture()
    out.update(rn)
    out["rn_fidx"], out["rn_wtri"] = refine(rn["rn_q"], rn["rn_coarse"], rn["rn_cand"],
                                            rn["rn_cand_tri"])
    out["rn_fidx_nan"], out["rn_wtri_nan"] = refine(
        rn["rn_q_nan"], rn["rn_coarse_nan"], rn["rn_cand_nan"], rn["rn_cand_tri_nan"])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               ICP_TPU_NO_NATIVE="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("case", ["sph", "sph_b", "fem", "fem_b", "tie"])
def test_nearest_vertices_plain_matches_pallas(ref, case):
    from icp_proposal_tpu_torch.ops.closest_point_cuda import nearest_vertices

    q, pts, want = {
        "sph": ("sph_q", "sph_points", "sph_nv"),
        "sph_b": ("sph_q", "sph_pts_b", "sph_nv_b"),
        "fem": ("fem_q", "ctx_points", "fem_nv"),
        "fem_b": ("fem_tq", "fem_pts_b", "fem_nv_b"),
        "tie": ("tie_vq", "tie_verts", "tie_nv"),
    }[case]
    ids = nearest_vertices(_t(ref[q]), _t(ref[pts]))
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), ref[want])
    if case == "tie":  # coincident vertices → the lowest id; equal d² → lowest
        np.testing.assert_array_equal(ids.numpy(), [[0, 1, 0, 3, 5]])


@pytest.mark.parametrize("case", ["sph", "fem", "tie"])
def test_refine_shortlist_plain_matches_pallas(ref, case):
    from icp_proposal_tpu_torch.ops.closest_point_cuda import face_table, refine_shortlist

    q, coarse, cand, tri, fidx, wtri = {
        "sph": ("sph_q", "sph_nv", "sph_cand", "sph_tri", "sph_fidx", "sph_wtri"),
        "fem": ("fem_q", "fem_nv", "ctx_cand", "ctx_tri", "fem_fidx", "fem_wtri"),
        "tie": ("tie_rq", "tie_coarse", "tie_cand", "tie_tri", "tie_fidx", "tie_wtri"),
    }[case]
    got_f, got_w = refine_shortlist(_t(ref[q]), _t(ref[coarse], torch.int32),
                                    _t(ref[cand], torch.int32), face_table(_t(ref[tri])))
    np.testing.assert_array_equal(got_f.numpy(), ref[fidx])
    np.testing.assert_array_equal(got_w.numpy(), ref[wtri])
    if case == "tie":
        # row 0: faces 9, 7 and 8 tie on d² → face 7, whose corners are in
        # (a, b, c) order; row 1: the strictly closer face 50 wins
        np.testing.assert_array_equal(got_f.numpy(), [[7, 50]])
        np.testing.assert_array_equal(got_w.numpy()[0, 0],
                                      [0, 0, 0, 4, 0, 0, 0, 4, 0])


def test_index_closest_matches_jax(ref):
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.ops.surface_index import index_closest

    ctx = convert.context_from_arrays(
        *(ref[f"ctx_{n}"] for n in ("points", "cells", "tri", "boundary", "cand")),
        device="cpu")
    cp, d2, fidx = index_closest(ctx.index, _t(ref["fem_q"]))
    np.testing.assert_array_equal(fidx.numpy(), ref["ic_fidx"])
    np.testing.assert_allclose(d2.numpy(), ref["ic_d2"], rtol=1e-5)
    np.testing.assert_allclose(cp.numpy(), ref["ic_cp"], rtol=1e-5, atol=1e-4)


def test_port_index_build_matches_reference_context(ref):
    """The port's own context (Morton-sorted faces + K=64 index) is the one
    the JAX package builds."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    tp, tc = read_stl(STANDIN / "map.stl")
    ctx = build_target_context(make_mesh(tp, tc), device="cpu")
    np.testing.assert_array_equal(ctx.cells.numpy(), ref["ctx_cells"])
    np.testing.assert_array_equal(ctx.boundary.numpy(), ref["ctx_boundary"])
    np.testing.assert_array_equal(ctx.index.cand.numpy(), ref["ctx_cand"])
    np.testing.assert_array_equal(ctx.index.tri.numpy(), ref["ctx_tri"])
    np.testing.assert_array_equal(
        _cand_tri(ctx.index.faces[:, :9].reshape(-1, 3, 3).numpy(), ctx.index.cand.numpy()),
        ref["ctx_cand_tri"])


def test_nearest_vertices_nan_rule(ref):
    """K3's NaN rule in the twin: a NaN d² never wins and a query with no
    finite d² gets id 0; K8's twin follows the same rule.  The JAX kernel
    returns 2³⁰ for every query of these sets (``jnp.min`` propagates the
    NaN and no lane equals it); the port keeps ids in range on purpose, as
    its gathers would fault on 2³⁰."""
    from icp_proposal_tpu_torch.ops import surface_index
    from icp_proposal_tpu_torch.ops.closest_point_cuda import (
        coarse_nearest_dot,
        nearest_vertices,
    )

    q, pts, pts_b = ref["nan_q"], ref["nan_pts"], ref["nan_pts_b"]
    want = _nearest_finite(q, pts)
    want[1, 3] = 0  # the NaN query
    assert 7 not in want
    ids = nearest_vertices(_t(q), _t(pts)).numpy()
    np.testing.assert_array_equal(ids, want)
    ids_b = nearest_vertices(_t(q), _t(pts_b)).numpy()
    np.testing.assert_array_equal(ids_b[0], want[0])  # chain 0: the NaN vertex 7
    np.testing.assert_array_equal(ids_b[1], 0)  # chain 1: nothing finite
    ids8 = coarse_nearest_dot(_t(q), surface_index.pack_points_aug(_t(pts))).numpy()
    assert 7 not in ids8 and ids8[1, 3] == 0
    np.testing.assert_array_equal(ref["nan_nv"], 2 ** 30)
    np.testing.assert_array_equal(ref["nan_nv_b"], 2 ** 30)


@pytest.mark.parametrize("case", ["sph", "fem"])
def test_face_table_rows_are_cand_tri(ref, case):
    """K4's face table, gathered by the shortlist in component-major order,
    is bitwise the reference's per-vertex corner table."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import face_table

    tri, cand, want = (ref[f"{case}_tri" if case == "sph" else "ctx_tri"],
                       ref[f"{case}_cand" if case == "sph" else "ctx_cand"],
                       ref[f"{case}_cand_tri" if case == "sph" else "ctx_cand_tri"])
    faces = face_table(_t(tri)).numpy()
    assert faces.shape == (len(tri), 12) and (faces[:, 9:] == 0).all()
    np.testing.assert_array_equal(_cand_tri(faces[:, :9].reshape(-1, 3, 3), cand), want)


def _refine_d2(q, tri, cand):
    """The twin's cascade d² [1, P, K] of queries q [1, P, 3] against the
    faces cand [1, K] of tri."""
    from icp_proposal_tpu_torch.ops.closest_point import closest_point_on_triangle

    t = _t(tri)[_t(cand[0]).long()]
    return closest_point_on_triangle(_t(q)[..., None, :], t[:, 0], t[:, 1], t[:, 2])[1]


def test_refine_shortlist_nan_rule(ref):
    """K4's NaN rule in the twin and in the interpret-mode JAX kernel: a NaN
    d² in some slots only makes slot 0 the winner.  Queries of magnitude
    1e37 overflow the cascade in some of a shortlist's 64 slots; NaN corners
    of one face make its slot NaN for every query.

    The JAX kernel writes the winner's corners as a sum of corners × one-hot
    over the slots, where 0·NaN would be NaN; XLA rewrites a product by a
    0/1 mask into a select, so the reference returns the winner's own
    corners, as the port does (here slot 0's, finite)."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import face_table, refine_shortlist

    d2 = _refine_d2(ref["rn_q"], ref["rn_tri"], ref["rn_cand"])
    some, every = torch.isnan(d2).any(-1)[0], torch.isnan(d2).all(-1)[0]
    partial = (some & ~every).numpy()
    assert partial.sum() >= 100  # the fixture does what it says
    f, w = refine_shortlist(_t(ref["rn_q"]), _t(ref["rn_coarse"]), _t(ref["rn_cand"]),
                            face_table(_t(ref["rn_tri"])))
    np.testing.assert_array_equal(f.numpy(), ref["rn_fidx"])
    np.testing.assert_array_equal(w.numpy(), ref["rn_wtri"])
    slot0 = ref["rn_cand"][0, 0]
    assert (f.numpy()[0, partial] == slot0).all()
    np.testing.assert_array_equal(w.numpy()[0, partial], ref["rn_tri"][slot0].reshape(-1)[
        None].repeat(partial.sum(), 0))
    assert (ref["rn_fidx"][0, partial] == slot0).all()

    f, w = refine_shortlist(_t(ref["rn_q_nan"]), _t(ref["rn_coarse_nan"]),
                            _t(ref["rn_cand_nan"]), face_table(_t(ref["rn_tri_nan"])))
    np.testing.assert_array_equal(f.numpy(), ref["rn_fidx_nan"])
    slot0 = ref["rn_cand_nan"][0, 0]
    assert (f.numpy() == slot0).all() and ref["rn_cand_nan"][0, 7] == 13
    np.testing.assert_array_equal(w.numpy(), ref["rn_wtri_nan"])
    np.testing.assert_array_equal(w.numpy()[0], ref["rn_tri_nan"][slot0].reshape(1, 9)
                                  .repeat(w.shape[1], 0))


def _replay_refine(d2, faces, lanes):
    """K4's merge, replayed in numpy: lane j of a query's group of ``lanes``
    keeps the least (d², face id) of its non-NaN slots j, j + L, ... and
    whether one was NaN; a butterfly over the group (xor partners, all lanes
    at once) keeps the least pair; a NaN anywhere makes slot 0's face the
    winner.  d2 [N, K] float32, faces [N, K] int32 → winning face ids [N]."""
    n, k = d2.shape
    out = np.empty(n, np.int64)
    big = np.iinfo(np.int32).max
    for i in range(n):
        bd = np.full(lanes, np.inf, np.float32)
        bf = np.full(lanes, big, np.int64)
        nan = np.zeros(lanes, bool)
        for j in range(lanes):
            for s in range(j, k, lanes):
                if np.isnan(d2[i, s]):
                    nan[j] = True
                elif (d2[i, s], faces[i, s]) < (bd[j], bf[j]):
                    bd[j], bf[j] = d2[i, s], faces[i, s]
        off = lanes // 2
        while off:
            pd, pf = bd[np.arange(lanes) ^ off], bf[np.arange(lanes) ^ off]
            take = (pd < bd) | ((pd == bd) & (pf < bf))
            bd, bf = np.where(take, pd, bd), np.where(take, pf, bf)
            off //= 2
        assert (bf == bf[0]).all() and (bd[0] == bd).all()
        out[i] = faces[i, 0] if nan.any() else bf[0]
    return out


REFINE_LANES = 4  # lanes per query (ICP_REFINE_LANES in csrc/closest_point.cu)


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
@pytest.mark.parametrize("k", [1, 31, 64, 100])
def test_refine_merge_replay(lanes, k):
    """K4's lane merge with the NaN vote gives the twin's winner (least d²,
    then the smallest face id, then the lowest slot; slot 0 where any d² is
    NaN) at K not a multiple of the lanes: small-integer d², a function of
    the face as in the kernel, so faces that repeat tie; +inf slots; rows
    with some NaN slots, one all NaN and one all +inf.  The kernel runs
    ``REFINE_LANES``; the other lane counts, which ``kernel_turns.py
    --probe`` builds and times, show that the winner does not depend on
    the lane mapping."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import refine_pick

    rng = np.random.RandomState(lanes * 1000 + k)
    n = 120
    faces = rng.randint(0, 3 * k + 2, (n, k)).astype(np.int32)
    val = rng.randint(0, 4, (n, 3 * k + 2)).astype(np.float32)
    val[rng.rand(*val.shape) < 0.1] = np.inf
    d2 = np.take_along_axis(val, faces, 1)
    nan_rows = rng.rand(n) < 0.2
    d2[nan_rows, rng.randint(0, k, n)[nan_rows]] = np.nan
    d2[0], d2[1] = np.nan, np.inf
    d2[2] = 3.0
    kidx = refine_pick(torch.as_tensor(d2), torch.as_tensor(faces))
    want = np.take_along_axis(faces, kidx.numpy(), 1)[:, 0]
    got = _replay_refine(d2, faces, lanes)
    np.testing.assert_array_equal(got, want)
    assert (want[np.isnan(d2).any(1)] == faces[np.isnan(d2).any(1), 0]).all()
    assert want[1] == faces[1].min() and want[2] == faces[2].min()


def test_refine_lanes_matches_kernel():
    """The lane count the tests name is the kernel's; the wrapper's face
    table has the kernel's row width (three float4 rows a face)."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    src = (REPO / "icp_proposal_tpu_torch" / "csrc" / "closest_point.cu").read_text()
    assert f"#define ICP_REFINE_LANES {REFINE_LANES}\n" in src
    assert "constexpr int kRefineLanes = ICP_REFINE_LANES;" in src
    assert "constexpr int kFaceRows = 3;" in src
    assert cc.face_table(torch.zeros(2, 3, 3)).shape[1] == 12


NV_GROUP = 32  # vertices per running-minimum group (kNvGroup in csrc/closest_point.cu)


def _replay_nv(queries, points, chunk, slices, pair="euclid"):
    """K3's reduction (and K8's, ``pair="dot"``), replayed in float32: per
    staged chunk of ``chunk`` vertices (padded to whole groups with the
    pair's pad rows: (+inf, +inf, +inf) or (0, 0, 0, +inf)), ``slices``
    slices of its groups; in each slice a running ``fmin`` of the pair
    values per group and a strict < to record the slice's least group
    minimum and its group; the slices merge by the least value (a lower
    slice keeps a tie); when that is strictly below the best carried from
    earlier chunks, the winning group is rescanned for the lowest id at that
    value.  queries [N, 3], points [V, 3] (euclid) or [V, 4] (dot: rows
    (−2x, −2y, −2z, ‖v‖²)) → ids [N] int64."""
    n, v = queries.shape[0], points.shape[0]
    best = torch.full((n,), float("inf"))
    bid = torch.zeros(n, dtype=torch.int64)
    for lo in range(0, v, chunk):
        rows = points[lo:lo + chunk]
        n_groups = -(-rows.shape[0] // NV_GROUP)
        pad = torch.full((n_groups * NV_GROUP - rows.shape[0], rows.shape[1]), float("inf"))
        if pair == "dot":
            pad[:, :3] = 0.0
        rows = torch.cat([rows, pad])
        if pair == "dot":
            d2 = queries[:, None, 0] * rows[None, :, 0] + queries[:, None, 1] * rows[None, :, 1]
            d2 = d2 + queries[:, None, 2] * rows[None, :, 2]
            d2 = (d2 + rows[None, :, 3]).reshape(n, n_groups, NV_GROUP)
        else:
            diff = queries[:, None, :] - rows[None]  # [N, R, 3]
            d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
            d2 = (d2 + diff[..., 2] * diff[..., 2]).reshape(n, n_groups, NV_GROUP)
        val = torch.full((n,), float("inf"))
        grp = torch.full((n,), -1, dtype=torch.int64)
        for sl in range(slices):
            s_val = torch.full((n,), float("inf"))
            s_grp = torch.full((n,), -1, dtype=torch.int64)
            for g in range(sl * n_groups // slices, (sl + 1) * n_groups // slices):
                m = torch.full((n,), float("inf"))
                for u in range(NV_GROUP):
                    m = torch.fmin(m, d2[:, g, u])
                better = m < s_val
                s_val = torch.where(better, m, s_val)
                s_grp = torch.where(better, g, s_grp)
            better = s_val < val
            val = torch.where(better, s_val, val)
            grp = torch.where(better, s_grp, grp)
        for i in torch.nonzero(val < best)[:, 0].tolist():
            hits = torch.nonzero(d2[i, grp[i]] == val[i])[:, 0]
            best[i] = val[i]
            bid[i] = lo + grp[i] * NV_GROUP + int(hits[0])
    return bid


def _adversarial_nv(v):
    """Vertices on a coarse integer lattice, with exact float32 distances:
    duplicates of a vertex at the first and last ids, across a group edge
    (31, 32) and far apart, points equidistant from the queries in different
    groups, slices and chunks, and a NaN vertex; queries at lattice points
    (exact ties) and one NaN query."""
    rng = np.random.RandomState(3)
    pts = rng.randint(-4, 5, (v, 3)).astype(np.float32)
    pts[v - 1] = pts[0]
    pts[32] = pts[31]
    pts[v // 2] = pts[5]
    pts[v // 3] = -pts[5]
    pts[11] = np.nan
    q = rng.randint(-4, 5, (60, 3)).astype(np.float32)
    q[:4] = [pts[0], pts[31], pts[5], [0, 0, 0]]
    q[7] = np.nan
    return torch.as_tensor(q), torch.as_tensor(pts)


_NV_REPLAYS = [(101, 64, 1), (101, 64, 3), (1622, 2048, 8), (333, 96, 2), (40, 2048, 8),
               (5, 2048, 8)]


@pytest.mark.parametrize("v,chunk,slices,pair", [
    *(pytest.param(*c, "euclid", id="-".join(map(str, c))) for c in _NV_REPLAYS),
    # K8 runs only the shared mode: one slice
    *(pytest.param(v, chunk, 1, "dot", id=f"dot-{v}-{chunk}")
      for v, chunk in ((101, 64), (1622, 2048), (333, 96), (5000, 2048), (40, 2048),
                       (5, 2048)))])
def test_nearest_vertices_reduction_replay(v, chunk, slices, pair):
    """The kernel's group minimum, slice merge, rescan and chunk carry give
    ``torch.argmin``'s first minimum over the finite values, ties and NaN
    included, at vertex counts that are not multiples of the group, the
    chunk or the slices; for K3's pair and for K8's dot-form pair with its
    pad rows (0, 0, 0, +inf), against K8's direct strict scan."""
    from icp_proposal_tpu_torch.ops.closest_point import coarse_nearest_dot, nearest_vertices
    from icp_proposal_tpu_torch.ops.surface_index import pack_points_aug

    q, pts = _adversarial_nv(v) if v > 32 else (
        torch.as_tensor(np.random.RandomState(v).randn(9, 3).astype(np.float32)),
        torch.as_tensor(np.random.RandomState(v + 1).randn(v, 3).astype(np.float32)))
    if pair == "dot":
        aug = pack_points_aug(pts)
        got = _replay_nv(q, aug, chunk, slices, pair)
        want = coarse_nearest_dot(q[None], aug)[0].long()
    else:
        got = _replay_nv(q, pts, chunk, slices)
        want = nearest_vertices(q[None], pts)[0].long()
    assert torch.equal(got, want)
    if v > 32:
        assert int(got[0]) == 0 and int(got[1]) == 31 and int(got[2]) == 5
        assert int(got[7]) == 0 and 11 not in got.tolist()


def test_nearest_vertices_group_matches_kernel():
    """The replay's group size is the kernel's."""
    src = (REPO / "icp_proposal_tpu_torch" / "csrc" / "closest_point.cu").read_text()
    assert f"constexpr int kNvGroup = {NV_GROUP};" in src


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_closest_point_kernels_match_plain(cuda):
    """K3 (both modes) and K4 on the card at the main path's per-chain
    shapes, against the plain twins on the same card: ids and winner
    corners bitwise equal."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc
    from icp_proposal_tpu_torch.ops.surface_index import build_surface_index

    rng = np.random.RandomState(1)
    mp, _ = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    index = build_surface_index(tp, tc, k=K, device=cuda)
    b = 16
    q = torch.as_tensor(mp[rng.randint(0, len(mp), (b, 404))]
                        + rng.randn(b, 404, 3).astype(np.float32) * 0.5, device=cuda)
    pts_b = torch.as_tensor(mp[None] + rng.randn(b, 1, 3).astype(np.float32),
                            device=cuda)
    tq = index.points[:202].expand(b, -1, -1).contiguous()
    nv = cc.nearest_vertices(q, index.points)
    torch.testing.assert_close(nv, cc.nearest_vertices_plain(q, index.points),
                               rtol=0, atol=0)
    torch.testing.assert_close(cc.nearest_vertices(tq, pts_b),
                               cc.nearest_vertices_plain(tq, pts_b), rtol=0, atol=0)
    f, w = cc.refine_shortlist(q, nv, index.cand, index.faces)
    f_p, w_p = cc.refine_shortlist_plain(q, nv, index.cand, index.faces)
    torch.cuda.synchronize()
    torch.testing.assert_close(f, f_p, rtol=0, atol=0)
    torch.testing.assert_close(w, w_p, rtol=0, atol=0)


if __name__ == "__main__":
    _jax_references(sys.argv[1])


def _nv_case(rng, b, p, v, batched, scale=10.0):
    q = (rng.randn(b, p, 3) * scale).astype(np.float32)
    shape = (b, v, 3) if batched else (v, 3)
    return q, (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_chain"])
@pytest.mark.parametrize("b,p,v", [(1, 1, 1), (1, 203, 5000), (3, 1001, 5000),
                                   (5, 202, 1622), (2, 37, 2048), (2, 2100, 300),
                                   (7, 404, 2049)])
def test_cuda_nearest_vertices_shapes(cuda, batched, b, p, v):
    """K3 in both modes against the twin, bitwise: more vertices than one
    staged chunk (2,048), P not a multiple of the queries a lane holds or
    of the block, one chain, more query units than warps (P = 2,100)."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    q, pts = (torch.as_tensor(a, device=cuda)
              for a in _nv_case(np.random.RandomState(p + v), b, p, v, batched))
    ids = cc.nearest_vertices(q, pts)
    torch.cuda.synchronize()
    assert torch.equal(ids, cc.nearest_vertices_plain(q, pts))


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_chain"])
@pytest.mark.parametrize("v", [101, 1622, 5000])
def test_cuda_nearest_vertices_ties_and_nan(cuda, batched, v):
    """The adversarial lattice of the replay (duplicates at the first and
    last id and across a group edge, equidistant vertices, a NaN vertex, a
    NaN query), per chain with one all-NaN set; and the tie fixture."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    q, pts = _adversarial_nv(v)
    q = q[None].expand(3, -1, -1).contiguous().to(cuda)
    pts = pts.to(cuda)
    if batched:
        pts = torch.stack([pts, pts.flip(0), torch.full_like(pts, float("nan"))])
    ids = cc.nearest_vertices(q, pts)
    torch.cuda.synchronize()
    assert torch.equal(ids, cc.nearest_vertices_plain(q, pts))
    assert int(ids[0, 0]) == 0 and int(ids[0, 1]) == 31 and int(ids[0, 7]) == 0
    if batched:
        assert torch.equal(ids[2], torch.zeros_like(ids[2]))
    tie = _tie_fixture()
    ids = cc.nearest_vertices(torch.as_tensor(tie["tie_vq"], device=cuda),
                              torch.as_tensor(tie["tie_verts"], device=cuda))
    assert ids.tolist() == [[0, 1, 0, 3, 5]]


@pytest.mark.cuda
def test_cuda_nearest_vertices_config(cuda):
    """The launch at the femur step's shapes: a shared set in Q = 4 units
    over the flat query list, staged once (one buffer); per chain one unit
    of Q = 7 for P = 202, two buffers and the slice-merge area; blocks no
    more than the SMs hold."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shared = cc.nearest_vertices_config(2048, 404, 1622, False)
    per_chain = cc.nearest_vertices_config(2048, 202, 1622, True)
    assert shared["q"] == 4 and per_chain["q"] == 7
    assert shared["smem_bytes"] == 1632 * 16
    # two chunk buffers; the slices' minima and groups ([8 warps][224]) and
    # the carried best and id of the unit ([224])
    assert per_chain["smem_bytes"] == 2 * 1632 * 16 + (8 + 1) * 224 * 8
    for cfg in (shared, per_chain):
        assert cfg["threads"] == 256 and cfg["ctas_per_sm"] >= 1
        assert cfg["blocks"] <= sms * cfg["ctas_per_sm"]


def _refine_on_card(cuda, q, coarse, cand, tri):
    """K4 against its twin on the card, bitwise, through the wrapper."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    q, coarse, cand, tri = (torch.as_tensor(np.asarray(x), device=cuda)
                            for x in (q, coarse, cand, tri))
    faces = cc.face_table(tri)
    n0 = cc.refine_shortlist.launches
    f, w = cc.refine_shortlist(q, coarse, cand, faces)
    f_p, w_p = cc.refine_shortlist_plain(q, coarse, cand, faces)
    torch.cuda.synchronize()
    assert cc.refine_shortlist.launches == n0 + 1
    assert torch.equal(f, f_p) and torch.equal(w.view(torch.int32), w_p.view(torch.int32))
    return f, w


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 64, 100])
def test_cuda_refine_shortlist_k(cuda, k):
    """K4 at K not a multiple of the lanes, on the stand-in femur target's
    own K-nearest shortlists, 8 chains × 404 queries."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc
    from icp_proposal_tpu_torch.ops.surface_index import build_surface_index

    rng = np.random.RandomState(k)
    mp, _ = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    index = build_surface_index(tp, tc, k=k, device=cuda)
    q = torch.as_tensor(mp[rng.randint(0, len(mp), (8, 404))]
                        + rng.randn(8, 404, 3).astype(np.float32) * 0.5, device=cuda)
    nv = cc.nearest_vertices(q, index.points)
    _refine_on_card(cuda, q.cpu(), nv.cpu(), index.cand.cpu(), index.tri.cpu())


@pytest.mark.cuda
def test_cuda_refine_shortlist_large_surface_and_clamps(cuda):
    """K4 has no size limit: 25,000 random faces (a 300 KB table, more than
    L1 holds), random K = 64 shortlists over them; out-of-range coarse rows
    and face ids clamp as in the twin."""
    rng = np.random.RandomState(7)
    f, v, k = 25000, 3000, 64
    tri = (rng.randn(f, 3, 3) * 30).astype(np.float32)
    cand = rng.randint(0, f, (v, k)).astype(np.int32)
    cand[5, [3, 40]] = [-7, f + 11]
    q = (rng.randn(6, 500, 3) * 40).astype(np.float32)
    coarse = rng.randint(0, v, (6, 500)).astype(np.int32)
    coarse[0, :4] = [-1, v, v + 1000, 5]
    fidx, _ = _refine_on_card(cuda, q, coarse, cand, tri)
    assert fidx.min() >= -7 and fidx.max() <= f + 11


@pytest.mark.cuda
def test_cuda_refine_shortlist_nan_rule(cuda):
    """K4's NaN rule on the card: the partial-NaN queries of magnitude 1e37
    and the NaN-corner face give slot 0, as the twin and the reference."""
    rn = _refine_nan_fixture()
    f, _ = _refine_on_card(cuda, rn["rn_q"], rn["rn_coarse"], rn["rn_cand"], rn["rn_tri"])
    d2 = _refine_d2(rn["rn_q"], rn["rn_tri"], rn["rn_cand"])
    partial = (torch.isnan(d2).any(-1) & ~torch.isnan(d2).all(-1))[0]
    assert int(partial.sum()) >= 100
    assert (f.cpu()[0, partial] == int(rn["rn_cand"][0, 0])).all()
    f, _ = _refine_on_card(cuda, rn["rn_q_nan"], rn["rn_coarse_nan"], rn["rn_cand_nan"],
                           rn["rn_tri_nan"])
    assert (f.cpu() == int(rn["rn_cand_nan"][0, 0])).all()


@pytest.mark.cuda
def test_cuda_refine_shortlist_config(cuda):
    """K4's launch at the femur step's shapes: kRefineLanes lanes a query,
    256 threads, one block per 256 / lanes queries."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    cfg = cc.refine_shortlist_config(2048 * 404)
    assert cfg["lanes"] == REFINE_LANES and cfg["threads"] == 256
    assert cfg["blocks"] == -(-2048 * 404 * REFINE_LANES // 256)
    assert cfg["ctas_per_sm"] >= 1 and cfg["registers"] > 0
