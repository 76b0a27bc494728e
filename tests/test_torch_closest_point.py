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

REPO = Path(__file__).resolve().parents[1]
STANDIN = REPO / "artifacts" / "posterior"
K = 64


def _tie_fixture():
    """Small-integer geometry, so every d² below is exact in float32.

    K3: vertices 0 and 2 coincide, as do 1 and 4; vertices 5 and 6 are
    equidistant from the last query.  K4: one query row whose shortlist holds
    the same triangle T as face 9 (slot 5), as face 7 (slot 10) and as face 7
    again with its corners rotated (slot 20): the smallest face id wins over
    the lower slot, then the lowest slot wins within face 7.  A second row
    adds a strictly closer face 50 at slot 30, which wins over all."""
    verts = np.array([[0, 0, 0], [4, 0, 0], [0, 0, 0], [0, 4, 0], [4, 0, 0],
                      [10, 1, 0], [10, -1, 0]], np.float32)
    vq = np.array([[[0, 0, 1], [4, 1, 0], [0, 0, 0], [0, 3, 0], [10, 0, 0]]],
                  np.float32)
    a, b, c = [0, 0, 0], [4, 0, 0], [0, 4, 0]
    far = np.array([[40, 40, 40], [44, 40, 40], [40, 44, 40]], np.float32)
    close = np.array([[0, 0, 1.5], [4, 0, 1.5], [0, 4, 1.5]], np.float32)
    cand = 100 + np.tile(np.arange(K, dtype=np.int32), (2, 1))
    tris = np.tile(far, (2, K, 1, 1)) + np.arange(K, dtype=np.float32)[None, :, None,
                                                                          None]
    for row in (0, 1):
        cand[row, [5, 10, 20]] = [9, 7, 7]
        tris[row, 5] = tris[row, 10] = [a, b, c]
        tris[row, 20] = [b, c, a]
    cand[1, 30] = 50
    tris[1, 30] = close
    cand_tri = np.ascontiguousarray(
        tris.transpose(0, 2, 3, 1).reshape(2, 9 * K).astype(np.float32))
    rq = np.array([[[1, 1, 2], [1, 1, 2]]], np.float32)  # rows 0 and 1
    coarse = np.array([[0, 1]], np.int32)
    return dict(tie_verts=verts, tie_vq=vq, tie_cand=cand, tie_cand_tri=cand_tri,
                tie_rq=rq, tie_coarse=coarse)


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
    from icp_proposal_tpu_torch.ops.closest_point_cuda import refine_shortlist

    q, coarse, cand, cand_tri, fidx, wtri = {
        "sph": ("sph_q", "sph_nv", "sph_cand", "sph_cand_tri", "sph_fidx", "sph_wtri"),
        "fem": ("fem_q", "fem_nv", "ctx_cand", "ctx_cand_tri", "fem_fidx", "fem_wtri"),
        "tie": ("tie_rq", "tie_coarse", "tie_cand", "tie_cand_tri", "tie_fidx",
                "tie_wtri"),
    }[case]
    got_f, got_w = refine_shortlist(_t(ref[q]), _t(ref[coarse], torch.int32),
                                    _t(ref[cand], torch.int32), _t(ref[cand_tri]))
    np.testing.assert_array_equal(got_f.numpy(), ref[fidx])
    np.testing.assert_array_equal(got_w.numpy(), ref[wtri])
    if case == "tie":
        # row 0: faces 9 and 7 tie on d² → face 7; slots 10 and 20 of face 7
        # tie → slot 10, whose corners are in (a, b, c) order; row 1: the
        # strictly closer face 50 wins
        np.testing.assert_array_equal(got_f.numpy(), [[7, 50]])
        np.testing.assert_array_equal(got_w.numpy()[0, 0],
                                      [0, 0, 0, 4, 0, 0, 0, 4, 0])


def test_index_closest_matches_jax(ref):
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.ops.surface_index import index_closest

    ctx = convert.context_from_arrays(
        *(ref[f"ctx_{n}"] for n in ("points", "cells", "tri", "boundary",
                                    "cand", "cand_tri")), device="cpu")
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
    np.testing.assert_array_equal(ctx.index.cand_tri.numpy(), ref["ctx_cand_tri"])


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


NV_GROUP = 32  # vertices per running-minimum group (kNvGroup in csrc/closest_point.cu)


def _replay_nv(queries, points, chunk, slices):
    """K3's reduction, replayed in float32: per staged chunk of ``chunk``
    vertices (padded to whole groups with +inf rows), ``slices`` slices of
    its groups; in each slice a running ``fmin`` of the pair values per
    group and a strict < to record the slice's least group minimum and its
    group; the slices merge by the least value (a lower slice keeps a tie);
    when that is strictly below the best carried from earlier chunks, the
    winning group is rescanned for the lowest id at that value.
    queries [N, 3], points [V, 3] → ids [N] int64."""
    n, v = queries.shape[0], points.shape[0]
    best = torch.full((n,), float("inf"))
    bid = torch.zeros(n, dtype=torch.int64)
    for lo in range(0, v, chunk):
        rows = points[lo:lo + chunk]
        n_groups = -(-rows.shape[0] // NV_GROUP)
        pad = torch.full((n_groups * NV_GROUP - rows.shape[0], 3), float("inf"))
        rows = torch.cat([rows, pad])
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


@pytest.mark.parametrize("v,chunk,slices", [(101, 64, 1), (101, 64, 3), (1622, 2048, 8),
                                            (333, 96, 2), (40, 2048, 8), (5, 2048, 8)])
def test_nearest_vertices_reduction_replay(v, chunk, slices):
    """The kernel's group minimum, slice merge, rescan and chunk carry give
    ``torch.argmin``'s first minimum over the finite values, ties and NaN
    included, at vertex counts that are not multiples of the group, the
    chunk or the slices."""
    from icp_proposal_tpu_torch.ops.closest_point import nearest_vertices

    q, pts = _adversarial_nv(v) if v > 32 else (
        torch.as_tensor(np.random.RandomState(v).randn(9, 3).astype(np.float32)),
        torch.as_tensor(np.random.RandomState(v + 1).randn(v, 3).astype(np.float32)))
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
    f, w = cc.refine_shortlist(q, nv, index.cand, index.cand_tri)
    f_p, w_p = cc.refine_shortlist_plain(q, nv, index.cand, index.cand_tri)
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
