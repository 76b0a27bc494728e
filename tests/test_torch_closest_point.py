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
