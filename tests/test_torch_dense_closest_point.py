"""K5 ``surface_distances``: the port's plain version against the JAX
package's dense Pallas kernel (``_dist2_call``, interpret mode), and the
CUDA kernel against the plain version where a card is present.

Ids must match exactly, so both sides must round alike: the JAX references
come from a child process whose XLA targets SSE4.2, which has no FMA
(``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``), as in
``test_torch_closest_point.py``.  Run as a script, this file is that child:

    python tests/test_torch_dense_closest_point.py OUT.npz
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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


if __name__ == "__main__":
    _jax_references(sys.argv[1])
