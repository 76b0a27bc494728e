"""K8 ``coarse_nearest_dot`` and the shortlist index under ``coarse="dot"``:
the port's plain twin against the JAX package's dot-form coarse kernel
(``_coarse_mxu_call``, interpret mode), the index against the JAX index
with ``ICP_TPU_COARSE_MXU=1``, the dense path of a context without an index
against the JAX dense kernel, and the CUDA kernel against its twin where a
card is present.

The JAX references come from a child process whose XLA targets SSE4.2 (no
FMA), as in ``test_torch_closest_point.py``.  Even so, XLA's float32 dot
sums in its own order, so near-tied anchors may differ from the twin's
((qx·ax + qy·ay) + qz·az) + ‖v‖²: ids are held to the reference's near-tie
contract, a differing anchor's true d² within 2⁻²¹·(‖q‖ + maxᵥ‖v‖)² of the
exact minimum (about 0.1 mm² at femur scale; closest_point_pallas.py:449-457
records 3.3e-3 mm²).  Run as a script, this file is that child:

    python tests/test_torch_coarse_dot.py OUT.npz
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
GAP_ULPS = 2.0 ** -21


def _jax_references(out_path):
    """The child: inputs from a fixed numpy seed, references from the JAX
    package's interpret-mode kernels; everything goes to one .npz."""
    os.environ["ICP_TPU_COARSE_MXU"] = "1"  # read when index_closest traces
    os.environ["ICP_TPU_FORCE_PALLAS"] = "1"  # the dense path takes its kernel
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import make_mesh
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu.ops import closest_point_pallas as cpp
    from icp_proposal_tpu.ops.closest_point import closest_points_on_surface
    from icp_proposal_tpu.ops.surface_index import index_closest
    from icp_proposal_tpu.sampling.context import build_target_context

    def dot_ids(q, pts):
        return np.asarray(cpp._coarse_mxu_call(
            jnp.asarray(q), cpp.pack_points_aug(jnp.asarray(pts)), interpret=True))

    rng = np.random.RandomState(0)
    out = {}
    mp, _ = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    for name, pts in (("mean", mp), ("map", tp)):
        out[f"aug_{name}"] = np.asarray(cpp.pack_points_aug(jnp.asarray(pts)))
    # stand-in femur: 4 chains × 404 queries near the target
    ctx = build_target_context(make_mesh(tp, tc), build_index=True)
    for name in ("points", "cells", "tri", "boundary"):
        out[f"ctx_{name}"] = np.asarray(getattr(ctx, name))
    out["ctx_cand"], out["ctx_cand_tri"] = ctx.index.cand, ctx.index.cand_tri
    out["fem_q"] = (mp[rng.randint(0, len(mp), (4, 404))]
                    + rng.randn(4, 404, 3) * 2.0).astype(np.float32)
    out["fem_ids"] = dot_ids(out["fem_q"], ctx.points)
    cp, d2, fidx = jax.vmap(lambda q: index_closest(ctx.index, q))(
        jnp.asarray(out["fem_q"]))
    out["ic_cp"], out["ic_d2"], out["ic_fidx"] = map(np.asarray, (cp, d2, fidx))
    # the dense path (no index): interpret-mode dense kernel
    cp, d2, fidx = jax.vmap(lambda q: closest_points_on_surface(q, jnp.asarray(ctx.tri)))(
        jnp.asarray(out["fem_q"]))
    out["dense_cp"], out["dense_d2"], out["dense_fidx"] = map(np.asarray, (cp, d2, fidx))
    # small: V = 52 (not a multiple of 128), vertices 42..51 repeat 0..9
    sp, _ = make_icosphere(subdivisions=1, radius=10.0)
    sp = np.asarray(sp, np.float32)
    out["small_points"] = np.concatenate([sp, sp[:10]]).astype(np.float32)
    out["small_q"] = (rng.randn(3, 61, 3) * 12).astype(np.float32)
    out["small_ids"] = dot_ids(out["small_q"], out["small_points"])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dot_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               ICP_TPU_NO_NATIVE="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _gaps_over_bound(q, points, ids):
    """Per query: (d² of vertex ``ids`` − the exact minimum d²) over the
    rounding bound GAP_ULPS·(‖q‖ + maxᵥ‖v‖)², in float64."""
    q64, p64 = q.astype(np.float64), points.astype(np.float64)
    d2 = ((q64[..., :, None, :] - p64) ** 2).sum(-1)  # [B, P, V]
    got = np.take_along_axis(d2, ids[..., None].astype(np.int64), -1)[..., 0]
    bound = GAP_ULPS * (np.linalg.norm(q64, axis=-1)
                        + np.linalg.norm(p64, axis=-1).max()) ** 2
    return (got - d2.min(-1)) / bound


@pytest.mark.parametrize("mesh", ["mean", "map"])
def test_pack_points_aug_is_bitwise_the_reference(ref, mesh):
    """[V, 4] rows (−2x, −2y, −2z, ‖v‖²), the reference's [8, Vp] table's
    first four rows transposed, without its padding."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.ops.surface_index import pack_points_aug

    pts, _ = read_stl(STANDIN / f"{mesh}.stl")
    aug = pack_points_aug(_t(pts)).numpy()
    want = ref[f"aug_{mesh}"]
    assert aug.shape == (len(pts), 4) and aug.dtype == np.float32
    np.testing.assert_array_equal(aug, want[:4, :len(pts)].T)
    assert (want[3, len(pts):] == 1e30).all()  # the reference pads; the port does not


@pytest.mark.parametrize("case", ["fem", "small"])
def test_coarse_nearest_dot_plain_matches_pallas(ref, case):
    """The twin against the interpret-mode dot-form kernel: ≥ 99 % of ids
    equal, and every anchor within the near-tie bound of the exact nearest
    vertex."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import coarse_nearest_dot
    from icp_proposal_tpu_torch.ops.surface_index import pack_points_aug

    q, pts = (ref["fem_q"], ref["ctx_points"]) if case == "fem" else (
        ref["small_q"], ref["small_points"])
    ids = coarse_nearest_dot(_t(q), pack_points_aug(_t(pts)))
    assert ids.dtype == torch.int32 and ids.shape == q.shape[:2]
    want = ref[f"{case}_ids"]
    assert (ids.numpy() == want).mean() >= 0.99
    assert _gaps_over_bound(q, pts, ids.numpy()).max() <= 1.0
    assert _gaps_over_bound(q, pts, want).max() <= 1.0
    if case == "small":  # duplicated vertices: the lower id of a pair wins
        assert (ids.numpy() < 42).all()


def test_coarse_nearest_dot_plain_against_exact_nearest_vertices(ref):
    """The dot form against the exact subtractive form (K3's twin) on the
    same queries: ≥ 99 % of anchors equal, the rest within the bound."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import (
        coarse_nearest_dot,
        nearest_vertices,
    )
    from icp_proposal_tpu_torch.ops.surface_index import pack_points_aug

    q, pts = _t(ref["fem_q"]), _t(ref["ctx_points"])
    ids = coarse_nearest_dot(q, pack_points_aug(pts)).numpy()
    exact = nearest_vertices(q, pts).numpy()
    assert (ids == exact).mean() >= 0.99
    assert _gaps_over_bound(ref["fem_q"], ref["ctx_points"], ids).max() <= 1.0


def test_index_closest_dot_matches_jax(ref):
    """index_closest under coarse="dot" against the JAX index with
    ICP_TPU_COARSE_MXU=1: d² to rtol 1e-5, face ids equal wherever the two
    coarse anchors agree."""
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.ops.closest_point_cuda import coarse_nearest_dot
    from icp_proposal_tpu_torch.ops.surface_index import index_closest

    ctx = convert.context_from_arrays(
        *(ref[f"ctx_{n}"] for n in ("points", "cells", "tri", "boundary", "cand")),
        coarse="dot", device="cpu")
    assert ctx.index.coarse == "dot"
    q = _t(ref["fem_q"])
    cp, d2, fidx = index_closest(ctx.index, q)
    same = coarse_nearest_dot(q, ctx.index.points_aug).numpy() == ref["fem_ids"]
    np.testing.assert_array_equal(fidx.numpy()[same], ref["ic_fidx"][same])
    np.testing.assert_allclose(d2.numpy(), ref["ic_d2"], rtol=1e-5)
    np.testing.assert_allclose(cp.numpy()[same], ref["ic_cp"][same], rtol=1e-5, atol=1e-4)


def test_dense_path_without_index_matches_jax(ref):
    """A context without an index sends closest-point queries to the dense
    kernel K5: face ids exactly and d² bitwise those of the JAX package's
    dense kernel, the closest points to rtol 1e-5."""
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.ops.surface_index import closest_auto, distances_auto

    ctx = convert.context_from_arrays(
        *(ref[f"ctx_{n}"] for n in ("points", "cells", "tri", "boundary")), device="cpu")
    assert ctx.index is None
    q = _t(ref["fem_q"])
    cp, d2, fidx = closest_auto(q, ctx.points, ctx.cells, ctx.index)
    np.testing.assert_array_equal(fidx.numpy(), ref["dense_fidx"])
    np.testing.assert_array_equal(d2.numpy(), ref["dense_d2"])
    np.testing.assert_allclose(cp.numpy(), ref["dense_cp"], rtol=1e-5, atol=1e-5)
    d2_only, fidx_only = distances_auto(q, ctx.points, ctx.cells, ctx.index)
    assert torch.equal(d2_only, d2) and torch.equal(fidx_only, fidx)


def test_coarse_nearest_dot_refuses_what_the_kernel_does_not_take():
    from icp_proposal_tpu_torch.ops.closest_point_cuda import coarse_nearest_dot

    q, aug = torch.zeros(2, 5, 3), torch.ones(7, 4)
    with pytest.raises(ValueError, match="shared"):
        coarse_nearest_dot(q, aug.expand(2, 7, 4).contiguous())  # per-chain surfaces
    with pytest.raises(ValueError):
        coarse_nearest_dot(q.double(), aug)
    with pytest.raises(ValueError):
        coarse_nearest_dot(q, aug.double())
    with pytest.raises(ValueError):
        coarse_nearest_dot(q, torch.ones(7, 3))  # not an augmented table
    with pytest.raises(ValueError):
        coarse_nearest_dot(q[0], aug)  # no chain dimension
    with pytest.raises(ValueError):
        coarse_nearest_dot(q, torch.ones(0, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_coarse_nearest_dot_matches_plain(cuda):
    """K8 on the card at the femur path's shapes (P = 404 vs 1,622 target
    vertices, 16 chains) and at V = 5,000 (three shared-memory tiles):
    ids identical to the plain twin on the same card."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc
    from icp_proposal_tpu_torch.ops.surface_index import pack_points_aug

    rng = np.random.RandomState(3)
    mp, _ = read_stl(STANDIN / "mean.stl")
    tp, _ = read_stl(STANDIN / "map.stl")
    q = torch.as_tensor(mp[rng.randint(0, len(mp), (16, 404))]
                        + rng.randn(16, 404, 3).astype(np.float32) * 2.0, device=cuda)
    big = (rng.randn(5000, 3) * 50).astype(np.float32)
    n0 = cc.coarse_nearest_dot.launches
    for pts in (tp, big):
        aug = pack_points_aug(torch.as_tensor(pts, device=cuda))
        got = cc.coarse_nearest_dot(q, aug)
        want = cc.coarse_nearest_dot_plain(q, aug)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert cc.coarse_nearest_dot.launches == n0 + 2


if __name__ == "__main__":
    _jax_references(sys.argv[1])


@pytest.mark.cuda
def test_cuda_coarse_nearest_dot_ties_nan_and_many_chains(cuda):
    """K8 on K3's scan against its twin, bitwise: the integer lattice of K3's
    replay (duplicated vertices at the first and last id and across a group
    edge, equidistant vertices, a NaN vertex, a NaN query) at V = 101, 1,622
    and 5,000 (more than one staged chunk); and 70,000 chains of one query,
    past the old kernel's 65,535-chain grid limit."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc
    from icp_proposal_tpu_torch.ops.surface_index import pack_points_aug
    from test_torch_closest_point import _adversarial_nv

    for v in (101, 1622, 5000):
        q, pts = _adversarial_nv(v)
        q = q[None].expand(3, -1, -1).contiguous().to(cuda)
        aug = pack_points_aug(pts.to(cuda))
        ids = cc.coarse_nearest_dot(q, aug)
        torch.cuda.synchronize()
        assert torch.equal(ids, cc.coarse_nearest_dot_plain(q, aug))
        assert int(ids[0, 0]) == 0 and int(ids[0, 1]) == 31 and int(ids[0, 7]) == 0
    rng = np.random.RandomState(9)
    q = torch.as_tensor((rng.randn(70000, 1, 3) * 30).astype(np.float32), device=cuda)
    aug = pack_points_aug(torch.as_tensor((rng.randn(1622, 3) * 30).astype(np.float32),
                                          device=cuda))
    ids = cc.coarse_nearest_dot(q, aug)
    torch.cuda.synchronize()
    assert torch.equal(ids, cc.coarse_nearest_dot_plain(q, aug))


@pytest.mark.cuda
def test_cuda_coarse_nearest_dot_config(cuda):
    """K8's launch at the registration step's shapes: K3's shared mode with
    the dot pair, the [V, 4] rows staged once (one buffer)."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cc

    cfg = cc.nearest_vertices_config(2048, 404, 1622, False, dot=True)
    assert cfg["threads"] == 256 and cfg["smem_bytes"] == 1632 * 16
    assert 1 <= cfg["q"] <= 8 and cfg["ctas_per_sm"] >= 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cfg["blocks"] <= sms * cfg["ctas_per_sm"]
    with pytest.raises(RuntimeError):
        cc.nearest_vertices_config(2048, 404, 1622, True, dot=True)
