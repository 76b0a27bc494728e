"""The port's MALA, scale adaptation and their femur setups against the
JAX package's, at the full stand-in width (rank 101), and the gradient
route through the closest-point index.

Step parity reuses ``test_torch_mh``'s harness: the JAX step runs its Pallas
kernels in interpret mode, the port its plain twins; each port step starts
from the JAX carry (MALA's gradient anchors and the adaptive log-scales
included) and takes the JAX step's own noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_mh import N_CHAINS, N_STEPS, STANDIN, _step_parity


@pytest.mark.parametrize("setup", ["hybrid", "mala", "rw-adapt"])
def test_step_parity_adaptive_setups(monkeypatch, setup):
    """4 chains × 5 steps of each setup: same proposal index, same clear
    decisions, log_product and log_post to rtol 1e-4, log-scales and step
    counts to atol 1e-6, MALA's gradient to ``jax.grad`` (rtol 1e-4 where
    |g| > 1, atol 1e-4 below, the same zeroed entries)."""
    compared, accepted = _step_parity(monkeypatch, setup, "exact", N_STEPS)
    assert compared >= N_CHAINS * N_STEPS - 2  # near-ties are rare
    assert 0 < accepted < N_CHAINS * N_STEPS  # both decisions were exercised


def _sphere():
    """The JAX package's MH-test sphere: icosphere (2 subdivisions, radius
    50), synthetic GPMM of rank 6 (σ 40, scale 5), target at α = (1.5, −1,
    0, …) (``tests/test_mh.py``)."""
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jmodel = make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0)
    alpha = jnp.zeros(6).at[0].set(1.5).at[1].set(-1.0)
    return jmodel, np.asarray(jgp.instance_points(jmodel, alpha)), alpha


def _standin_target(monkeypatch):
    """The stand-in femur target (``artifacts/posterior/map.stl``), with the
    JAX package's index build on its numpy path, as the port's."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.mesh import make_mesh

    monkeypatch.setenv("ICP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr("icp_proposal_tpu.native._lib", None)
    return make_mesh(*read_stl(STANDIN / "map.stl"))


def _port_model(jmodel):
    from icp_proposal_tpu_torch import convert

    return convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                       jmodel._asdict().items()}, device="cpu")


def test_update_scales_matches_jax():
    """``MixtureProgram.update_scales`` on hand-made inputs (log-scales,
    step counts before and after ``adapt_steps``, every component selected,
    log α of −inf, < 0, 0 and > 0) against JAX's, vmapped over chains; an
    ICP component never adapts, MALA targets 0.574."""
    from icp_proposal_tpu.mesh import boundary_vertex_mask
    from icp_proposal_tpu.mesh import make_mesh as jmake_mesh
    from icp_proposal_tpu.sampling import proposals as jprop
    from icp_proposal_tpu.sampling.context import build_target_context as jctx_of
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.sampling import proposals as pprop
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    jmodel, tpoints, _ = _sphere()
    cells = np.asarray(jmodel.cells)
    boundary = boundary_vertex_mask(cells, jmodel.num_points)
    model = _port_model(jmodel)
    specs = [("IcpSpec", dict(direction="model", n_points=20)), ("MalaSpec", {}),
             ("RandomShapeSpec", dict(sigma=0.3)), ("RotationSpec", dict(axis=1)),
             ("TranslationSpec", dict(axis=2))]
    cfg = dict(target=0.3, rate=0.7, decay=0.6, adapt_steps=5)
    jmix = jprop.MixtureProgram(
        [(1.0, getattr(jprop, c)(**kw)) for c, kw in specs], jmodel,
        jctx_of(jmake_mesh(tpoints, cells)), boundary, adapt=jprop.AdaptConfig(**cfg))
    pmix = pprop.MixtureProgram(
        [(1.0, getattr(pprop, c)(**kw)) for c, kw in specs], model,
        build_target_context(make_mesh(tpoints, cells), device="cpu"), boundary,
        adapt=pprop.AdaptConfig(**cfg))
    np.testing.assert_array_equal(pmix.adaptable, jmix.adaptable)
    np.testing.assert_array_equal(pmix.adapt_targets, jmix.adapt_targets)

    rng = np.random.RandomState(0)
    n = 40
    log_scales = rng.randn(n, len(specs)).astype(np.float32) * 0.5
    step_idx = rng.choice([0.0, 1.0, 3.0, 4.0, 5.0, 6.0, 250.0], n).astype(np.float32)
    selected = np.arange(n) % len(specs)
    log_alpha = rng.choice([-np.inf, -7.0, -1.3, -0.2, 0.0, 0.4, 3.0], n).astype(
        np.float32)
    want = jax.vmap(jmix.update_scales)(log_scales, step_idx, selected, log_alpha)
    got = pmix.update_scales(*(torch.as_tensor(x) for x in (log_scales, step_idx,
                                                            selected, log_alpha)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not np.array_equal(got.numpy(), log_scales)  # something adapted
    unchanged = np.zeros_like(log_scales, bool)
    unchanged[:, 0] = True  # ICP
    unchanged[step_idx >= 5] = True  # frozen after adapt_steps
    np.testing.assert_array_equal(got.numpy()[unchanged], log_scales[unchanged])


def test_index_closest_gradient_route(monkeypatch):
    """Queries that require grad through the port's ``index_closest`` on the
    CPU: K3 and K4's plain twins see detached queries and return outputs
    without ``grad_fn``; the gradient is the winner recompute's alone and
    equals ``jax.grad`` of JAX's ``index_closest`` (interpret-mode kernels)
    on the same queries, on the rows whose winning face agrees (near-tie
    ids may differ: XLA's CPU backend fuses a·b + c).  A kernel wrapper
    given a tensor that requires grad raises."""
    from icp_proposal_tpu.ops import surface_index as jsi
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cpc
    from icp_proposal_tpu_torch.ops import surface_index as psi
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    ctx = build_target_context(_standin_target(monkeypatch), device="cpu")
    jindex = jsi.build_surface_index(np.asarray(ctx.points), np.asarray(ctx.cells), k=64)
    np.testing.assert_array_equal(ctx.index.cand.numpy(), jindex.cand)

    seen = []
    for name in ("nearest_vertices_plain", "refine_shortlist_plain"):
        def spy(*args, _f=getattr(cpc, name)):
            out = _f(*args)
            seen.append((args, out if isinstance(out, tuple) else (out,)))
            return out
        monkeypatch.setattr(cpc, name, spy)

    rng = np.random.RandomState(5)
    pts = np.asarray(ctx.points)
    q = (pts[rng.randint(0, len(pts), 300)] + rng.randn(300, 3) * 2.0).astype(np.float32)
    w_cp = rng.randn(300, 3).astype(np.float32)
    w_d2 = rng.rand(300).astype(np.float32)

    queries = torch.tensor(q[None], requires_grad=True)
    cp, d2, fidx = psi.index_closest(ctx.index, queries)
    loss = torch.sum(cp[0] * torch.as_tensor(w_cp)) + torch.sum(d2[0] * torch.as_tensor(w_d2))
    (grad,) = torch.autograd.grad(loss, queries)
    assert len(seen) == 2
    for args, outs in seen:
        assert not any(a.requires_grad for a in args)
        assert all(o.grad_fn is None for o in outs)

    def jloss(qq):
        jcp, jd2, _ = jsi.index_closest(jindex, qq)
        return jnp.sum(jcp * w_cp) + jnp.sum(jd2 * w_d2)

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    jfidx = np.asarray(jsi.index_closest(jindex, jnp.asarray(q))[2])
    same = fidx[0].numpy() == jfidx
    assert same.mean() > 0.98
    np.testing.assert_allclose(grad[0].numpy()[same], jgrad[same], rtol=1e-4, atol=1e-4)

    with pytest.raises(RuntimeError, match="no backward"):
        cpc.nearest_vertices(queries, ctx.index.points)
    with torch.no_grad():  # outside grad mode a kernel may take any tensor
        cpc.nearest_vertices(queries, ctx.index.points)


def test_index_distances_and_validate_index_match_jax(monkeypatch):
    """``index_distances`` and ``validate_index`` on the stand-in target
    against JAX's (interpret-mode kernels): d² to 1e-5 relative; the same
    share of mismatched queries, the largest error to 1e-5 and the largest
    relative error to 1e-4 (the reference's CPU dot fuses a·b + c, so its
    own rounding shows where the port's index and dense pass agree
    bitwise)."""
    from icp_proposal_tpu.ops import surface_index as jsi
    from icp_proposal_tpu_torch.ops import surface_index as psi
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    ctx = build_target_context(_standin_target(monkeypatch), device="cpu")
    jindex = jsi.build_surface_index(np.asarray(ctx.points), np.asarray(ctx.cells), k=64)
    rng = np.random.RandomState(6)
    pts = np.asarray(ctx.points)
    for spread in (1.0, 30.0):  # near the surface, and far from it
        q = (pts[rng.randint(0, len(pts), 256)]
             + rng.randn(256, 3) * spread).astype(np.float32)
        d2, _ = psi.index_distances(ctx.index, torch.as_tensor(q[None]))
        jd2, _ = jsi.index_distances(jindex, jnp.asarray(q))
        np.testing.assert_allclose(d2[0].numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-6)
        got = psi.validate_index(ctx.index, q, with_rel=True)
        want = jsi.validate_index(jindex, q, with_rel=True)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
        assert got[2] == want[2]
        assert psi.validate_index(ctx.index, q) == (got[0], got[2])


def test_build_evaluator_and_accept_all_match_jax():
    """``build_evaluator`` with and without the prior and ``accept_all`` on
    the sphere: the reference's ``named_keys`` ("prior" only with the
    prior) and values (dense closest point in both packages) to rtol 1e-5."""
    from icp_proposal_tpu.mesh import make_mesh as jmake_mesh
    from icp_proposal_tpu.sampling import evaluators as jev
    from icp_proposal_tpu.sampling.context import build_target_context as jctx_of
    from icp_proposal_tpu.sampling.state import init_state as jinit_state
    from icp_proposal_tpu.sampling.state import transformed_points as jtp
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.sampling import evaluators as pev
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.state import init_state, transformed_points

    jmodel, tpoints, _ = _sphere()
    model = _port_model(jmodel)
    cells = np.asarray(jmodel.cells)
    jctx = jctx_of(jmake_mesh(tpoints, cells), build_index=False)
    ctx = build_target_context(make_mesh(tpoints, cells), build_index=False, device="cpu")
    coeffs = np.random.RandomState(1).randn(3, model.rank).astype(np.float32)
    spec = dict(sigma=2.0, mode="symmetric", n_points=40)
    cases = [
        (jev.accept_all(jmodel, jctx), pev.accept_all(model, ctx)),
        (jev.build_evaluator(jmodel, jctx, [jev.IndependentPointsSpec(**spec)],
                             include_prior=False),
         pev.build_evaluator(model, ctx, [pev.IndependentPointsSpec(**spec)],
                             include_prior=False)),
        (jev.build_evaluator(jmodel, jctx, [jev.IndependentPointsSpec(**spec)]),
         pev.build_evaluator(model, ctx, [pev.IndependentPointsSpec(**spec)])),
    ]
    for jprog, pprog in cases:
        assert pprog.named_keys == jprog.named_keys
        state = init_state(model, 3)._replace(coeffs=torch.as_tensor(coeffs))
        _, named = pprog(state, transformed_points(model, state))
        for b in range(3):
            js = jinit_state(jmodel, coeffs=jnp.asarray(coeffs[b]))
            _, jnamed = jprog(js, jtp(jmodel, js))
            np.testing.assert_allclose(named[b].numpy(), np.asarray(jnamed), rtol=1e-5,
                                       atol=1e-5)
    assert cases[0][1].named_keys == ["product", "acceptall"]


def test_dense_distances_gradient_matches_jax():
    """Under grad, ``surface_distances_auto`` (K5's plain twin here) takes
    its inputs detached and recomputes the winner's d² from the live
    queries and per-chain points: the gradients with respect to both equal
    ``jax.grad`` of the reference's dense ``surface_distances`` (jnp, the
    same minimum) on the same inputs."""
    from icp_proposal_tpu.ops.closest_point import surface_distances as jdense
    from icp_proposal_tpu_torch.ops.closest_point import surface_distances_auto

    jmodel, tpoints, _ = _sphere()
    cells = np.asarray(jmodel.cells)
    rng = np.random.RandomState(2)
    q = (tpoints[rng.randint(0, len(tpoints), 50)]
         + rng.randn(50, 3) * 3.0).astype(np.float32)
    pts = (np.asarray(jmodel.ref_points) + rng.randn(*tpoints.shape) * 0.5).astype(
        np.float32)
    w = rng.rand(50).astype(np.float32)

    queries = torch.tensor(q[None], requires_grad=True)
    points = torch.tensor(pts[None], requires_grad=True)
    d2, fidx = surface_distances_auto(queries, points, torch.as_tensor(cells))
    gq, gp = torch.autograd.grad(torch.sum(d2[0] * torch.as_tensor(w)), (queries, points))

    def jloss(qq, pp):
        jd2, _ = jdense(qq, pp[cells])
        return jnp.sum(jd2 * w)

    jgq, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(pts))
    _, jfidx = jdense(jnp.asarray(q), jnp.asarray(pts)[cells])
    np.testing.assert_array_equal(fidx[0].numpy(), np.asarray(jfidx))
    np.testing.assert_allclose(gq[0].numpy(), np.asarray(jgq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gp[0].numpy(), np.asarray(jgp), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        d2_plain, _ = surface_distances_auto(queries, points, torch.as_tensor(cells))
    assert torch.equal(d2.detach(), d2_plain)
