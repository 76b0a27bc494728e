"""The port's deterministic ICP against the JAX package's.

``posterior_factors_isotropic`` (K1/K6's plain twin here; JAX's Pallas K1/K6
in interpret mode, ICP_TPU_FORCE_CHOL_PALLAS=1) on the rank-101 and rank-201
stand-ins; ``_regression_mean`` at σ = 1e-15 and its fallback on a singular
system; ``sample_points_on_surface`` with JAX's draws passed in, and its
own draws against the face areas; one ``icp_surface_fitting`` iteration
per projection direction with JAX's flips; JAX's own 40-iteration fit
(``tests/test_registration.py::test_femur_deterministic_icp``) on the
stand-in.

Correspondence ids must match exactly, so the one-iteration references are
computed in a child process whose XLA targets SSE4.2 (no FMA, as in
``tests/test_torch_closest_point.py``).  Run as a script, this file is that
child:

    python tests/test_torch_icp.py OUT.npz
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from jax_native import use_native_index

REPO = Path(__file__).resolve().parents[1]
STANDIN = REPO / "artifacts" / "posterior"
TOL = dict(rtol=1e-4, atol=1e-4)
DIRECTIONS = ("model", "target", "model_and_target")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """``torch_threads.one_torch_thread`` (one intra-op thread while the
    module runs), with torch imported here: the JAX child imports no torch."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_flips(keys, n_iter, stage=0):
    """The direction flips JAX's ``icp_surface_fitting`` draws from each
    init's key at ``stage`` → [n_iter, B] bool."""
    import jax

    def one(k):
        its = jax.random.split(jax.random.fold_in(k, stage), n_iter)
        return jax.vmap(jax.random.bernoulli)(its)

    return np.asarray(jax.vmap(one)(keys)).T


def _jax_references(out_path):
    """One iteration of JAX's ``icp_surface_fitting`` from 2 inits per
    direction on the rank-101 stand-in, with the correspondences at the
    inits (model direction: target faces; target direction: model
    vertices).  JAX's model and target iterations are its model_and_target
    iteration under flips that pick that direction for both inits: the
    same arithmetic, selected, from one compiled program."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import boundary_vertex_mask, make_mesh
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm
    from icp_proposal_tpu.ops.closest_point import nearest_vertices
    from icp_proposal_tpu.ops.surface_index import closest_auto
    from icp_proposal_tpu.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )
    from icp_proposal_tpu.registration.icp_fitting import icp_surface_fitting
    from icp_proposal_tpu.sampling.context import build_target_context

    mp, mc = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    model = build_femur_gpmm(mp, mc, 100)
    ctx = build_target_context(make_mesh(tp, tc), boundary_vertex_mask(tc, len(tp)),
                               build_index=True)
    out = {f"model_{k}": np.asarray(v) for k, v in model._asdict().items()}
    for name in ("points", "cells", "tri", "boundary"):
        out[f"ctx_{name}"] = np.asarray(getattr(ctx, name))
    out["ctx_cand"] = ctx.index.cand
    n = model.num_points
    out["model_ids"] = seeded_vertex_subset(n, n, seed=1024)
    out["target_pts"] = np.asarray(jax.jit(sample_points_on_surface, static_argnums=2)(
        jax.random.PRNGKey(7), make_mesh(tp, tc), n))
    rng = np.random.RandomState(3)
    out["inits"] = (rng.randn(2, model.rank) * 0.3).astype(np.float32)
    # JAX's flips pick the direction per init: keys whose flips are
    # (True, True), (False, False) and mixed give JAX's model, target and
    # model_and_target iterations from one compiled program
    wanted = {"model": (True, True), "target": (False, False)}
    keys = {}
    for seed in range(200):
        k = jax.random.split(jax.random.PRNGKey(seed), 2)
        f = tuple(bool(x) for x in _jax_flips(k, 1)[0])
        d = next((d for d, w in wanted.items() if w == f), "model_and_target"
                 if f[0] != f[1] else None)
        if d is not None and d not in keys:
            keys[d] = k
            out[f"flips_{d}"] = _jax_flips(k, 1)[None]  # [stages, iterations, B]
        if len(keys) == 3:
            break
    ids, tpts = jnp.asarray(out["model_ids"]), jnp.asarray(out["target_pts"])

    @jax.jit
    def run(model, ctx, inits, keys, ids, tpts):  # arguments, not constants to fold
        coeffs = jax.vmap(lambda c0, k: icp_surface_fitting(
            model, ctx, ids, tpts, num_iterations=1,
            projection_direction="model_and_target", initial_coeffs=c0, key=k))(
            inits, keys)
        cur = jax.vmap(lambda c: jgp.instance_points(model, c))(inits)
        return coeffs, cur, jax.vmap(lambda p: closest_auto(p[ids], ctx.tri, ctx.index)[2])(
            cur), jax.vmap(lambda p: nearest_vertices(tpts, p))(cur)

    for d in DIRECTIONS:
        res = run(model, ctx, jnp.asarray(out["inits"]), keys[d], ids, tpts)
        out[f"coeffs_{d}"] = np.asarray(res[0])
    out["cur"], out["face_idx"], out["vertex_ids"] = (np.asarray(x) for x in res[1:])
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_icp") / "ref.npz"
    # ICP_TPU_NO_NATIVE=1 only keeps the child from rebuilding the tracked
    # native library: the port takes the child's cand as it is
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               ICP_TPU_NO_NATIVE="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def jax_models():
    """The JAX stand-in femur GPMMs of 100 and 200 components (ranks 101
    and 201) on the posterior-mean mesh."""
    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm

    mp, mc = read_stl(STANDIN / "mean.stl")
    return {r + 1: build_femur_gpmm(mp, mc, r) for r in (100, 200)}


def _port_model(jm):
    from icp_proposal_tpu_torch import convert

    return convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                    device="cpu")


def _observations(jm, b, m, seed, partial):
    """Observations of b chains near the instance of random coefficients:
    ids [b, m], displacements [b, m, 3] and a mask (every row, or ~85 %)."""
    from icp_proposal_tpu.models import gpmm as jgp

    rng = np.random.RandomState(seed)
    ids = np.stack([rng.choice(jm.num_points, m, False) for _ in range(b)]).astype(np.int32)
    disp = np.asarray(jgp.instance_displacement(jm, rng.randn(jm.rank).astype(np.float32)))
    obs = (disp[ids] + rng.randn(b, m, 3) * 0.5).astype(np.float32)
    mask = ((rng.rand(b, m) > 0.15) if partial else np.ones((b, m))).astype(np.float32)
    return ids, obs, mask


@pytest.mark.parametrize("rank,partial", [(101, False), (101, True), (201, False),
                                          (201, True)])
def test_posterior_factors_isotropic_matches_jax(jax_models, monkeypatch, rank, partial):
    """α̂, L and log det of M = I + QᵀQ/σ² (σ² = 4) for 2 chains against
    JAX's, whose factor runs its Pallas K1 (rank 101) or K6 (rank 201) in
    interpret mode; the ``_assert_factors`` tolerance of
    ``tests/test_torch_geometry.py``."""
    import torch

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu_torch.models import gpmm as pgp

    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    jm = jax_models[rank]
    pm = _port_model(jm)
    ids, obs, mask = _observations(jm, 2, 2 * rank, seed=rank, partial=partial)
    got = pgp.posterior_factors_isotropic(pm, torch.as_tensor(ids), torch.as_tensor(obs),
                                          4.0, torch.as_tensor(mask))
    want = jax.vmap(lambda i, o, k: jgp.posterior_factors_isotropic(jm, i, o, 4.0, k))(
        jnp.asarray(ids), jnp.asarray(obs), jnp.asarray(mask))
    np.testing.assert_allclose(got.chol_m.numpy(), np.asarray(want.chol_m), **TOL)
    np.testing.assert_allclose(got.alpha_hat.numpy(), np.asarray(want.alpha_hat), **TOL)
    np.testing.assert_allclose(got.logdet_m.numpy(), np.asarray(want.logdet_m), **TOL)


def test_regression_mean_matches_jax(jax_models):
    """α̂ of the deterministic ICP's regression at σ = 1e-15 (floored to
    σ² = 1e-8) for 2 chains of 1,622 observations, against JAX's
    ``_regression_mean`` (``jnp.linalg.cholesky`` + ``cho_solve``), rtol 1e-4
    with atol 1e-4·max|α̂|."""
    import torch

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.registration import icp_fitting as jicp
    from icp_proposal_tpu_torch.registration import icp_fitting as picp

    jm = jax_models[101]
    pm = _port_model(jm)
    ids, obs, _ = _observations(jm, 2, jm.num_points, seed=5, partial=False)
    ones = jnp.ones(ids.shape[1], jnp.float32)
    want = np.asarray(jax.vmap(lambda i, o: jicp._regression_mean(
        jm, i, o, jnp.float32(1e-30), ones))(jnp.asarray(ids), jnp.asarray(obs)))
    got = picp._regression_mean(pm, torch.as_tensor(ids), torch.as_tensor(obs),
                                1e-30).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_singular_regression_keeps_the_previous_coefficients(jax_models):
    """Every observation at one model vertex: the Gram matrix has rank 3 and
    the float32 factor meets a non-positive pivot in both packages (NaN),
    so one ICP iteration keeps each init's coefficients; the port counts
    the fallback."""
    import torch

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.registration import icp_fitting as jicp
    from icp_proposal_tpu.sampling.context import build_target_context as jctx
    from icp_proposal_tpu.mesh import make_mesh
    from icp_proposal_tpu_torch.registration import icp_fitting as picp
    from icp_proposal_tpu_torch.sampling.context import build_target_context as pctx
    from icp_proposal_tpu_torch.io.stl import read_stl

    jm = jax_models[101]
    pm = _port_model(jm)
    tp, tc = read_stl(STANDIN / "map.stl")
    ids = np.full(300, 17, np.int32)
    obs = np.broadcast_to(tp[40], (300, 3)).astype(np.float32)
    inits = (np.random.RandomState(2).randn(2, jm.rank) * 0.2).astype(np.float32)
    assert not np.isfinite(np.asarray(jicp._regression_mean(
        jm, jnp.asarray(ids), jnp.asarray(obs) - jnp.asarray(jm.ref_points)[ids],
        jnp.float32(1e-30), jnp.ones(300)))).all()
    jc = jctx(make_mesh(tp, tc))
    got = jax.vmap(lambda c0: jicp.icp_surface_fitting(
        jm, jc, jnp.asarray(ids), jnp.asarray(obs), num_iterations=1,
        projection_direction="target", initial_coeffs=c0))(jnp.asarray(inits))
    np.testing.assert_array_equal(np.asarray(got), inits)
    coeffs, nonfinite = picp.icp_surface_fitting(
        pm, pctx(make_mesh(tp, tc), build_index=False, device="cpu"), ids, obs,
        num_iterations=1,
        projection_direction="target", initial_coeffs=torch.as_tensor(inits))
    np.testing.assert_array_equal(coeffs.numpy(), inits)
    np.testing.assert_array_equal(nonfinite.numpy(), [1, 1])


def test_sample_points_on_surface_with_jax_draws():
    """JAX's own draws (its categorical faces and uniform r, from the split
    of its key) through the port's formula: the points to rtol 1e-6."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import face_areas, make_mesh
    from icp_proposal_tpu.ops.surface_sampling import sample_points_on_surface as jsample
    from icp_proposal_tpu_torch.ops.surface_sampling import sample_points_on_surface

    tp, tc = read_stl(STANDIN / "map.stl")
    mesh = make_mesh(tp, tc)
    key, n = jax.random.PRNGKey(11), 5000
    want = np.asarray(jax.jit(jsample, static_argnums=2)(key, mesh, n))
    k_face, k_bary = jax.random.split(key)
    logits = jnp.log(jnp.maximum(face_areas(mesh.points, mesh.cells), 1e-20))
    draws = (np.asarray(jax.random.categorical(k_face, logits, shape=(n,))),
             np.asarray(jax.random.uniform(k_bary, (n, 2))))
    got = sample_points_on_surface(mesh, n, draws=draws, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_surface_draws_follow_face_areas():
    """The generator path's faces against the face areas: a χ² test of the
    face frequencies of 100,000 draws on an 80-face icosphere whose faces
    were stretched to unequal areas (p > 1e-3); each draw's point lies on
    its face."""
    import torch

    from scipy.stats import chisquare

    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.models.synthetic import make_icosphere
    from icp_proposal_tpu_torch.ops.surface_sampling import (
        sample_points_on_surface,
        surface_draws,
    )

    points, cells = make_icosphere(subdivisions=1, radius=10.0)
    points = points * np.array([1.0, 2.5, 0.6], np.float32)
    mesh = make_mesh(points, cells)
    n = 100_000
    face_idx, r = surface_draws(mesh, n, torch.Generator().manual_seed(0), device="cpu")
    tri = points[cells].astype(np.float64)
    areas = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                                 axis=-1)
    counts = np.bincount(face_idx.numpy(), minlength=len(cells))
    assert chisquare(counts, n * areas / areas.sum()).pvalue > 1e-3
    assert r.shape == (n, 2) and float(r.min()) >= 0.0 and float(r.max()) < 1.0
    pts = sample_points_on_surface(mesh, 1000, generator=torch.Generator().manual_seed(1),
                                   device="cpu").numpy()
    again = sample_points_on_surface(mesh, 1000, draws=surface_draws(
        mesh, 1000, torch.Generator().manual_seed(1), device="cpu"), device="cpu").numpy()
    np.testing.assert_array_equal(pts, again)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_one_icp_iteration_matches_jax(ref, direction):
    """One iteration of 2 inits on the rank-101 stand-in at the entry
    point's width (1,622 model ids and target points) with JAX's flips.

    On JAX's own instance points, the model direction's target faces (K3
    shared + K4 twins) and the target direction's model vertices (K3 per
    chain) equal the FMA-free JAX child's.  The port's decode sums
    ``α @ Qᵀ`` in another order than XLA's, so its instance points differ
    from JAX's by rounding; a correspondence of the whole iteration may then
    differ from JAX's (at most 1 %) only as far as that shift explains.  The
    coefficients agree within rtol 1e-4 and atol 1e-4·max|α|;
    ``icp_surface_fitting`` with the flips passed in takes the same step."""
    import torch

    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.ops.closest_point import closest_point_on_triangle
    from icp_proposal_tpu_torch.ops.closest_point_cuda import nearest_vertices
    from icp_proposal_tpu_torch.ops.surface_index import closest_auto
    from icp_proposal_tpu_torch.registration.icp_fitting import (
        icp_iteration,
        icp_surface_fitting,
    )

    model = convert.gpmm_from_arrays(**{k[6:]: v for k, v in ref.items()
                                        if k.startswith("model_") and k != "model_ids"},
                                     device="cpu")
    ctx = convert.context_from_arrays(
        *(ref[f"ctx_{n}"] for n in ("points", "cells", "tri", "boundary", "cand")),
        device="cpu")
    ids = torch.as_tensor(ref["model_ids"], dtype=torch.int64)
    tpts, inits = torch.as_tensor(ref["target_pts"]), torch.as_tensor(ref["inits"])
    flips = torch.as_tensor(ref[f"flips_{direction}"])
    cur_j = torch.as_tensor(ref["cur"])
    tq = tpts.expand(2, -1, -1).contiguous()
    if direction != "target":
        _, _, fidx = closest_auto(cur_j[:, ids], ctx.points, ctx.cells, ctx.index)
        np.testing.assert_array_equal(fidx.numpy(), ref["face_idx"])
    if direction != "model":
        np.testing.assert_array_equal(nearest_vertices(tq, cur_j).numpy(),
                                      ref["vertex_ids"])

    step = icp_iteration(model, ctx, ids, tpts, inits, 1e-30, 1.0, direction,
                         flips[0, 0] if direction == "model_and_target" else None)
    # the port's pick may differ from JAX's only as far as the two decodes'
    # shift Δ explains: no farther from the port's query than JAX's pick
    # plus 2Δ (distance is 1-Lipschitz), with 1e-5 relative rounding
    cur = instance_points(model, inits)
    shift = (cur - cur_j).norm(dim=-1)  # [B, V]
    if direction != "target":
        got, want = step.face_idx.long(), torch.as_tensor(ref["face_idx"]).long()
        b, i = torch.nonzero(got != want, as_tuple=True)
        assert len(b) <= 0.01 * got.numel()
        q = cur[b, ids[i]]
        _, da = closest_point_on_triangle(q, *ctx.tri[got[b, i]].unbind(-2))
        _, db = closest_point_on_triangle(q, *ctx.tri[want[b, i]].unbind(-2))
        assert (da.sqrt() - db.sqrt() <= 2 * shift[b, ids[i]] + 1e-5 * db.sqrt() + 1e-6).all()
    if direction != "model":
        got, want = step.vertex_ids.long(), torch.as_tensor(ref["vertex_ids"]).long()
        b, i = torch.nonzero(got != want, as_tuple=True)
        assert len(b) <= 0.01 * got.numel()
        da = (tq[b, i] - cur[b, got[b, i]]).norm(dim=-1)
        db = (tq[b, i] - cur[b, want[b, i]]).norm(dim=-1)
        assert (da - db <= shift[b, got[b, i]] + shift[b, want[b, i]] + 1e-5 * db
                + 1e-6).all()
    want = ref[f"coeffs_{direction}"]
    assert step.finite.all() and np.isfinite(want).all()
    np.testing.assert_allclose(step.coeffs.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    coeffs, nonfinite = icp_surface_fitting(
        model, ctx, ids, tpts, num_iterations=1, projection_direction=direction,
        initial_coeffs=inits, flips=flips)
    np.testing.assert_array_equal(coeffs.numpy(), step.coeffs.numpy())
    np.testing.assert_array_equal(nonfinite.numpy(), [0, 0])


def test_forty_iteration_fit_matches_jax(monkeypatch):
    """JAX's own deterministic-ICP test (300 model ids and target points,
    seed 7, 40 iterations, σ = 1e-15, both directions) on the stand-in femur
    GPMM-50 in both packages, the port with JAX's flips: the port's final
    average distance within 2 % of JAX's (and under JAX's threshold 1.5),
    the same number of non-finite iterations (JAX's counted where its
    regression mean is not finite)."""
    import torch

    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm
    from icp_proposal_tpu.ops.metrics import avg_distance as javg
    from icp_proposal_tpu.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )
    from icp_proposal_tpu.registration import icp_fitting as jicp
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu_torch.models.gpmm import instance_mesh
    from icp_proposal_tpu_torch.ops.metrics import avg_distance
    from icp_proposal_tpu_torch.registration.icp_fitting import icp_surface_fitting
    from icp_proposal_tpu_torch.sampling.context import build_target_context as pctx

    use_native_index(monkeypatch)  # JAX's default index build, the port's
    mp, mc = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    jm = build_femur_gpmm(mp, mc, 50)
    target = make_mesh(tp, tc)
    boundary = boundary_vertex_mask(tc, len(tp))
    ctx = build_target_context(target, boundary)
    model_ids = seeded_vertex_subset(jm.num_points, 300, seed=7)
    target_pts = np.asarray(jax.jit(sample_points_on_surface, static_argnums=2)(
        jax.random.PRNGKey(7), target, 300))

    finite = []
    regression_mean = jicp._regression_mean

    def counting(*args):
        out = regression_mean(*args)
        jax.debug.callback(lambda ok: finite.append(bool(ok)), jnp.all(jnp.isfinite(out)))
        return out

    monkeypatch.setattr(jicp, "_regression_mean", counting)
    want = jicp.icp_surface_fitting(jm, ctx, jnp.asarray(model_ids), jnp.asarray(target_pts),
                                    num_iterations=40, sigma_seq=(1e-15,), step_length=1.0,
                                    projection_direction="model_and_target")
    jax.effects_barrier()
    assert len(finite) == 40
    want_avg = float(javg(TriangleMesh(points=jgp.instance_points(jm, want),
                                       cells=jm.cells), target))

    pm = _port_model(jm)
    flips = _jax_flips(jax.random.PRNGKey(1024)[None], 40)[None]
    got, nonfinite = icp_surface_fitting(
        pm, pctx(target, boundary, device="cpu"), model_ids, target_pts,
        num_iterations=40, sigma_seq=(1e-15,), step_length=1.0,
        projection_direction="model_and_target", flips=flips)
    got_avg = float(avg_distance(instance_mesh(pm, got), target))
    assert torch.isfinite(got).all()
    assert int(nonfinite) == finite.count(False)
    assert want_avg < 1.5 and got_avg < 1.5
    assert abs(got_avg - want_avg) <= 0.02 * want_avg, (got_avg, want_avg)


if __name__ == "__main__":
    _jax_references(sys.argv[1])
