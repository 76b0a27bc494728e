"""The JAX package's chain-level tests, ported as tests of the port.

Each test below runs the port with its JAX original's model, settings and
thresholds (the two posterior comparisons run shorter chains,
``POSTERIOR_STEPS``); the sphere GPMMs are JAX's own, converted with
``convert.gpmm_from_arrays``.  JAX's CPU path queries the sphere's 320
faces densely; the port's contexts here hold a K = 8 shortlist index,
which keeps the file within its time (the dense twin takes ≈ 10× as long
a step) and gives the dense path's chains bitwise
(``test_sphere_index_gives_the_dense_chains``).  The femur tests of
``tests/test_components.py``
need the real femur assets, which are absent; they run here on the stand-in
femur GPMM-50 (``load_standin_femur_data``).  JAX's draws
(``jax.random``) are reused where a JAX test draws its states.

JAX test → port test (those ported elsewhere are not ported again):

* ``test_mh.py::test_random_walk_preserves_prior`` → ``test_random_walk_preserves_prior``
* ``test_mh.py::test_icp_proposal_preserves_prior`` →
  ``test_torch_stationary.py::test_stationary_law_matches_jax[icp-rw]`` (its
  mixture and prior-only evaluator, from exact N(0, I) starts, held to
  N(0, I) at four steps and to JAX's chains)
* ``test_mh.py::test_rw_vs_icp_same_posterior`` → ``test_rw_vs_icp_same_posterior``
* ``test_mh.py::test_icp_chain_fits_target`` → ``test_icp_chain_fits_target``
* ``test_mh.py::test_pose_proposal_guards`` →
  ``test_torch_bfm.py::test_pose_log_q_and_guards_match_jax``
* ``test_mh.py::test_pose_and_shape_chain_recovers_translation`` →
  ``test_pose_and_shape_chain_recovers_translation``
* ``test_mh.py::test_parity_mode_matches_reference_density`` →
  ``test_parity_mode_matches_reference_density``
* ``test_mh.py::test_adaptive_scales_converge_to_target`` →
  ``test_torch_mala_chains.py::test_adaptive_scales_converge_to_target``
* ``test_mh.py::test_parity_mode_chain_runs`` → ``test_parity_mode_chain_runs``
* ``test_mh.py::test_static_factor_assembly_matches_dynamic`` →
  ``test_static_factor_assembly_matches_dynamic``
* ``test_mh.py::test_mala_preserves_prior`` →
  ``test_torch_mala_chains.py::test_mala_preserves_prior``
* ``test_mh.py::test_mala_vs_rw_same_posterior_better_mixing`` →
  ``test_mala_vs_rw_same_posterior_better_mixing``
* ``test_mh.py::test_fused_step_matches_unfused`` →
  ``test_torch_mh.py::test_fused_step_matches_unfused``
* ``test_foundations.py::test_posterior_sampling_moments`` →
  ``test_posterior_sampling_moments`` (stand-in GPMM-50)
* ``test_foundations.py::test_transition_logpdf_consistency`` →
  ``test_torch_geometry.py::test_posterior_factors_and_densities``
* ``test_registration.py::test_records_hold_state_trace_low_acceptance`` →
  ``test_records_hold_state_trace_low_acceptance``
* ``test_registration.py::test_extract_best_raises_without_accepted_sample`` →
  ``test_torch_registration.py::test_extract_best_matches_jax`` (its last
  assertion: records with no accept raise "no accepted sample")
* ``test_components.py::test_hausdorff_evaluator_exact_at_far_states`` →
  ``test_hausdorff_evaluator_exact_at_far_states`` (stand-in GPMM-50)
* ``test_components.py::test_independent_evaluator_shortlist_perturbation_bounded`` →
  ``test_independent_evaluator_shortlist_perturbation_bounded`` (stand-in GPMM-50)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.sampling import mh
from icp_proposal_tpu_torch.sampling.context import build_target_context
from icp_proposal_tpu_torch.sampling.evaluators import (
    HausdorffSpec,
    IndependentPointsSpec,
    build_evaluator,
)
from icp_proposal_tpu_torch.sampling.proposals import (
    IcpSpec,
    MalaSpec,
    MixtureProgram,
    RandomShapeSpec,
    RotationSpec,
    TranslationSpec,
    nest,
)
from icp_proposal_tpu_torch.sampling.state import init_state, transformed_points

RANK = 6
# the two posterior comparisons: JAX's 16 chains × 2,500 steps after 1,000
# burn-in steps, cut to 1,500 after 500 so that the new port test files
# stay within their 150 s on one CPU worker; the thresholds are JAX's
POSTERIOR_STEPS, POSTERIOR_BURN = 1500, 500


def _jax_sphere(subdivisions, rank, sigma, scale):
    """JAX's synthetic sphere GPMM, converted to the port on the CPU."""
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

    points, cells = make_icosphere(subdivisions=subdivisions, radius=50.0)
    jm = make_synthetic_gpmm(points, cells, rank=rank, sigma=sigma, scale=scale)
    return convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                    device="cpu")


@pytest.fixture(scope="module")
def sphere():
    """(port model, target points, α_true): ``tests/test_mh.py``'s sphere,
    target at α = (1.5, −1, 0, …)."""
    model = _jax_sphere(2, RANK, 40.0, 5.0)
    alpha = np.zeros(RANK, np.float32)
    alpha[:2] = 1.5, -1.0
    points = gp.instance_points(model, torch.as_tensor(alpha)[None])[0].numpy()
    return model, points, alpha


@pytest.fixture(scope="module")
def femur50():
    from icp_proposal_tpu_torch.apps.femur import load_standin_femur_data

    return load_standin_femur_data(device="cpu", model_components=50)


def _boundary(model):
    return boundary_vertex_mask(model.cells.numpy(), model.num_points)


def _ctx(model, points, **index):
    """The sphere's target context: a K = 8 shortlist index (``index``
    overrides it)."""
    return build_target_context(make_mesh(points, model.cells.numpy()),
                                **(index or {"index_k": 8}), device="cpu")


def _run(model, mixture, evaluator, n_chains, n_steps, seed=0, coeffs0=None):
    """``tests/test_mh.py``'s ``_run``: every chain from coeffs0 [r]
    (default 0) → (final carry, records with [C, T, ...] fields)."""
    state = init_state(model, n_chains, coeffs=coeffs0)
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry = mh.init_carry(model, evaluator, state, mixture)
    final, recs = mh.run_chains(step, carry, n_steps, torch.Generator().manual_seed(seed))
    return final, mh.stack_records(recs)


def _prior_only(model, points):
    ctx = _ctx(model, points)
    return ctx, build_evaluator(model, ctx, [], include_prior=True)


def _likelihood(model, ctx, sigma):
    return build_evaluator(model, ctx, [IndependentPointsSpec(
        sigma=sigma, mode="model_to_target", n_points=60)])


def _icp_posterior_mixture(model, ctx):
    """``test_rw_vs_icp_same_posterior``'s ICP mixture."""
    return MixtureProgram(
        nest((0.8, [(1.0, IcpSpec(direction="model", n_points=40, step_length=0.2,
                                  noise_along_normal=2.0, tangential_noise=4.0))]),
             (0.2, [(1.0, RandomShapeSpec(sigma=0.15))])),
        model, ctx, _boundary(model))


def test_sphere_index_gives_the_dense_chains(sphere):
    """The K = 8 index these tests use takes every decision of the dense
    closest-point path, which JAX's CPU path takes: the ICP mixture under
    the Euclidean likelihood, 16 chains × 30 steps, records bitwise equal."""
    model, points, _ = sphere
    runs = []
    for index in ({"index_k": 8}, {"build_index": False}):
        ctx = _ctx(model, points, **index)
        assert (ctx.index is None) == ("build_index" in index)
        runs.append(_run(model, _icp_posterior_mixture(model, ctx),
                         _likelihood(model, ctx, 1.0), n_chains=16, n_steps=30, seed=2)[1])
    for got, want in zip(*runs):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


@pytest.fixture(scope="module")
def rw_posterior(sphere):
    """(context, evaluator, records) of the random-walk chains both
    posterior comparisons of ``tests/test_mh.py`` run alike: σ = 0.15 under
    the Euclidean likelihood (σ = 1, 60 points), 16 chains, seed 1, for
    ``POSTERIOR_STEPS``."""
    model, points, _ = sphere
    ctx = _ctx(model, points)
    evaluator = _likelihood(model, ctx, 1.0)
    mix_rw = MixtureProgram([(1.0, RandomShapeSpec(sigma=0.15))], model, ctx,
                            _boundary(model))
    _, rec_rw = _run(model, mix_rw, evaluator, n_chains=16, n_steps=POSTERIOR_STEPS,
                     seed=1)
    return ctx, evaluator, rec_rw


def test_random_walk_preserves_prior(sphere):
    """Random-walk MH with a prior-only evaluator must sample N(0, I)."""
    model, points, _ = sphere
    ctx, evaluator = _prior_only(model, points)
    mixture = MixtureProgram([(1.0, RandomShapeSpec(sigma=0.4))], model, ctx,
                             _boundary(model))
    _, records = _run(model, mixture, evaluator, n_chains=24, n_steps=1500)
    samples = records.coeffs[:, 500:, :].reshape(-1, RANK).numpy()
    assert abs(samples.mean()) < 0.1
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.15)


def test_rw_vs_icp_same_posterior(sphere, rw_posterior):
    """Random-walk MH and ICP-proposal MH must agree on the posterior mean
    (same likelihood, same prior): the informed proposal cross-validated
    against an unquestionably correct sampler."""
    model, _, _ = sphere
    ctx, evaluator, rec_rw = rw_posterior
    mix_icp = _icp_posterior_mixture(model, ctx)
    _, rec_icp = _run(model, mix_icp, evaluator, n_chains=16, n_steps=POSTERIOR_STEPS,
                      seed=2)
    mean_rw = rec_rw.coeffs[:, POSTERIOR_BURN:, :].reshape(-1, RANK).mean(dim=0).numpy()
    mean_icp = rec_icp.coeffs[:, POSTERIOR_BURN:, :].reshape(-1, RANK).mean(dim=0).numpy()
    np.testing.assert_allclose(mean_rw, mean_icp, atol=0.3)
    # both pulled strongly toward the generating coefficients
    assert mean_icp[0] > 0.7 and mean_icp[1] < -0.5


def test_icp_chain_fits_target(sphere):
    """The flagship behaviour: ICP-proposal MH fits the target fast and with
    a healthy acceptance rate."""
    model, points, alpha_true = sphere
    ctx = _ctx(model, points)
    evaluator = _likelihood(model, ctx, 0.5)
    mixture = MixtureProgram(
        nest((0.9, [(1.0, IcpSpec(direction="model", n_points=40, step_length=0.1,
                                  noise_along_normal=2.0, tangential_noise=4.0))]),
             (0.1, [(1.0, RandomShapeSpec(sigma=0.1))])),
        model, ctx, _boundary(model))
    _, records = _run(model, mixture, evaluator, n_chains=4, n_steps=400)
    acc_rate = records.accepted.float().mean().item()
    assert 0.1 < acc_rate < 0.999
    err = np.abs(records.coeffs[:, -1, :].numpy() - alpha_true).max()
    assert err < 0.6, f"final coeffs off by {err}"


def test_pose_and_shape_chain_recovers_translation(sphere):
    """BFM-style mixture (pose + ICP + shape) must recover a rigid offset of
    the target: the pose block absorbs most of the translation."""
    from icp_proposal_tpu_torch.ops.metrics import avg_distance
    from icp_proposal_tpu_torch.sampling.state import transformed_mesh

    model, _, _ = sphere
    t_true = np.asarray([2.0, -1.5, 1.0], np.float32)
    target_pts = gp.instance_points(model, torch.zeros(1, RANK))[0].numpy() + t_true
    ctx = _ctx(model, target_pts)
    mixture = MixtureProgram(
        nest((0.5, [(1.0, TranslationSpec(axis=0, sigma=0.3)),
                    (1.0, TranslationSpec(axis=1, sigma=0.3)),
                    (1.0, TranslationSpec(axis=2, sigma=0.3)),
                    (1.0, RotationSpec(axis=0, sigma=0.02)),
                    (1.0, RotationSpec(axis=1, sigma=0.02)),
                    (1.0, RotationSpec(axis=2, sigma=0.02))]),
             (0.45, [(1.0, IcpSpec(direction="model", n_points=40, step_length=0.3,
                                   noise_along_normal=2.0, tangential_noise=4.0))]),
             (0.05, [(1.0, RandomShapeSpec(sigma=0.1))])),
        model, ctx, _boundary(model))
    evaluator = build_evaluator(model, ctx, [IndependentPointsSpec(
        sigma=0.3, mode="model_to_target", n_points=60)])
    final, _ = _run(model, mixture, evaluator, n_chains=4, n_steps=800)
    fitted = transformed_mesh(model, final.state, chain=0)
    target = TriangleMesh(points=torch.as_tensor(target_pts), cells=model.cells)
    avg = float(avg_distance(fitted, target, device="cpu"))
    assert avg < 0.8, f"pose+shape chain failed to fit: avg={avg}"
    # the translation does real work (not all absorbed by shape)
    assert np.linalg.norm(final.state.trans[0].numpy()) > 0.8


def _normals(model, mixture, pts):
    return mh._normals_of(model, mixture)(pts)


def test_parity_mode_matches_reference_density(sphere):
    """parity=True drops exactly the ½·log det M and r·log(step) terms."""
    model, points, _ = sphere
    ctx = _ctx(model, points)
    spec = IcpSpec(direction="model", n_points=40, step_length=0.25)
    mix_exact = MixtureProgram([(1.0, spec)], model, ctx, _boundary(model), parity=False)
    mix_parity = MixtureProgram([(1.0, spec)], model, ctx, _boundary(model), parity=True)
    s0 = init_state(model, 1)
    s1 = s0._replace(coeffs=s0.coeffs + 0.1)
    pts = transformed_points(model, s0)
    f_exact = mix_exact.anchor_factors(s0, pts, _normals(model, mix_exact, pts))
    lq_exact = float(mix_exact.log_q_mixture(s0, s1, f_exact)[0])
    lq_parity = float(mix_parity.log_q_mixture(s0, s1, f_exact)[0])
    expected_gap = 0.5 * float(f_exact[0].logdet_m[0]) - RANK * np.log(0.25)
    np.testing.assert_allclose(lq_exact - lq_parity, expected_gap, rtol=1e-4)


def test_parity_mode_chain_runs(sphere):
    """The reference-faithful (parity=True) transition density: the chain
    still runs and fits (it samples a slightly different law by design)."""
    model, points, alpha_true = sphere
    ctx = _ctx(model, points)
    evaluator = _likelihood(model, ctx, 0.5)
    mixture = MixtureProgram(
        nest((0.9, [(1.0, IcpSpec(direction="model", n_points=40, step_length=0.1,
                                  noise_along_normal=2.0, tangential_noise=4.0))]),
             (0.1, [(1.0, RandomShapeSpec(sigma=0.1))])),
        model, ctx, _boundary(model), parity=True)
    _, records = _run(model, mixture, evaluator, n_chains=2, n_steps=300)
    acc = records.accepted.float().mean().item()
    assert 0.02 < acc <= 1.0
    assert np.abs(records.coeffs[:, -1, :].numpy() - alpha_true).max() < 1.0


def test_static_factor_assembly_matches_dynamic(sphere):
    """The model-direction component's factors from its precomputed per-id
    Gram tables (``posterior_factors_anisotropic_static``) agree with the
    dynamic-id path (``posterior_factors_anisotropic``, the target
    direction's) at the same observations and a posed state, to fp
    tolerance."""
    from icp_proposal_tpu_torch.ops.closest_point import nearest_vertex_of_faces
    from icp_proposal_tpu_torch.ops.surface_index import closest_auto
    from icp_proposal_tpu_torch.sampling.state import pose_inverse_apply

    model, points, _ = sphere
    ctx = _ctx(model, points)
    spec = IcpSpec(direction="model", n_points=40, step_length=0.25)
    mix = MixtureProgram([(1.0, spec)], model, ctx, _boundary(model))
    comp = mix.icp_components[0]
    coeffs = np.random.RandomState(3).randn(RANK).astype(np.float32)
    s0 = init_state(model, 1, coeffs=coeffs)._replace(
        rot=torch.tensor([[0.05, -0.02, 0.1]]), trans=torch.tensor([[1.0, -2.0, 0.5]]))
    pts = transformed_points(model, s0)
    normals = _normals(model, mix, pts)
    fac_static = comp.factors(s0, pts, normals)

    ids = torch.as_tensor(comp.model_ids, dtype=torch.int64)
    cp, _, fidx = closest_auto(pts[:, ids], ctx.points, ctx.cells, ctx.index)
    near = nearest_vertex_of_faces(ctx.cells, fidx, cp, ctx.points)
    # the ids are distinct: each observation's target-boundary weight
    # becomes its vertex's
    dropped = torch.zeros(model.num_points, dtype=torch.bool)
    dropped[ids] = ctx.boundary[near][0]
    fac_dyn = gp.posterior_factors_anisotropic(
        gp.target_tables(model, dropped), ids[None].to(torch.int32),
        pose_inverse_apply(s0, cp), normals, spec.noise_along_normal,
        spec.tangential_noise)
    for got, want in zip(fac_static, fac_dyn):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-4)


def test_mala_vs_rw_same_posterior_better_mixing(sphere, rw_posterior):
    """MALA agrees with random-walk MH on the posterior (same target) and,
    being gradient-informed, mixes at least as well."""
    from icp_proposal_tpu_torch.sampling.diagnostics import ess

    model, _, _ = sphere
    ctx, evaluator, rec_rw = rw_posterior
    mix_mala = MixtureProgram([(1.0, MalaSpec(step_size=0.15))], model, ctx,
                              _boundary(model))
    _, rec_mala = _run(model, mix_mala, evaluator, n_chains=16,
                       n_steps=POSTERIOR_STEPS, seed=2)
    st_rw = rec_rw.coeffs[:, POSTERIOR_BURN:, :]
    st_mala = rec_mala.coeffs[:, POSTERIOR_BURN:, :]
    np.testing.assert_allclose(st_rw.reshape(-1, RANK).mean(dim=0).numpy(),
                               st_mala.reshape(-1, RANK).mean(dim=0).numpy(), atol=0.3)
    assert st_mala.reshape(-1, RANK).mean(dim=0)[0] > 0.7
    ess_rw = float(ess(st_rw, max_lag=200).mean())
    ess_mala = float(ess(st_mala, max_lag=200).mean())
    assert ess_mala > 0.8 * ess_rw, (ess_mala, ess_rw)


def test_posterior_sampling_moments(femur50):
    """Sample moments of α* ~ N(α̂, M⁻¹) (4,000 draws through the draw's
    L⁻ᵀz) match the analytic factors, on the stand-in femur GPMM-50."""
    model = femur50.model
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.choice(model.num_points, 80, replace=False))[None]
    disp = torch.as_tensor(rng.randn(1, 80, 3).astype(np.float32) * 2)
    factors = gp.posterior_factors_isotropic(model, ids, disp, sigma2=25.0,
                                             mask=torch.ones(1, 80))
    n = 4000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    z = np.array(jax.vmap(lambda k: jax.random.normal(k, (model.rank,)))(keys))
    many = gp.PosteriorFactors(factors.alpha_hat.expand(n, -1),
                               factors.chol_m.expand(n, -1, -1).contiguous(),
                               factors.logdet_m.expand(n))
    s = gp.sample_posterior_coeffs(many, torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(s.mean(axis=0), factors.alpha_hat[0].numpy(), atol=0.15)
    chol = factors.chol_m[0].double().numpy()
    cov_true = np.linalg.inv(chol @ chol.T)
    np.testing.assert_allclose(np.diag(np.cov(s.T)), np.diag(cov_true), rtol=0.25,
                               atol=0.01)


def test_records_hold_state_trace_low_acceptance():
    """``ChainRecord.coeffs`` is the held chain-STATE trace, and diagnostics
    on it do not read like iid proposal noise: a deliberately low-acceptance
    random walk (huge step) through the chain runner repeats the state
    across rejected steps, and its pooled ESS is a small fraction of an
    iid-noise series' of the same shape."""
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu_torch.sampling import diagnostics

    model = _jax_sphere(1, 4, 40.0, 4.0)
    points = gp.instance_points(model, torch.zeros(1, 4))[0].numpy()
    ctx = _ctx(model, points)
    mixture = MixtureProgram(nest((1.0, [(1.0, RandomShapeSpec(sigma=1.2))])), model, ctx,
                             _boundary(model))
    evaluator = build_evaluator(model, ctx, [IndependentPointsSpec(
        sigma=0.5, mode="model_to_target", n_points=16)])
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    n_chains, n_steps = 16, 240
    carry = mh.init_carry(model, evaluator, init_state(model, n_chains), mixture)
    _, records, stats = run_sharded_chains(
        step, carry, 11, n_steps, make_chain_mesh(devices=[torch.device("cpu")]),
        burn_in=40)
    acc = records.accepted.numpy()
    coeffs = records.coeffs.numpy()
    assert acc.mean() < 0.15, "the test needs a low-acceptance chain"
    assert acc.any(), "at least one accept must move the state"

    # (a) hold semantics: rejected steps repeat the previous state exactly
    rej = ~acc[:, 1:]
    np.testing.assert_array_equal(coeffs[:, 1:][rej], coeffs[:, :-1][rej])
    # ... and accepted steps (almost surely) move it
    moved = np.abs(coeffs[:, 1:] - coeffs[:, :-1]).max(axis=-1) > 0
    assert moved[acc[:, 1:]].all()

    # (b) the pooled ESS of the held trace is far below an iid-noise series'
    tail = torch.as_tensor(coeffs[:, 40:, 0])
    surrogate = torch.as_tensor(
        np.random.default_rng(0).standard_normal(tuple(tail.shape)).astype(np.float32))
    ess_surrogate = float(diagnostics.pooled_ess(surrogate))
    ess_held = float(stats.ess)
    np.testing.assert_allclose(ess_held, float(diagnostics.pooled_ess(tail)), rtol=1e-4)
    assert ess_held < 0.1 * ess_surrogate, (ess_held, ess_surrogate)


def _far_coeffs(key, i, rank):
    """The JAX test's far-state draw: 3·N(0, I) from fold_in(key, i)."""
    return 3.0 * np.asarray(jax.random.normal(jax.random.fold_in(key, i), (rank,),
                                              jnp.float32))


def test_hausdorff_evaluator_exact_at_far_states(femur50):
    """The Hausdorff likelihood uses EXACT queries even when the target
    context carries a shortlist index: at far states the K-NN shortlist can
    miss the true closest face by mm, and a max statistic is maximally
    sensitive to the single worst query (the reference's BVH queries are
    exact, ``HausdorffDistanceEvaluator.scala:33-34``).  The value equals
    the port's metric and the JAX package's on the same meshes."""
    from icp_proposal_tpu.mesh import TriangleMesh as JMesh
    from icp_proposal_tpu.ops.metrics import hausdorff_distance as jhausdorff
    from icp_proposal_tpu_torch.ops.metrics import hausdorff_distance

    data = femur50
    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask, device="cpu")
    assert ctx.index is not None
    evaluator = build_evaluator(model, ctx, [HausdorffSpec(rate=1.0)])
    coeffs = 3.0 * np.asarray(jax.random.normal(jax.random.PRNGKey(3), (model.rank,),
                                                jnp.float32))
    state = init_state(model, 1, coeffs=coeffs)._replace(
        trans=torch.tensor([[40.0, -25.0, 60.0]]))
    pts = transformed_points(model, state)
    _, named = evaluator(state, pts)
    inst = TriangleMesh(points=pts[0], cells=model.cells)
    hd = float(hausdorff_distance(inst, data.target, device="cpu"))
    # named = [product, prior, hausdorff]; Exponential(1).logPdf(hd) = −hd
    np.testing.assert_allclose(float(named[0, -1]), -hd, rtol=1e-5, atol=1e-4)
    jhd = float(jhausdorff(JMesh(points=pts[0].numpy(), cells=model.cells.numpy()),
                           JMesh(points=np.asarray(data.target.points),
                                 cells=np.asarray(data.target.cells))))
    np.testing.assert_allclose(hd, jhd, rtol=1e-5)


def test_independent_evaluator_shortlist_perturbation_bounded(femur50):
    """The K = 64 shortlist index's perturbation of the Euclidean
    log-likelihood against the exact dense kernel (σ = 2, 4·rank points),
    at the chain's actual states: random inits (α ~ N(0, 0.1·I), the femur
    experiments' init distribution; < 5e-3 nats), adversarially far states
    (3σ coefficients and a 79 mm translation; < 5e-2) and the zero state
    (< 1e-4): JAX's bounds, on the stand-in."""
    data = femur50
    model = data.model
    spec = [IndependentPointsSpec(sigma=2.0, mode="model_to_target", n_points=4 * model.rank)]
    ctx_i = build_target_context(data.target, data.target_boundary_mask, device="cpu")
    ctx_d = build_target_context(data.target, data.target_boundary_mask,
                                 build_index=False, device="cpu")
    assert ctx_i.index is not None and ctx_d.index is None
    ev_i = build_evaluator(model, ctx_i, spec)
    ev_d = build_evaluator(model, ctx_d, spec)

    def delta(state):
        pts = transformed_points(model, state)
        return (ev_i(state, pts)[0] - ev_d(state, pts)[0]).abs()

    key = jax.random.PRNGKey(0)
    inits = np.stack([np.sqrt(0.1) * np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (model.rank,), jnp.float32)) for i in range(16)]
                     ).astype(np.float32)
    far = np.stack([_far_coeffs(key, 1000 + i, model.rank) for i in range(8)])
    base = init_state(model, 16)
    init_errs = delta(base._replace(coeffs=torch.as_tensor(inits)))
    far_state = init_state(model, 8)._replace(
        coeffs=torch.as_tensor(far), trans=torch.tensor([[40.0, -25.0, 60.0]]).expand(8, 3))
    far_errs = delta(far_state)
    assert float(init_errs.max()) < 5e-3, f"init-state |dlogL| {float(init_errs.max())}"
    assert float(far_errs.max()) < 5e-2, f"far-state |dlogL| {float(far_errs.max())}"
    assert float(delta(init_state(model, 1)).max()) < 1e-4
