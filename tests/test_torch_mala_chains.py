"""Distribution-level checks of the port's MALA and scale adaptation on the
CPU, over many chains and steps.

The first two port the JAX package's own tests (``tests/test_mh.py``:
``test_mala_preserves_prior`` and ``test_adaptive_scales_converge_to_target``)
with the same sphere model, converted with ``convert.gpmm_from_arrays``, and
the same thresholds.  The third holds the port's MALA to JAX's (its plain
path, jitted) in distribution: the same model, evaluator and starts, chains
run in each package with its own random stream; posterior means must agree
within 4 Monte-Carlo standard errors (ESS as ``tools/posterior_parity.py``
computes it) and the acceptance rates within 0.05.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu.mesh import TriangleMesh as JMesh
from icp_proposal_tpu.models import gpmm as jgp
from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.mesh import boundary_vertex_mask, make_mesh
from icp_proposal_tpu_torch.sampling import mh
from icp_proposal_tpu_torch.sampling.context import build_target_context
from icp_proposal_tpu_torch.sampling.evaluators import (
    IndependentPointsSpec,
    build_evaluator,
)
from icp_proposal_tpu_torch.sampling.proposals import (
    AdaptConfig,
    MalaSpec,
    MixtureProgram,
    RandomShapeSpec,
)
from icp_proposal_tpu_torch.sampling.state import init_state

RANK = 6
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sphere():
    """(JAX model, port model, target points, α_true): the sphere of
    ``tests/test_mh.py``."""
    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jmodel = make_synthetic_gpmm(points, cells, rank=RANK, sigma=40.0, scale=5.0)
    alpha = jnp.zeros(RANK).at[0].set(1.5).at[1].set(-1.0)
    model = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                        jmodel._asdict().items()}, device="cpu")
    return jmodel, model, np.asarray(jgp.instance_points(jmodel, alpha)), alpha


def _boundary(model):
    cells = model.cells.numpy()
    return boundary_vertex_mask(cells, model.num_points)


def _run(model, mixture, evaluator, n_chains, n_steps, seed=0, coeffs0=None):
    """n_chains chains from coeffs0 [n_chains, r] (default 0) → the
    post-step coefficients [n_chains, n_steps, r] and acceptance [C, T]."""
    state = init_state(model, n_chains)
    if coeffs0 is not None:
        state = state._replace(coeffs=torch.as_tensor(coeffs0, dtype=torch.float32))
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry = mh.init_carry(model, evaluator, state, mixture)
    _, recs = mh.run_chains(step, carry, n_steps, torch.Generator().manual_seed(seed))
    rec = mh.stack_records(recs)
    return rec.coeffs.numpy(), rec.accepted.numpy()


def _prior_only(model, tpoints):
    ctx = build_target_context(make_mesh(tpoints, model.cells.numpy()), device="cpu")
    return ctx, build_evaluator(model, ctx, [], include_prior=True)


def test_mala_preserves_prior(sphere):
    """MALA with a prior-only evaluator samples N(0, I): 24 chains × 1,500
    steps, acceptance > 0.3, |mean| < 0.1, every std within 0.15 of 1
    after 500 steps."""
    _, model, tpoints, _ = sphere
    ctx, evaluator = _prior_only(model, tpoints)
    mixture = MixtureProgram([(1.0, MalaSpec(step_size=0.8))], model, ctx,
                             _boundary(model))
    coeffs, accepted = _run(model, mixture, evaluator, n_chains=24, n_steps=1500)
    assert accepted.mean() > 0.3, accepted.mean()
    samples = coeffs[:, 500:, :].reshape(-1, RANK)
    assert abs(samples.mean()) < 0.1
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.15)
    assert int(mixture.icp_components[0].zeroed) == 0


def test_adaptive_scales_converge_to_target(sphere):
    """A σ = 25 random walk adapts until its acceptance over steps
    600–1,200 lies in (0.1, 0.45) (8 chains); without adaptation the same
    walk accepts < 0.05 (8 chains × 400 steps)."""
    _, model, tpoints, _ = sphere
    ctx, evaluator = _prior_only(model, tpoints)
    mixture = MixtureProgram([(1.0, RandomShapeSpec(sigma=25.0))], model, ctx,
                             _boundary(model),
                             adapt=AdaptConfig(target=0.234, rate=1.0))
    _, accepted = _run(model, mixture, evaluator, n_chains=8, n_steps=1200)
    acc_late = accepted[:, 600:].mean()
    assert 0.1 < acc_late < 0.45, f"adapted acceptance {acc_late}"

    fixed = MixtureProgram([(1.0, RandomShapeSpec(sigma=25.0))], model, ctx,
                           _boundary(model))
    _, acc0 = _run(model, fixed, evaluator, n_chains=8, n_steps=400)
    assert acc0.mean() < 0.05


def _np_ess():
    spec = importlib.util.spec_from_file_location(
        "posterior_parity", REPO / "tools" / "posterior_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.np_ess


def test_mala_posterior_matches_jax(sphere):
    """MALA (h = 0.4) on the sphere's posterior under a Euclidean
    model→target likelihood (σ = 1, 60 points, dense closest point in both
    packages), 8 chains × 500 steps from the same starts: per-coefficient
    posterior means within 4 Monte-Carlo standard errors (from each side's
    ESS over steps 150–500), acceptance within 0.05."""
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.context import build_target_context as jctx_of
    from icp_proposal_tpu.sampling.evaluators import (
        IndependentPointsSpec as JSpec,
    )
    from icp_proposal_tpu.sampling.evaluators import build_evaluator as jbuild
    from icp_proposal_tpu.sampling.proposals import MalaSpec as JMala
    from icp_proposal_tpu.sampling.proposals import MixtureProgram as JMixture
    from icp_proposal_tpu.sampling.state import init_state as jinit_state

    jmodel, model, tpoints, alpha = sphere
    n_chains, n_steps, burn = 8, 500, 150
    starts = np.random.RandomState(7).randn(n_chains, RANK).astype(np.float32) * 0.5
    boundary = _boundary(model)

    # JAX: no Pallas on the CPU, no index: the dense jnp closest point
    jctx = jctx_of(JMesh(points=tpoints, cells=np.asarray(jmodel.cells)),
                   build_index=False)
    jev = jbuild(jmodel, jctx, [JSpec(sigma=1.0, mode="model_to_target", n_points=60)])
    jmix = JMixture([(1.0, JMala(step_size=0.4))], jmodel, jctx, boundary)
    jstep = jmh.make_mh_step(jmodel, jmix, jev, store_params=True)
    jstates = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape),
                           jinit_state(jmodel))._replace(coeffs=jnp.asarray(starts))
    jcarry = jax.vmap(lambda s: jmh.init_carry(jmodel, jev, s, jmix))(jstates)
    _, jrec = jmh.run_chains(jstep, jcarry, jax.random.split(jax.random.PRNGKey(3),
                                                             n_chains), n_steps)
    jcoeffs, jacc = np.asarray(jrec.coeffs), np.asarray(jrec.accepted)

    # the port, dense K5 (its plain twin) with the winner recomputed
    ctx = build_target_context(make_mesh(tpoints, model.cells.numpy()),
                               build_index=False, device="cpu")
    ev = build_evaluator(model, ctx, [IndependentPointsSpec(
        sigma=1.0, mode="model_to_target", n_points=60)])
    mix = MixtureProgram([(1.0, MalaSpec(step_size=0.4))], model, ctx, boundary)
    pcoeffs, pacc = _run(model, mix, ev, n_chains, n_steps, seed=3, coeffs0=starts)

    np_ess = _np_ess()
    stats = []
    for trace in (jcoeffs[:, burn:], pcoeffs[:, burn:]):
        mean = trace.reshape(-1, RANK).mean(axis=0)
        se = trace.reshape(-1, RANK).std(axis=0) / np.sqrt(np_ess(trace))
        stats.append((mean, se))
    (jm, jse), (pm, pse) = stats
    z = np.abs(pm - jm) / np.sqrt(jse ** 2 + pse ** 2)
    assert np.all(z < 4.0), (pm, jm, z)
    assert abs(pacc.mean() - jacc.mean()) < 0.05, (pacc.mean(), jacc.mean())
    assert pm[0] > 0.7  # the chains found the target's first coefficient (1.5)


def test_run_chain_and_stack_states(sphere):
    """``run_chain`` runs a one-chain carry and stacks its records over
    steps ([T, ...] fields), as ``run_chains`` + ``stack_records`` would;
    it refuses a carry of several chains.  ``stack_states`` joins one-chain
    states into a batch, in order."""
    _, model, tpoints, _ = sphere
    ctx, evaluator = _prior_only(model, tpoints)
    mixture = MixtureProgram([(1.0, MalaSpec(step_size=0.8))], model, ctx,
                             _boundary(model), adapt=AdaptConfig())
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    states = [init_state(model, 1, coeffs=np.full(RANK, v, np.float32))
              for v in (0.0, 0.5, -1.0)]
    batch = mh.stack_states(states)
    assert batch.coeffs.shape == (3, RANK)
    np.testing.assert_array_equal(batch.coeffs[:, 0].numpy(), [0.0, 0.5, -1.0])
    carry = mh.init_carry(model, evaluator, states[1], mixture)
    final, rec = mh.run_chain(step, carry, 7, torch.Generator().manual_seed(2))
    _, recs = mh.run_chains(step, carry, 7, torch.Generator().manual_seed(2))
    want = mh.stack_records(recs)
    assert rec.accepted.shape == (7,) and rec.coeffs.shape == (7, RANK)
    for got, w in zip(rec, want):
        assert (got is None) == (w is None)
        if got is not None:
            assert torch.equal(got, w[0])
    assert float(final.step_idx[0]) == 7.0
    with pytest.raises(ValueError, match="one chain"):
        mh.run_chain(step, mh.init_carry(model, evaluator, batch, mixture), 1)
