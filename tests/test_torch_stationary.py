"""The port's samplers held to their stationary law on the CPU, against the
JAX package.

Chains started from exact draws of the prior N(0, I), under a prior-only
evaluator, keep N(0, I) at every step when the MH kernel is right; no
mixing is needed.  This is the JAX package's prior-preservation property
(``tests/test_mh.py::test_icp_proposal_preserves_prior``) run from exact
starts, with the criteria of ``chip_smoke.py``'s ``[check:stationary]``
(``stationary_stats``, ``stationary_failures``): at T/4, T/2, 3T/4 and T,
max_k |z_k| < 4.5 with z_k = m_k·√B, every |v_k − 1| < 5·√(2/B) and
|z_u| < 4, the mean projection on the unit direction u toward the target
(α̂ of the model-direction ICP factors at α = 0) times √B.

On the sphere of ``tests/test_mh.py`` (rank 6), for the mixture of
``test_icp_proposal_preserves_prior`` and for the flagship recipe of
``build_from_config(RunConfig())``, each package runs from the same
numpy-seeded starts with its own random stream, JAX on its plain CPU path:

* with exact densities both pass;
* with the reference's own density (``parity=True``) both fail;
* z_u and every coefficient's variance agree between the packages within 4
  Monte-Carlo standard errors at every recorded step, in both modes (the
  standard errors from both sets' pooled moments, as under the hypothesis
  that the two laws agree), and each component's acceptance within 0.05;
  with exact densities every ICP component accepts more than 5 % of its
  proposals, so accepted ICP moves are part of what is held (at the femur's
  full width on the card they are not: ``PERF.md``, PR 17).

Run alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_stationary.py -q``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import (
    _model_direction_alpha_hat,
    stationary_failures,
    stationary_stats,
    stationary_steps,
)
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.mesh import make_mesh
from icp_proposal_tpu_torch.sampling import mh as pmh
from icp_proposal_tpu_torch.sampling.context import build_target_context
from icp_proposal_tpu_torch.sampling.evaluators import build_evaluator
from icp_proposal_tpu_torch.sampling.proposals import (
    IcpSpec,
    MixtureProgram,
    RandomShapeSpec,
    nest,
)
from icp_proposal_tpu_torch.sampling.state import init_state
from icp_proposal_tpu_torch.utils import config as pconfig

RANK = 6
CHAINS, STEPS = 128, 50
MC_SES = 4.0  # across packages: |difference| < 4 Monte-Carlo standard errors


@pytest.fixture(scope="module")
def sphere():
    """(JAX model, port model on the CPU, target mesh, boundary mask):
    ``tests/test_mh.py``'s sphere, target at α = (1.5, −1, 0, …)."""
    from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jm = make_synthetic_gpmm(points, cells, rank=RANK, sigma=40.0, scale=5.0)
    alpha = jnp.zeros(RANK).at[0].set(1.5).at[1].set(-1.0)
    target = TriangleMesh(points=np.asarray(jgp.instance_points(jm, alpha)),
                          cells=np.asarray(jm.cells))
    pm = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                  device="cpu")
    return jm, pm, target, boundary_vertex_mask(np.asarray(cells), len(points))


def _icp_rw(icp_spec, rw_spec, parity):
    """``test_icp_proposal_preserves_prior``'s mixture: 0.5·ICP (model
    direction, 40 points, step 0.5) + 0.5·random shape (σ = 0.4)."""
    return lambda mixture, model, ctx, mask: mixture(
        nest((0.5, [(1.0, icp_spec(direction="model", n_points=40, step_length=0.5,
                                   noise_along_normal=5.0, tangential_noise=10.0))]),
             (0.5, [(1.0, rw_spec(sigma=0.4))])),
        model, ctx, mask, parity=parity)


def _jax_setup(name, parity, sphere):
    """JAX's (model, mixture, prior-only evaluator)."""
    from icp_proposal_tpu.sampling.context import build_target_context as jctx_of
    from icp_proposal_tpu.sampling.evaluators import build_evaluator as jbuild_ev
    from icp_proposal_tpu.sampling.proposals import IcpSpec as JIcp
    from icp_proposal_tpu.sampling.proposals import MixtureProgram as JMixture
    from icp_proposal_tpu.sampling.proposals import RandomShapeSpec as JRw
    from icp_proposal_tpu.utils import config as jconfig

    jm, _, target, mask = sphere
    if name == "icp-rw":
        jctx = jctx_of(target)
        jmix = _icp_rw(JIcp, JRw, parity)(JMixture, jm, jctx, mask)
    else:
        cfg = jconfig.RunConfig()
        cfg.chain.parity = parity
        jctx, jmix, _ = jconfig.build_from_config(cfg, jm, target, mask, mask)
    return jmix, jbuild_ev(jm, jctx, [], include_prior=True)


def _port_setup(name, parity, sphere):
    """The port's (mixture, prior-only evaluator) on the CPU."""
    _, pm, target, mask = sphere
    mesh = make_mesh(target.points, target.cells)
    if name == "icp-rw":
        # a K = 16 shortlist of the sphere's 320 faces (exact near the
        # surface) keeps the twins' refine, and the file, within its time
        ctx = build_target_context(mesh, index_k=16, device="cpu")
        mix = _icp_rw(IcpSpec, RandomShapeSpec, parity)(MixtureProgram, pm, ctx, mask)
    else:
        cfg = pconfig.RunConfig()
        cfg.chain.parity = parity
        ctx, mix, _ = pconfig.build_from_config(cfg, pm, mesh, mask, mask)
    return mix, build_evaluator(pm, ctx, [], include_prior=True)


def _jax_chains(jm, jmix, jev, starts, seed):
    """JAX's chains from starts [B, r] → post-step coefficients [B, T, r] and
    the acceptance of each mixture component."""
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.state import init_state as jinit_state

    n = starts.shape[0]
    jstep = jmh.make_mh_step(jm, jmix, jev, store_params=True)
    jstates = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                           jinit_state(jm))._replace(coeffs=jnp.asarray(starts))
    jcarry = jax.vmap(lambda s: jmh.init_carry(jm, jev, s, jmix))(jstates)
    _, jrec = jmh.run_chains(jstep, jcarry, jax.random.split(jax.random.PRNGKey(seed), n),
                             STEPS)
    return np.asarray(jrec.coeffs), _acceptance(jrec, jmix.num_components)


def _port_chains(pm, mix, ev, starts, seed):
    """The port's chains from starts [B, r] → coefficients [B, T, r] and the
    acceptance of each mixture component."""
    state = init_state(pm, starts.shape[0])._replace(coeffs=torch.as_tensor(starts))
    step = pmh.make_mh_step(pm, mix, ev, store_params=True)
    carry = pmh.init_carry(pm, ev, state, mix)
    _, recs = pmh.run_chains(step, carry, STEPS, torch.Generator().manual_seed(seed))
    rec = pmh.stack_records(recs)
    return rec.coeffs.numpy(), _acceptance(rec, mix.num_components)


def _acceptance(rec, n_components):
    accepted, idx = np.asarray(rec.accepted), np.asarray(rec.proposal_idx)
    return np.array([accepted[idx == c].mean() for c in range(n_components)])


def _mc_disagreements(xp, xj, u):
    """Where two chain sets [B, r] differ by 4 Monte-Carlo standard errors or
    more: the mean projection on u, and each coefficient's variance.  The
    standard errors are those under the hypothesis that the two laws agree:
    from the pooled second (and, for a variance, fourth) central moments of
    both sets."""
    b = len(xp)
    pooled = np.concatenate([xp - xp.mean(axis=0), xj - xj.mean(axis=0)])
    out = []
    pp, pj = xp @ u, xj @ u
    se = np.sqrt(2.0 * (pooled @ u).var() / b)
    if not abs(pp.mean() - pj.mean()) < MC_SES * se:
        out.append(f"mean projection {pp.mean():.4f} vs {pj.mean():.4f} (se {se:.4f})")
    v = pooled.var(axis=0)
    se_v = np.sqrt(2.0 * ((pooled ** 4).mean(axis=0) - v ** 2) / b)
    vp, vj = xp.var(axis=0, ddof=1), xj.var(axis=0, ddof=1)
    bad = ~(np.abs(vp - vj) < MC_SES * se_v)
    if bad.any():
        out.append(f"variances {vp[bad]} vs {vj[bad]} (se {se_v[bad]})")
    return out


@pytest.mark.parametrize("name", ["icp-rw", "flagship"])
def test_stationary_law_matches_jax(sphere, name):
    """From the same N(0, I) starts (128 chains × 50 steps), exact
    densities keep N(0, I) in both packages, ``parity=True`` leaves it in
    both, and the two packages' z_u and variances agree within 4
    Monte-Carlo standard errors at every recorded step, in both modes."""
    jm, pm, _, _ = sphere
    starts = np.random.RandomState(23).randn(CHAINS, RANK).astype(np.float32)
    mix, _ = _port_setup(name, False, sphere)
    u = _model_direction_alpha_hat(pm, mix).numpy().astype(np.float64)
    u /= np.linalg.norm(u)
    assert u[0] > 0.5 and u[1] < 0  # toward the target's α = (1.5, −1, 0, …)
    steps = [i - 1 for i in stationary_steps(STEPS)]
    for parity in (False, True):
        jmix, jev = _jax_setup(name, parity, sphere)
        mix, ev = _port_setup(name, parity, sphere)
        runs = {"jax": _jax_chains(jm, jmix, jev, starts, seed=5),
                "port": _port_chains(pm, mix, ev, starts, seed=5)}
        for side, (coeffs, acc) in runs.items():
            broken = [stationary_failures(stationary_stats(coeffs[:, i], u), CHAINS)
                      for i in steps]
            if parity:
                assert any(broken), f"{side}: parity=True kept N(0, I): no power"
            else:
                assert not any(broken), f"{side} left N(0, I): {broken}"
                # accepted ICP moves are part of what the check holds
                assert acc[:-1].min() > 0.05, (side, acc)
        np.testing.assert_allclose(runs["port"][1], runs["jax"][1], atol=0.05)
        for i in steps:
            bad = _mc_disagreements(runs["port"][0][:, i].astype(np.float64),
                                    runs["jax"][0][:, i].astype(np.float64), u)
            assert not bad, f"parity={parity}, step {i + 1}: {bad}"
