"""The port's chain runner over gloo ranks on the CPU, against the JAX
package and against its own unsharded run.

Ranks are child processes started by ``torch_ranks.run`` (one PyTorch
thread each, a ``file://`` rendezvous in ``tmp_path``, each waited for with
a 120 s limit); they import the port only.  Each test is named after the
JAX test it mirrors (``tests/test_registration.py``).  Tolerances: R̂ and
the pooled moments rtol 1e-5, ESS rtol 1e-4 (a sum over up to 100 lags of
ratios of sums); a sharded run equals the unsharded one decision for
decision, its final coefficients within rtol 1e-5, atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu.sampling import diagnostics as jdiag
from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains
from icp_proposal_tpu_torch.sampling import diagnostics as pdiag
from icp_proposal_tpu_torch.sampling import mh

STATS = ("acceptance", "coeff_mean", "coeff_var", "log_post_mean", "rhat", "ess")


def _close(got, want, name, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


def _same_on_every_rank(outs, keys):
    for out in outs[1:]:
        for k in keys:
            assert torch.equal(out[k], outs[0][k]), k


def _unsharded(setup_name, n_chains, n_steps, seed, coeffs=None):
    """mh.run_chains over the whole batch → (stacked records, final carry)."""
    step, carry = torch_ranks.initial_carry(torch_ranks.SETUPS[setup_name](), n_chains, coeffs)
    final, recs = mh.run_chains(step, carry, n_steps, torch.Generator().manual_seed(seed))
    return mh.stack_records(recs), final


@pytest.mark.parametrize("world", [None, 1, 2, 4])
def test_pooled_diagnostics_match_jax(world, tmp_path):
    """Seeded traces [16, 60, 4] split over 1, 2 and 4 gloo ranks (None: in
    this process, no group): the port's pooled R̂ and ESS against JAX's
    ``split_rhat``/``ess`` of the whole set and JAX's ``pooled_*`` with
    ``axis_name=None``."""
    rng = np.random.RandomState(0)
    x = (rng.randn(16, 60, 4) + 0.3 * rng.randn(16, 1, 4)).astype(np.float32)
    if world is None:
        t = torch.from_numpy(x)
        got = {"rhat": pdiag.pooled_split_rhat(t), "ess": pdiag.pooled_ess(t[..., 0])}
    else:
        outs = torch_ranks.run("diagnostics", world, tmp_path,
                               {"traces": torch.from_numpy(x), "max_lag": 100})
        _same_on_every_rank(outs, ("rhat", "ess"))
        got = outs[0]
    xj = jnp.asarray(x)
    for want in (jdiag.split_rhat(xj), jdiag.pooled_split_rhat(xj, None)):
        _close(got["rhat"], want, "rhat")
    for want in (jdiag.ess(xj[..., 0]), jdiag.pooled_ess(xj[..., 0], None)):
        _close(got["ess"], want, "ess", rtol=1e-4)


def _jax_sphere_run(n_chains, n_steps, burn_in):
    """JAX's ``run_sharded_chains`` on the 8 virtual devices, on the sphere
    of ``test_sharded_runner_multichip`` with stored coefficients."""
    from icp_proposal_tpu.mesh import TriangleMesh, boundary_vertex_mask
    from icp_proposal_tpu.models import gpmm as gp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu.parallel.runner import make_chain_mesh as jmesh
    from icp_proposal_tpu.parallel.runner import run_sharded_chains as jrun
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import IndependentPointsSpec, build_evaluator
    from icp_proposal_tpu.sampling.proposals import (
        IcpSpec,
        MixtureProgram,
        RandomShapeSpec,
        nest,
    )
    from icp_proposal_tpu.sampling.state import init_state

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    points, cells = make_icosphere(subdivisions=1, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=4, sigma=40.0, scale=4.0)
    target = TriangleMesh(points=gp.instance_points(model, jnp.zeros(4).at[0].set(1.0)),
                          cells=model.cells)
    ctx = build_target_context(target)
    mixture = MixtureProgram(
        nest((0.8, [(1.0, IcpSpec(direction="model", n_points=12, step_length=0.2))]),
             (0.2, [(1.0, RandomShapeSpec(sigma=0.2))])),
        model, ctx,
        jnp.asarray(boundary_vertex_mask(np.asarray(model.cells), model.num_points)))
    evaluator = build_evaluator(
        model, ctx, [IndependentPointsSpec(sigma=1.0, mode="model_to_target", n_points=16)])
    step = jmh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry0 = jmh.init_carry(model, evaluator, init_state(model), mixture)
    carries = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape), carry0)
    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    return jrun(step, carries, keys, n_steps, jmesh(), burn_in=burn_in)


def test_pooled_stats_match_jax_sharded_runner(tmp_path):
    """JAX's sharded runner over 8 virtual devices; its records and final
    carry split over 4 gloo ranks of the port's ``pooled_stats``: every
    field of ``PooledStats`` equal to JAX's."""
    burn_in = 10
    final, records, jstats = _jax_sphere_run(16, 50, burn_in)
    inputs = {"accepted": torch.from_numpy(np.array(records.accepted)),
              "coeffs": torch.from_numpy(np.array(records.coeffs)),
              "final_coeffs": torch.from_numpy(np.array(final.state.coeffs)),
              "log_post": torch.from_numpy(np.array(final.log_post)),
              "burn_in": burn_in}
    assert 0.0 < float(jstats.acceptance) < 1.0
    outs = torch_ranks.run("pooled_stats", 4, tmp_path, inputs)
    _same_on_every_rank(outs, STATS)
    for name in STATS:
        _close(outs[0][name], getattr(jstats, name), name, rtol=1e-4 if name == "ess" else 1e-5)


def _check_matches_unsharded(outs, recs_u, final_u):
    """The ranks' chains, in rank order, against the unsharded run."""
    np.testing.assert_array_equal(torch.cat([o["accepted"] for o in outs]).numpy(),
                                  recs_u.accepted.numpy())
    final = torch.cat([o["final_coeffs"] for o in outs])
    _close(final, final_u.state.coeffs, "final coefficients", atol=1e-6)
    _close(outs[0]["coeff_mean"], final.mean(dim=0), "coeff_mean", atol=1e-6)
    acc = float(recs_u.accepted.float().mean())
    assert 0.0 < acc < 1.0, "the chains did no real work"
    _close(outs[0]["acceptance"], acc, "acceptance")


def test_sharded_runner_multichip(tmp_path):
    """The sphere's ICP + random-walk chains, 16 over 4 gloo ranks, equal
    ``mh.run_chains`` of the whole batch with the same seed, chain for
    chain; the pooled mean is the mean of the gathered final states."""
    inp = {"setup": "sphere-icp", "n_chains": 16, "n_steps": 50, "seed": 5, "burn_in": 0,
           "max_lag": 100}
    outs = torch_ranks.run("chains", 4, tmp_path, inp)
    _same_on_every_rank(outs, STATS)
    recs_u, final_u = _unsharded("sphere-icp", 16, 50, seed=5)
    _check_matches_unsharded(outs, recs_u, final_u)


def test_flagship_multichip_matches_unsharded(tmp_path):
    """The flagship femur mixture on the stand-in GPMM-50, 16 chains × 40
    steps over 2 gloo ranks, equals the unsharded run chain for chain, and
    its pooled R̂ and ESS equal ``split_rhat``/``ess`` of the gathered
    traces."""
    inp = {"setup": "flagship50", "n_chains": 16, "n_steps": 40, "seed": 7, "burn_in": 0,
           "max_lag": 100}
    outs = torch_ranks.run("chains", 2, tmp_path, inp)
    _same_on_every_rank(outs, STATS)
    recs_u, final_u = _unsharded("flagship50", 16, 40, seed=7)
    _check_matches_unsharded(outs, recs_u, final_u)
    tail = torch.cat([o["coeffs"] for o in outs])[:, :, :8]
    _close(outs[0]["rhat"], pdiag.split_rhat(tail), "rhat", rtol=1e-4, atol=1e-5)
    _close(outs[0]["ess"], pdiag.ess(tail[..., 0]), "ess", rtol=1e-4)


def test_pooled_diagnostics_read_converged_at_convergence(tmp_path):
    """16 overdispersed random-walk chains on the sphere, 2,000 steps over
    2 gloo ranks, half burned in: the pooled R̂ reads converged (< 1.1) and
    the ESS is substantial but within the sample budget."""
    n_chains, n_steps = 16, 2000
    coeffs = torch.from_numpy(
        1.5 * np.random.RandomState(21).randn(n_chains, 4).astype(np.float32))
    inp = {"setup": "sphere-rw", "n_chains": n_chains, "n_steps": n_steps, "seed": 21,
           "burn_in": n_steps // 2, "max_lag": 200, "coeffs": coeffs}
    outs = torch_ranks.run("chains", 2, tmp_path, inp)
    _same_on_every_rank(outs, STATS)
    acc = float(outs[0]["acceptance"])
    assert 0.1 < acc < 0.9
    rhat_max = float(outs[0]["rhat"].max())
    assert rhat_max < 1.1, f"pooled split-R̂ {rhat_max} did not converge"
    ess0 = float(outs[0]["ess"])
    assert 50.0 < ess0 <= n_chains * (n_steps - n_steps // 2) * 1.01


def test_segment_steps_do_not_change_results():
    """``segment_steps`` only bounds how many steps of records are held
    before stacking: 7-step segments give the one-segment run's records,
    final carry and pooled stats bitwise (one process, no group)."""
    setup = torch_ranks.sphere_icp()
    runs = []
    for segment_steps in (7, None):
        step, carry = torch_ranks.initial_carry(setup, 16)
        runs.append(run_sharded_chains(step, carry, 3, 30, make_chain_mesh(["cpu"]),
                                       burn_in=5, segment_steps=segment_steps))
    (final_a, recs_a, stats_a), (final_b, recs_b, stats_b) = runs
    assert recs_a.accepted.shape == (16, 30)
    for a, b in ((recs_a, recs_b), (stats_a, stats_b), (final_a.state, final_b.state),
                 ((final_a.log_post, final_a.named), (final_b.log_post, final_b.named))):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
