"""The BFM face MH step of the port against the JAX package's, at a small
size (rank 12, subdivision 2: 127 vertices, 232 faces), for the partial
setup (collective symmetric evaluator through K5, rank routed as the
reference routes it) and the complete setup (Euclidean evaluator, fused
closest-point pass).

The JAX side forces its kernels (``ICP_TPU_FORCE_PALLAS=1``,
``ICP_TPU_FORCE_CHOL_PALLAS=1``: interpret mode, shortlist index on); the
port runs its plain twins on the CPU.  The port builds its data from the
JAX arrays through ``convert.py``, takes the JAX step's own noise and starts
each step from the JAX carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_native import use_native_index
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.apps import bfm as pbfm
from icp_proposal_tpu_torch.sampling import mh as pmh

RANK, SUBDIV = 12, 2
N_CHAINS, N_STEPS = 4, 5


@pytest.fixture
def kernels_forced(monkeypatch):
    monkeypatch.setenv("ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    # JAX builds its shortlist index with its native builder, its default,
    # which the port's index equals
    use_native_index(monkeypatch)


@pytest.fixture(scope="module")
def jdata():
    from icp_proposal_tpu.apps import bfm as jbfm

    return jbfm.load_synthetic_face_data(rank=RANK, subdiv=SUBDIV)


def _port_data(jdata):
    return convert.bfm_data_from_arrays(
        {k: np.asarray(v) for k, v in jdata.model._asdict().items()},
        jdata.target.points, jdata.target.cells, jdata.target_partial.points,
        jdata.target_partial.cells, jdata.model_boundary_mask,
        jdata.target_boundary_mask, jdata.partial_boundary_mask, device="cpu")


# ---------------------------------------------------------------------------

def _port_carry(jc):
    st = jc.state
    state = convert.state_from_arrays(
        *(np.asarray(x) for x in (st.scale, st.rot, st.trans, st.center, st.coeffs)),
        device="cpu")
    return convert.carry_from_arrays(
        state, np.asarray(jc.log_post), np.asarray(jc.named),
        [tuple(np.asarray(a) for a in f) for f in jc.icp_factors], device="cpu")


@pytest.mark.parametrize("parity", [False, True], ids=["exact", "parity"])
@pytest.mark.parametrize("partial", [True, False], ids=["partial", "complete"])
def test_bfm_step_parity(jdata, kernels_forced, partial, parity):
    """Rank 12, 4 chains, 5 steps of the BFM partial and complete setups,
    with exact densities and with the reference's own (``parity=True``):
    same proposal index, same accept decision wherever
    |log α − log u| > 1e-3, log posterior within rtol 1e-4."""
    from icp_proposal_tpu.apps import bfm as jbfm
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.proposals import IcpSpec, RandomShapeSpec
    from icp_proposal_tpu.sampling.state import init_state as jinit_state

    jctx, jmix, jev = jbfm.make_bfm_fitting_setup(jdata, partial, parity=parity)
    pdata = _port_data(jdata)
    ctx, mixture, evaluator = pbfm.make_bfm_fitting_setup(pdata, partial, parity=parity)
    assert mixture.parity == jmix.parity == parity
    np.testing.assert_array_equal(ctx.cells.numpy(), jctx.cells)
    np.testing.assert_array_equal(ctx.index.cand.numpy(), jctx.index.cand)
    assert evaluator.named_keys == jev.named_keys
    assert (pmh._fusion_plan(mixture, evaluator) is None) == partial
    step = pmh.make_mh_step(pdata.model, mixture, evaluator, store_params=True)

    jstep = jmh.make_mh_step(jdata.model, jmix, jev, store_params=True)
    carry0 = jax.jit(lambda s: jmh.init_carry(jdata.model, jev, s, jmix))(
        jinit_state(jdata.model))
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (N_CHAINS,) + x.shape), carry0)
    jstep_b = jax.jit(jax.vmap(jstep))
    r, specs = RANK, jmix.specs

    def noise_of(key):  # the draws of mh.py:156 and proposals.py:585-609
        k_prop, k_sel, k_acc = jax.random.split(key, 3)
        ks = jax.random.split(k_prop, len(specs))
        z = []
        for k, s in zip(ks, specs):
            if isinstance(s, (IcpSpec, RandomShapeSpec)):
                z.append(jax.random.normal(k, (r,), jnp.float32))
            else:  # a pose component draws one scalar, read at z[c, 0]
                z.append(jnp.zeros((r,), jnp.float32).at[0].set(
                    jax.random.normal(k, (), jnp.float32)))
        idx = jax.random.categorical(k_sel, jnp.asarray(jmix.log_weights))
        return jnp.stack(z), idx, jnp.log(jax.random.uniform(k_acc))

    noise_b = jax.jit(jax.vmap(noise_of))
    compared = accepted = 0
    for s in range(N_STEPS):
        keys = jax.random.split(jax.random.PRNGKey(200 + s), N_CHAINS)
        jnext, jrec = jstep_b(jcarry, keys)
        z, idx, log_u = (np.array(a) for a in noise_b(keys))
        noise = pmh.StepNoise(z=torch.as_tensor(z), idx=torch.as_tensor(idx).long(),
                              log_u=torch.as_tensor(log_u))
        pnext, prec = step(_port_carry(jcarry), noise)

        np.testing.assert_array_equal(prec.proposal_idx.numpy(),
                                      np.asarray(jrec.proposal_idx))
        clear = np.abs(prec.log_alpha.numpy() - log_u) > 1e-3
        np.testing.assert_array_equal(prec.accepted.numpy()[clear],
                                      np.asarray(jrec.accepted)[clear])
        np.testing.assert_allclose(prec.log_product.numpy(),
                                   np.asarray(jrec.log_product), rtol=1e-4)
        np.testing.assert_allclose(pnext.log_post.numpy()[clear],
                                   np.asarray(jnext.log_post)[clear], rtol=1e-4)
        compared += int(clear.sum())
        accepted += int(np.asarray(jrec.accepted).sum())
        jcarry = jnext
    assert compared >= N_CHAINS * N_STEPS - 2  # near-ties are rare
    assert 0 < accepted < N_CHAINS * N_STEPS  # both decisions were exercised


@pytest.mark.parametrize("partial", [True, False], ids=["partial", "complete"])
def test_run_bfm_fitting_matches_the_step_loop(jdata, tmp_path, partial):
    """``run_bfm_fitting`` on the CPU, 2 chains × 3 steps on the rank-12
    face: its acceptance and ``best_log_value`` equal those of the port's
    own step loop from the same seed (one carry repeated for both chains,
    noise from a generator seeded the same), and its JSON log holds chain
    0's three records."""
    from icp_proposal_tpu_torch.registration.sampling_registration import _expand
    from icp_proposal_tpu_torch.sampling import loggers
    from icp_proposal_tpu_torch.sampling.state import init_state

    data = _port_data(jdata)
    log = tmp_path / "bfm.json"
    result, same = pbfm.run_bfm_fitting(data, partial=partial, num_samples=3, n_chains=2,
                                        json_path=str(log), seed=5, verbose=False,
                                        device="cpu")
    assert same is data and len(loggers.load_log(log)) == 3

    _, mixture, evaluator = pbfm.make_bfm_fitting_setup(data, partial)
    step = pmh.make_mh_step(data.model, mixture, evaluator, store_params=True)
    carry = _expand(pmh.init_carry(data.model, evaluator, init_state(data.model, 1),
                                   mixture), 2)
    _, recs = pmh.run_chains(step, carry, 3, torch.Generator().manual_seed(5))
    rec = pmh.stack_records(recs)
    accepted = rec.accepted.numpy()
    assert result.acceptance["overall"] == pytest.approx(float(accepted.mean()), abs=0)
    assert accepted.any()
    best = np.where(accepted, rec.log_product.numpy(), -np.inf).max()
    assert result.best_log_value == float(best)
