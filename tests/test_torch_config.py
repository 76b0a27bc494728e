"""The port's run configuration against the JAX package's, on the CPU.

``RunConfig`` must serialize to JAX's JSON and read JAX's back;
``build_from_config`` must build JAX's mixture (names, weights, specs) and
evaluator (specs, ``named_keys``) for the default flagship recipe, with pose
proposals on, and for each evaluator ``kind``; one MH step of each, from
JAX's carry with JAX's noise, must take JAX's decisions (the form of
``tests/test_torch_experiments.py::test_harness_step_parity``, on the sphere
of ``tests/test_mh.py``, JAX on its plain CPU path).  Then the ICP mixture
in distribution: the flagship recipe from each package's own
``build_from_config(RunConfig())``, chains from the same starts, each with
its own random stream: posterior means within 4 Monte-Carlo standard errors
and per-component acceptance within 0.05 (the form of
``tests/test_torch_mala_chains.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.mesh import make_mesh
from icp_proposal_tpu_torch.sampling import mh as pmh
from icp_proposal_tpu_torch.utils import config as pconfig

RANK = 6


@pytest.fixture(scope="module")
def sphere():
    """(JAX model, port model on the CPU, JAX target mesh, boundary mask):
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


def _configs():
    """name → (JAX RunConfig, port RunConfig), the same settings."""
    from icp_proposal_tpu.utils import config as jconfig

    out = {}
    for name in ("default", "pose", "options", "hausdorff", "collective", "acceptall"):
        cfgs = (jconfig.RunConfig(), pconfig.RunConfig())
        for cfg in cfgs:
            if name == "pose":
                cfg.pose.weight = 0.4
            elif name == "options":  # every other knob of the mixture and evaluator
                cfg.icp = dataclasses.replace(
                    cfg.icp, weight=0.6, projection_direction="model", step_length=0.3,
                    tangential_noise=4.0, noise_along_normal=2.0, n_points=20,
                    boundary_aware=False)
                cfg.random_shape.weight, cfg.random_shape.steps = 0.3, (0.05, 0.2)
                cfg.pose.weight, cfg.pose.trans_sigma = 0.1, (0.2, 0.1, 0.3)
                cfg.evaluator.mode, cfg.evaluator.sigma = "symmetric", 1.5
                cfg.evaluator.n_points = 30
            elif name == "collective":
                cfg.evaluator.kind, cfg.evaluator.mode = "collective", "symmetric"
                cfg.evaluator.sigma, cfg.evaluator.rate, cfg.evaluator.mean = 0.3, 1.0, 0.1
            elif name != "default":
                cfg.evaluator.kind = name
        out[name] = cfgs
    return out


def test_runconfig_round_trip_matches_jax():
    """Defaults (the flagship recipe) and JSON: the port's ``to_json`` is
    JAX's text, each reads the other's JSON back to an equal config, for the
    default and for a config with every section changed."""
    from icp_proposal_tpu.utils import config as jconfig

    cfg = pconfig.RunConfig()
    assert (cfg.icp.weight, cfg.icp.projection_direction, cfg.random_shape.weight,
            cfg.random_shape.steps, cfg.evaluator.kind, cfg.evaluator.sigma) == (
        0.9, "model_and_target", 0.1, (0.1,), "independent", 2.0)
    assert pconfig.RunConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_json() == jconfig.RunConfig().to_json()

    changed = {"model_components": 100, "decimate_model_to": 2000,
               "icp": {"weight": 0.5, "projection_direction": "target", "n_points": 30,
                       "boundary_aware": False},
               "random_shape": {"weight": 0.2, "steps": [0.05, 0.2]},
               "pose": {"weight": 0.3, "rot_sigma": [0.02, 0.01, 0.03]},
               "evaluator": {"kind": "collective", "mode": "symmetric", "n_points": 50},
               "chain": {"num_samples": 77, "n_chains": 4, "parity": True}}
    text = json.dumps(changed)
    got, want = pconfig.RunConfig.from_json(text), jconfig.RunConfig.from_json(text)
    assert got.to_json() == want.to_json()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.random_shape.steps == (0.05, 0.2) and got.pose.trans_sigma == (0.1,) * 3
    assert jconfig.RunConfig.from_json(got.to_json()) == want


def _spec_rows(specs):
    return [(type(s).__name__, dataclasses.asdict(s)) for s in specs]


@pytest.mark.parametrize("case", ["default", "pose", "options", "hausdorff",
                                  "collective", "acceptall"])
def test_build_from_config_matches_jax(sphere, case):
    """Each config (the default, pose proposals on, every other knob of the
    mixture and the evaluator changed, each evaluator ``kind``): the same
    mixture (names, weights, specs, parity) and evaluator (specs,
    ``named_keys``) as JAX's ``build_from_config``; then 4 chains from
    JAX's random inits × 4 steps, each port step from JAX's
    carry with JAX's noise: the same proposal indices, the same decisions
    wherever |log α − log u| > 1e-3, log product to rtol 1e-4, the next
    carry's log posterior to rtol 1e-4 where the decisions are compared."""
    from icp_proposal_tpu.apps import femur_experiments as jfe
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.proposals import IcpSpec, RandomShapeSpec
    from icp_proposal_tpu.utils.config import build_from_config as jbuild
    from test_torch_mh import _port_carry

    jm, pm, target, mask = sphere
    jcfg, cfg = _configs()[case]
    _, jmix, jev = jbuild(jcfg, jm, target, mask, mask)
    ctx, mixture, evaluator = pconfig.build_from_config(
        cfg, pm, make_mesh(target.points, target.cells), mask, mask)
    assert mixture.ctx is ctx and evaluator.ctx is ctx
    assert mixture.names == jmix.names
    assert len(mixture.specs) == {"pose": 9, "options": 9}.get(case, 3)
    np.testing.assert_allclose(mixture.weights, jmix.weights, rtol=1e-12)
    assert _spec_rows(mixture.specs) == _spec_rows(jmix.specs)
    assert mixture.parity == jmix.parity is False
    assert evaluator.named_keys == list(jev.named_keys)
    assert _spec_rows(evaluator.specs) == _spec_rows(jev.specs)

    n_chains, n_steps, r = 4, 4, RANK
    jstep = jax.jit(jax.vmap(jmh.make_mh_step(jm, jmix, jev, store_params=True)))
    step = pmh.make_mh_step(pm, mixture, evaluator, store_params=True)
    inits = jfe._batched_init_states(jm, n_chains, jax.random.PRNGKey(5))
    jcarry = jax.jit(jax.vmap(lambda s: jmh.init_carry(jm, jev, s, jmix)))(inits)
    specs = jmix.specs

    def noise_of(key):  # the draws of JAX's MH step and propose_all
        k_prop, k_sel, k_acc = jax.random.split(key, 3)
        ks = jax.random.split(k_prop, len(specs))
        z = [jax.random.normal(k, (r,), jnp.float32)
             if isinstance(s, (IcpSpec, RandomShapeSpec)) else
             jnp.zeros((r,), jnp.float32).at[0].set(jax.random.normal(k, (), jnp.float32))
             for k, s in zip(ks, specs)]  # a pose component reads z[c, 0]
        idx = jax.random.categorical(k_sel, jnp.asarray(jmix.log_weights))
        return jnp.stack(z), idx, jnp.log(jax.random.uniform(k_acc))

    noise_b = jax.jit(jax.vmap(noise_of))
    compared = 0
    for s in range(n_steps):
        keys = jax.random.split(jax.random.PRNGKey(60 + s), n_chains)
        jnext, jrec = jstep(jcarry, keys)
        z, idx, log_u = (np.array(a) for a in noise_b(keys))
        pnext, prec = step(_port_carry(jcarry), pmh.StepNoise(
            z=torch.as_tensor(z), idx=torch.as_tensor(idx).long(),
            log_u=torch.as_tensor(log_u)))
        np.testing.assert_array_equal(prec.proposal_idx.numpy(), np.asarray(jrec.proposal_idx))
        clear = np.abs(prec.log_alpha.numpy() - log_u) > 1e-3
        np.testing.assert_array_equal(prec.accepted.numpy()[clear],
                                      np.asarray(jrec.accepted)[clear])
        np.testing.assert_allclose(prec.log_product.numpy(), np.asarray(jrec.log_product),
                                   rtol=1e-4)
        np.testing.assert_allclose(pnext.log_post.numpy()[clear],
                                   np.asarray(jnext.log_post)[clear], rtol=1e-4)
        compared += int(clear.sum())
        jcarry = jnext
    assert compared >= n_chains * n_steps - 1  # near-ties are rare


def test_build_from_config_rejects_unknown_kind(sphere):
    _, pm, target, mask = sphere
    cfg = pconfig.RunConfig()
    cfg.evaluator.kind = "chamfer"
    with pytest.raises(ValueError, match="unknown evaluator kind"):
        pconfig.build_from_config(cfg, pm, make_mesh(target.points, target.cells), mask, mask)


def _np_ess():
    from test_torch_mala_chains import _np_ess as np_ess_loader

    return np_ess_loader()


def test_flagship_config_chains_match_jax(sphere):
    """The ICP mixture in distribution: each package's
    ``build_from_config(RunConfig())`` (ICP 0.9 in both directions, random
    shape 0.1, Euclidean σ = 2 over 4·rank points) on the sphere, 32 chains
    × 600 steps from the same starts, each package with its own random
    stream: per-coefficient posterior means over steps 200–600 within 4
    Monte-Carlo standard errors (from each side's ESS), and the acceptance
    of each mixture component within 0.05."""
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.state import init_state as jinit_state
    from icp_proposal_tpu.utils.config import RunConfig as JRunConfig
    from icp_proposal_tpu.utils.config import build_from_config as jbuild
    from icp_proposal_tpu_torch.sampling.state import init_state

    jm, pm, target, mask = sphere
    n_chains, n_steps, burn = 32, 600, 200
    starts = np.random.RandomState(11).randn(n_chains, RANK).astype(np.float32) * 0.5

    _, jmix, jev = jbuild(JRunConfig(), jm, target, mask, mask)
    jstep = jmh.make_mh_step(jm, jmix, jev, store_params=True)
    jstates = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape),
                           jinit_state(jm))._replace(coeffs=jnp.asarray(starts))
    jcarry = jax.vmap(lambda s: jmh.init_carry(jm, jev, s, jmix))(jstates)
    _, jrec = jmh.run_chains(jstep, jcarry, jax.random.split(jax.random.PRNGKey(4),
                                                             n_chains), n_steps)

    _, mix, ev = pconfig.build_from_config(pconfig.RunConfig(), pm,
                                           make_mesh(target.points, target.cells), mask, mask)
    assert mix.names == jmix.names
    state = init_state(pm, n_chains)._replace(coeffs=torch.as_tensor(starts))
    step = pmh.make_mh_step(pm, mix, ev, store_params=True)
    carry = pmh.init_carry(pm, ev, state, mix)
    _, recs = pmh.run_chains(step, carry, n_steps, torch.Generator().manual_seed(4))
    prec = pmh.stack_records(recs)

    np_ess = _np_ess()
    stats = []
    for coeffs in (np.asarray(jrec.coeffs), prec.coeffs.numpy()):
        trace = coeffs[:, burn:]
        flat = trace.reshape(-1, RANK)
        stats.append((flat.mean(axis=0), flat.std(axis=0) / np.sqrt(np_ess(trace))))
    (jmean, jse), (pmean, pse) = stats
    z = np.abs(pmean - jmean) / np.sqrt(jse ** 2 + pse ** 2)
    assert np.all(z < 4.0), (pmean, jmean, z)
    for mean in (jmean, pmean):  # both moved from the prior toward α = (1.5, −1, …)
        assert mean[0] > 0 > mean[1]

    for i, name in enumerate(mix.names):
        acc = []
        for idx, accepted in ((np.asarray(jrec.proposal_idx), np.asarray(jrec.accepted)),
                              (prec.proposal_idx.numpy(), prec.accepted.numpy())):
            sel = idx[:, burn:] == i
            assert sel.sum() > 500, name
            acc.append(accepted[:, burn:][sel].mean())
        assert abs(acc[0] - acc[1]) < 0.05, (name, acc)
