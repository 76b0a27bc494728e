"""The port's femur experiment harnesses and experiment log against the JAX
package's.

``ExperimentLogger`` (same records, same schema, logs read across the
packages), ``_best_states_per_chain`` on seeded records, the JAX package's
own harness tests (``tests/test_components.py::test_std_icp_vs_chain_harness``
and ``::test_random_init_comparison_small``: same sphere, sizes and
thresholds) on the port, and the harness's batched deterministic ICP
against JAX's vmapped ``icp_surface_fitting`` from the same inits, target
points and flips.  All on the CPU (the kernels' plain twins).
"""
import types

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.apps import femur_experiments as pfe


def _sphere(alpha0):
    """The JAX tests' sphere model (icosphere of 162 vertices, radius 50,
    rank-6 synthetic GPMM) on the CPU and its instance at α₀ = alpha0 as
    the target, with the boundary mask."""
    from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask
    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.models.synthetic import make_icosphere, make_synthetic_gpmm

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0, device="cpu")
    alpha = torch.zeros(6)
    alpha[0] = alpha0
    target = TriangleMesh(points=instance_points(model, alpha), cells=model.cells)
    return model, target, boundary_vertex_mask(np.asarray(cells), len(points))


def _log_args(rng, r):
    return dict(
        target_path="targets/0.stl",
        sampling_euclidean_logger_path="logs/e.json",
        coeff_init=rng.randn(r).astype(np.float32),
        coeff_sampling_euclidean=rng.randn(r).astype(np.float32),
        coeff_sampling_hausdorff=rng.randn(r).astype(np.float32),
        coeff_icp=rng.randn(r).astype(np.float32),
        sampling_euclidean={"avg": 0.5, "hausdorff": 2.0, "dice": 0.97},
        sampling_hausdorff={"avg": 0.6, "hausdorff": 1.5, "dice": float("nan")},
        icp={"avg": 0.4, "hausdorff": 2.5, "dice": 0.98},
        num_of_evaluation_points=811, num_of_sample_points=1000, normal_noise=5.0,
        comment="seeded",
    )


def test_experiment_logger_matches_jax(tmp_path):
    """The same appends give the same records (keys, values and types) in
    both loggers apart from ``datetime``; each package reads the other's
    written log back unchanged."""
    from icp_proposal_tpu.io.experiment_log import ExperimentLogger as JLogger
    from icp_proposal_tpu_torch.io.experiment_log import ExperimentLogger

    rng = np.random.RandomState(0)
    jl = JLogger(str(tmp_path / "jax.json"), "model.h5")
    pl = ExperimentLogger(str(tmp_path / "port.json"), "model.h5")
    for i in range(3):
        args = _log_args(rng, 7)
        jl.append(index=i, **args)
        pl.append(index=i, **args)
    assert len(pl.experiments) == 3
    for got, want in zip(pl.experiments, jl.experiments):
        assert list(got) == list(want)
        for k in want:
            if k != "datetime":
                assert type(got[k]) is type(want[k]), k
                np.testing.assert_equal(got[k], want[k], err_msg=k)
    jl.write_log()
    pl.write_log()
    np.testing.assert_equal(ExperimentLogger(jl.file_path).load_log(), jl.experiments)
    np.testing.assert_equal(JLogger(pl.file_path).load_log(), pl.experiments)


def test_best_states_per_chain_matches_jax():
    """Each chain's best accepted sample from seeded records [C=5, T=7],
    chain 2 with no accepted step (step 0, as ``np.argmax`` over −inf
    gives), field by field equal to JAX's list of states."""
    from icp_proposal_tpu.apps.femur_experiments import _best_states_per_chain as jbest

    rng = np.random.RandomState(1)
    c, t, r = 5, 7, 6
    accepted = rng.rand(c, t) > 0.5
    accepted[2] = False
    records = types.SimpleNamespace(
        accepted=accepted, log_product=rng.randn(c, t).astype(np.float32),
        pose=rng.randn(c, t, 9).astype(np.float32), coeffs=rng.randn(c, t, r).astype(
            np.float32))
    got = pfe._best_states_per_chain(records, device="cpu")
    want = jbest(records, None)
    assert got.coeffs.shape == (c, r)
    np.testing.assert_array_equal(got.coeffs[2].numpy(), records.coeffs[2, 0])
    for i, w in enumerate(want):
        for name in ("scale", "trans", "rot", "center", "coeffs"):
            np.testing.assert_array_equal(getattr(got, name)[i].numpy(),
                                          np.asarray(getattr(w, name)), err_msg=name)


def test_initial_states_and_model_samples(tmp_path):
    """Init 0 is the mean shape; every init's coefficients are those of
    ``initialise_shape_parameters`` for its index, whatever the batch; the
    model samples written to STL are the instances at those coefficients."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.models.gpmm import instance_points

    model, _, _ = _sphere(1.0)
    inits = pfe._batched_init_states(model, 4, key=9)
    assert torch.equal(inits.coeffs[0], torch.zeros(6))
    for i in range(4):
        assert torch.equal(inits.coeffs[i], pfe.initialise_shape_parameters(
            6, i, 9, device="cpu"))
    assert torch.equal(pfe._batched_init_states(model, 2, key=9).coeffs, inits.coeffs[:2])
    assert not torch.equal(inits.coeffs[1], inits.coeffs[2])
    big = pfe._batched_init_states(model, 400, key=3).coeffs[1:]
    assert abs(float(big.var()) - 0.1) < 0.01  # √variance·N(0, I), variance 0.1
    pfe.generate_model_samples(model, 3, str(tmp_path), seed=9)
    for i in range(3):
        points, _ = read_stl(tmp_path / f"{i}.stl")
        want = instance_points(model, inits.coeffs[i]).numpy()
        np.testing.assert_allclose(np.sort(points, axis=0), np.sort(want, axis=0),
                                   rtol=0, atol=1e-4)


def test_std_icp_vs_chain_harness(tmp_path):
    """JAX's mini paper-harness test on the port: 1 target, 2 inits, all
    three methods, results in the experiment-log schema (avg < 10 for each
    method, 6 ICP coefficients)."""
    model, target, mask = _sphere(1.0)
    path = tmp_path / "experiments.json"
    logger = pfe.run_std_icp_vs_chain_comparison(
        model, [target], ["synthetic_target"], mask, str(path),
        n_inits=2, n_samples=60, verbose=False, compute_dice=False,
    )
    loaded = logger.load_log()
    assert len(loaded) == 2
    rec = loaded[0]
    assert rec["targetPath"] == "synthetic_target"
    for key in ("samplingEuclidean", "samplingHausdorff", "icp"):
        assert np.isfinite(rec[key]["avg"])
        assert rec[key]["avg"] < 10.0
    assert len(rec["coeffIcp"]) == 6


def test_random_init_comparison_small():
    """JAX's mini ``RunMHRandomInitComparison`` test on the port: the ICP
    chains beat or match the random-walk chains on avg distance (within
    ×1.5)."""
    model, target, mask = _sphere(1.2)
    results = pfe.run_random_init_comparison(
        model, target, mask, mask,
        n_inits=3, n_icp_samples=150, rnd_multiplier=2,
        n_icp_points=40, n_eval_points=60, verbose=False,
    )
    assert len(results) == 6
    icp_avg = np.mean([r["avg"] for r in results if r["method"] == "icp"])
    rnd_avg = np.mean([r["avg"] for r in results if r["method"] == "rnd"])
    assert np.isfinite(icp_avg) and np.isfinite(rnd_avg)
    assert icp_avg < rnd_avg * 1.5


def test_harness_icp_matches_jax():
    """The harness's deterministic ICP (``_icp_batch``: 100 iterations, σ =
    1e-15, both directions) from JAX's inits (``_batched_init_states``) to
    JAX's target points, with the flips JAX draws from each init's key,
    against JAX's vmapped ``icp_surface_fitting``: coefficients within rtol
    1e-4 and atol 1e-4·max|α| after 100 iterations (the sphere's fits
    settle on the same fixed point), the same fallbacks (none)."""
    import jax
    import jax.numpy as jnp

    from icp_proposal_tpu.apps.femur_experiments import _batched_init_states as jinits
    from icp_proposal_tpu.mesh import TriangleMesh as JMesh
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )
    from icp_proposal_tpu.registration.icp_fitting import icp_surface_fitting
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.sampling.context import build_target_context as pctx

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jm = make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0)
    target = JMesh(points=jgp.instance_points(jm, jnp.zeros(6).at[0].set(1.0)),
                   cells=jm.cells)
    n, b = jm.num_points, 4
    inits = jinits(jm, b, jax.random.PRNGKey(5)).coeffs
    model_ids = seeded_vertex_subset(n, n, seed=1024)
    tpts = sample_points_on_surface(jax.random.PRNGKey(6), target, n)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    ctx = build_target_context(target)
    want = np.asarray(jax.jit(jax.vmap(lambda c0, k: icp_surface_fitting(
        jm, ctx, jnp.asarray(model_ids), tpts, num_iterations=100, sigma_seq=(1e-15,),
        projection_direction="model_and_target", initial_coeffs=c0, key=k)))(inits, keys))
    flips = np.stack([np.asarray(jax.vmap(jax.random.bernoulli)(
        jax.random.split(jax.random.fold_in(k, 0), 100))) for k in keys], axis=1)

    pm = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                  device="cpu")
    pc = pctx(make_mesh(np.asarray(target.points), np.asarray(target.cells)), device="cpu")
    got, nonfinite = pfe._icp_batch(pm, pc, model_ids, np.asarray(tpts),
                                    np.asarray(inits), key=0,
                                    flips=flips[None])
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(nonfinite.numpy(), np.zeros(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _jax_sphere(alpha0):
    """JAX's sphere model and its instance at α₀ = alpha0, with the mask."""
    import jax.numpy as jnp

    from icp_proposal_tpu.mesh import TriangleMesh as JMesh
    from icp_proposal_tpu.mesh import boundary_vertex_mask
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

    points, cells = make_icosphere(subdivisions=2, radius=50.0)
    jm = make_synthetic_gpmm(points, cells, rank=6, sigma=40.0, scale=5.0)
    target = JMesh(points=np.asarray(jgp.instance_points(jm, jnp.zeros(6).at[0].set(alpha0))),
                   cells=np.asarray(jm.cells))
    return jm, target, boundary_vertex_mask(np.asarray(cells), len(points))


def _jax_setup(setup, jm, target, mask):
    """JAX's (mixture, evaluator) of one harness setup, built as its
    ``femur_experiments`` builds them."""
    from icp_proposal_tpu.sampling.context import build_target_context
    from icp_proposal_tpu.sampling.evaluators import (
        proximity_and_hausdorff,
        proximity_and_independent,
    )
    from icp_proposal_tpu.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    if setup.startswith("harness"):
        ctx = build_target_context(target)
        mixture = MixtureProgram(nest(
            (0.9, mixed_proposal_icp(n_points=jm.rank * 2,
                                     projection_direction="model_and_target",
                                     tangential_noise=10.0, noise_along_normal=5.0,
                                     step_length=0.1)),
            (0.1, mixed_random_shape_proposal())), jm, ctx, mask)
        evaluator = (proximity_and_hausdorff(jm, ctx, rate=100.0)
                     if setup == "harness-hausdorff" else
                     proximity_and_independent(jm, ctx, mode="model_to_target", sigma=2.0,
                                               n_points=jm.num_points // 2))
        return mixture, evaluator
    ctx = build_target_context(target, mask)
    evaluator = proximity_and_independent(jm, ctx, mode="symmetric", sigma=2.0, n_points=60)
    spec = (mixed_proposal_icp(n_points=40, projection_direction="model")
            if setup == "random-init-icp" else mixed_random_shape_proposal((0.1, 0.01, 0.001)))
    return MixtureProgram(spec, jm, ctx, mask), evaluator


def _port_setup(setup, pm, target, mask):
    """The port's (mixture, evaluator) of one harness setup from its own
    setup builders."""
    if setup.startswith("harness"):
        _, mixture, eval_euclid, eval_hausdorff = pfe._harness_setup(pm, target, mask)
        return mixture, (eval_hausdorff if setup == "harness-hausdorff" else eval_euclid)
    _, evaluator, mix_icp, mix_rnd = pfe._random_init_setup(pm, target, mask, mask, 40, 60)
    return (mix_icp if setup == "random-init-icp" else mix_rnd), evaluator


def _assert_carry_close(got, want, rows):
    """A port carry against a JAX carry on chains ``rows``: log posterior to
    rtol 1e-4, each ICP anchor's (α̂, L, log det M) within rtol 1e-4 and
    atol 1e-4·max|x|."""
    np.testing.assert_allclose(got.log_post.numpy()[rows], np.asarray(want.log_post)[rows],
                               rtol=1e-4)
    assert len(got.icp_factors) == len(want.icp_factors)
    for g, w in zip(got.icp_factors, want.icp_factors):
        for a, b in zip(g, w):
            b = np.asarray(b)[rows]
            np.testing.assert_allclose(a.numpy()[rows], b, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(b).max(), 1e-6))


@pytest.mark.parametrize("setup", ["harness-euclidean", "harness-hausdorff",
                                   "random-init-icp", "random-init-rnd"])
def test_harness_step_parity(setup):
    """The harnesses' MH steps (``_harness_setup``'s mixture with each
    evaluator; ``_random_init_setup``'s two mixtures with the symmetric
    evaluator, at JAX's test sizes) with ``store_params``, 4 inits × 6
    steps on JAX's sphere, the initial carries (log posterior and ICP
    anchors) against JAX's, each port step from JAX's carry with JAX's
    noise (JAX's plain CPU path; its kernels are held to the port's in
    ``test_torch_mh.py``): the same mixture, proposal
    indices, accept decisions wherever |log α − log u| > 1e-3, log product
    to rtol 1e-4, the stored post-step coefficients and pose and the next
    carry's log posterior and anchors within rtol 1e-4 and atol 1e-4·max|x|
    where the decisions are compared; ``_best_states_per_chain`` on the port's
    records matches JAX's on its own, and equals it on JAX's records."""
    import jax
    import jax.numpy as jnp
    from test_torch_mh import _port_carry

    from icp_proposal_tpu.apps import femur_experiments as jfe
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.sampling import mh as pmh

    jm, target, mask = _jax_sphere(1.2 if setup.startswith("random-init") else 1.0)
    jmix, jev = _jax_setup(setup, jm, target, mask)
    pm = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in jm._asdict().items()},
                                  device="cpu")
    mixture, evaluator = _port_setup(setup, pm, make_mesh(target.points, target.cells), mask)
    assert mixture.names == jmix.names
    np.testing.assert_allclose(mixture._log_weights.numpy(), np.asarray(jmix.log_weights),
                               rtol=1e-6)
    assert evaluator.named_keys == list(jev.named_keys)

    n_chains, n_steps, r = 4, 6, jm.rank
    jstep = jax.jit(jax.vmap(jmh.make_mh_step(jm, jmix, jev, store_params=True)))
    step = pmh.make_mh_step(pm, mixture, evaluator, store_params=True)
    inits = jfe._batched_init_states(jm, n_chains, jax.random.PRNGKey(3))
    jcarry = jax.jit(jax.vmap(lambda s: jmh.init_carry(jm, jev, s, jmix)))(inits)
    pstate = convert.state_from_arrays(*(np.asarray(x) for x in (
        inits.scale, inits.rot, inits.trans, inits.center, inits.coeffs)), device="cpu")
    _assert_carry_close(pmh.init_carry(pm, evaluator, pstate, mixture), jcarry,
                        slice(None))

    def noise_of(key):  # the draws of JAX's MH step
        k_prop, k_sel, k_acc = jax.random.split(key, 3)
        ks = jax.random.split(k_prop, mixture.num_components)
        z = jnp.stack([jax.random.normal(k, (r,), jnp.float32) for k in ks])
        idx = jax.random.categorical(k_sel, jnp.asarray(jmix.log_weights))
        return z, idx, jnp.log(jax.random.uniform(k_acc))

    noise_b = jax.jit(jax.vmap(noise_of))
    jrecs, precs = [], []
    compared = accepted = 0
    for s in range(n_steps):
        keys = jax.random.split(jax.random.PRNGKey(40 + s), n_chains)
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
        for name in ("coeffs", "pose"):
            got, want = getattr(prec, name).numpy()[clear], np.asarray(getattr(jrec, name))[clear]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
        _assert_carry_close(pnext, jnext, clear)
        compared += int(clear.sum())
        accepted += int(np.asarray(jrec.accepted).sum())
        jrecs.append(jrec)
        precs.append(prec)
        jcarry = jnext
    assert compared >= n_chains * n_steps - 1  # near-ties are rare
    if setup != "random-init-icp":  # see PERF.md: the model-direction ICP rarely accepts
        assert accepted > 0

    # [C, T] records as the harnesses stack them
    jrecords = jmh.ChainRecord(*(None if x[0] is None else np.stack(
        [np.asarray(v) for v in x], axis=1) for x in zip(*jrecs)))
    stacked = pmh.stack_records(precs)
    precords = pmh.ChainRecord(*(None if x is None else x.numpy() for x in stacked))
    got = pfe._best_states_per_chain(precords, device="cpu")
    on_jax = pfe._best_states_per_chain(jrecords, device="cpu")
    for i, want in enumerate(jfe._best_states_per_chain(jrecords, None)):
        for name in ("scale", "trans", "rot", "center", "coeffs"):
            w = np.asarray(getattr(want, name))
            np.testing.assert_array_equal(getattr(on_jax, name)[i].numpy(), w, err_msg=name)
            np.testing.assert_allclose(getattr(got, name)[i].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=name)


@pytest.mark.parametrize("compute_dice", [False, True])
def test_distance_measures(compute_dice):
    """avg and Hausdorff as ``ops.metrics`` computes them; Dice from the
    generator seeded per (target, init), the same for each method's mesh
    (two calls with one seed agree), NaN without ``compute_dice``."""
    from icp_proposal_tpu_torch.ops.metrics import avg_distance, hausdorff_distance
    from icp_proposal_tpu_torch.sampling.state import init_state, transformed_mesh

    model, target, _ = _sphere(1.0)
    mesh = transformed_mesh(model, init_state(model, 1))
    out = pfe._distance_measures(mesh, target, 123, compute_dice)
    assert out["avg"] == float(avg_distance(mesh, target))
    assert out["hausdorff"] == float(hausdorff_distance(mesh, target))
    if compute_dice:
        assert 0.5 < out["dice"] < 1.0
        assert pfe._distance_measures(mesh, target, 123, True)["dice"] == out["dice"]
    else:
        assert np.isnan(out["dice"])


def test_profiling_helpers(capsys):
    """``wall_timer`` prints the reference's ``ICP-Timing: N sec`` line and
    keeps the seconds (a CPU device needs no synchronization); nothing is
    printed when not verbose."""
    from icp_proposal_tpu_torch.utils.profiling import wall_timer

    with wall_timer("ICP", device="cpu") as held:
        sum(range(1000))
    out = capsys.readouterr().out
    assert out.startswith("ICP-Timing: ") and out.endswith(" sec\n")
    assert float(out.split()[1]) == held["seconds"] > 0
    with wall_timer("X", verbose=False):
        pass
    assert capsys.readouterr().out == ""
