"""Femur experiment harnesses: the paper's comparisons.

Counterpart of ``icp_proposal_tpu/apps/femur_experiments.py``:

* ``run_random_init_comparison``: the reference's
  ``RunMHRandomInitComparison.scala:34-89``, ICP-proposal chains against
  random-walk chains from N random inits;
* ``run_std_icp_vs_chain_comparison``: the paper's harness
  ``StdIcpVsChainICPrandomInitComparisonAll.scala:40-166``, per target and
  random init the deterministic ICP, MH with the Euclidean evaluator and MH
  with the Hausdorff evaluator, every result into the experiment log.

The inits are the batch axis: all inits of a method run as one batch of
chains (or of ICP fits) on the model's device.  Random numbers come from
``torch.Generator``s seeded from ``seed`` and the (target, stage, init)
indices (``_fold_in``), where the JAX package folds them into its keys.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.mesh import TriangleMesh
from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.ops.metrics import avg_distance, dice_coefficient, hausdorff_distance
from icp_proposal_tpu_torch.sampling import mh
from icp_proposal_tpu_torch.sampling.context import build_target_context
from icp_proposal_tpu_torch.sampling.evaluators import (
    proximity_and_hausdorff,
    proximity_and_independent,
)
from icp_proposal_tpu_torch.sampling.proposals import (
    MixtureProgram,
    mixed_proposal_icp,
    mixed_random_shape_proposal,
    nest,
)
from icp_proposal_tpu_torch.sampling.state import FitState, init_state, transformed_mesh


def _fold_in(seed: int, *data: int) -> int:
    """A 64-bit generator seed derived from ``seed`` and the indices
    ``data`` (the role of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, *data]).generate_state(1, np.uint64)[0])


def generate_model_samples(model, n: int, out_dir: str, variance: float = 0.1,
                           seed: int = 1024):
    """Write n random model-instance meshes to ``out_dir/{i}.stl``, the
    ``modelsamples`` assets that ``RunMHRandomInitComparison.scala:71-72``
    reads for its random inits (index 0 = the mean shape)."""
    from icp_proposal_tpu_torch.io.stl import write_stl

    os.makedirs(out_dir, exist_ok=True)
    cells = model.cells.cpu().numpy()
    for i in range(n):
        coeffs = initialise_shape_parameters(model.rank, i, seed, variance,
                                             device=model.device)
        pts = gp.instance_points(model, coeffs).cpu().numpy()
        write_stl(os.path.join(out_dir, f"{i}.stl"), pts, cells)
    return out_dir


def initialise_shape_parameters(rank: int, index: int, key: int, variance: float = 0.1,
                                device=DEFAULT_DEVICE) -> torch.Tensor:
    """Random init coefficients [rank]: index 0 → zeros, else
    √variance·N(0, I) from a generator seeded by (key, index) (reference
    ``RandomSamplesFromModel.scala:28-36``), on ``device``."""
    device = resolve_device(device)
    if index == 0:
        return torch.zeros(rank, device=device)
    gen = torch.Generator().manual_seed(_fold_in(key, index))
    return (math.sqrt(variance) * torch.randn(rank, generator=gen)).to(device)


def _batched_init_states(model, n_inits: int, key: int, variance: float = 0.1) -> FitState:
    """The zero pose and ``initialise_shape_parameters`` of inits 0..n−1, as
    one FitState [n_inits] on the model's device."""
    coeffs = torch.stack([initialise_shape_parameters(model.rank, i, key, variance,
                                                      device="cpu")
                          for i in range(n_inits)])
    return init_state(model, n_inits)._replace(coeffs=coeffs.to(model.device))


def _run_batch(model, mixture, evaluator, init_states: FitState, n_steps: int, key: int):
    """``n_steps`` MH steps of every init as one batch of chains (noise from
    a generator seeded with ``key``) → the records as numpy [C, T, ...]
    arrays, stacked once at the end."""
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    carry = mh.init_carry(model, evaluator, init_states, mixture)
    gen = torch.Generator(device=model.device).manual_seed(key)
    _, records = mh.run_chains(step, carry, n_steps, gen)
    stacked = mh.stack_records(records)
    del records
    return mh.ChainRecord(*(None if x is None else x.cpu().numpy() for x in stacked))


def _best_states_per_chain(records, device=DEFAULT_DEVICE) -> FitState:
    """Each chain's best accepted sample (largest log product) as one
    FitState [C] with scale 1 on ``device`` (the records' pose holds the
    rotation center); a chain with no accepted step takes its step 0, as
    ``np.argmax`` over all −inf does."""
    acc = np.asarray(records.accepted)  # [C, T]
    logv = np.where(acc, np.asarray(records.log_product), -np.inf)
    t = np.argmax(logv, axis=1)
    rows = np.arange(acc.shape[0])
    pose = np.asarray(records.pose, np.float32)[rows, t]  # [C, 9]
    coeffs = np.asarray(records.coeffs, np.float32)[rows, t]
    device = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return FitState(scale=tensor(np.ones(len(rows), np.float32)), trans=tensor(pose[:, 0:3]),
                    rot=tensor(pose[:, 3:6]), center=tensor(pose[:, 6:9]),
                    coeffs=tensor(coeffs))


def _icp_batch(model, ctx, model_ids, target_points, init_coeffs, key: int, flips=None):
    """The deterministic ICP of the paper's harness from every init at once:
    100 iterations, σ = 1e-15, model_and_target, flips from a generator
    seeded with ``key`` unless given → (coefficients [B, r], non-finite
    iterations [B])."""
    from icp_proposal_tpu_torch.registration.icp_fitting import icp_surface_fitting

    return icp_surface_fitting(model, ctx, model_ids, target_points, num_iterations=100,
                               sigma_seq=(1e-15,), projection_direction="model_and_target",
                               initial_coeffs=init_coeffs, key=key, flips=flips)


def _distance_measures(mesh: TriangleMesh, target: TriangleMesh, dice_seed: int,
                       compute_dice: bool) -> dict:
    """avg and Hausdorff distance to the target (K5) and, with
    ``compute_dice``, the Monte-Carlo Dice overlap from a generator seeded
    with ``dice_seed`` (NaN without)."""
    out = {"avg": float(avg_distance(mesh, target)),
           "hausdorff": float(hausdorff_distance(mesh, target))}
    dev = mesh.points.device
    out["dice"] = (float(dice_coefficient(
        mesh, target, generator=torch.Generator(device=dev).manual_seed(dice_seed)))
        if compute_dice else float("nan"))
    return out


def _random_init_setup(model, target: TriangleMesh, model_boundary, target_boundary,
                       n_icp_points: Optional[int] = None,
                       n_eval_points: Optional[int] = None):
    """``run_random_init_comparison``'s setups on the model's device: the
    symmetric Euclidean evaluator (σ = 2), the model-direction ICP mixture
    and the random-shape mixture, full-resolution point counts unless given
    → (context, evaluator, ICP mixture, random-walk mixture)."""
    ctx = build_target_context(target, target_boundary, device=model.device)
    n_icp_points = n_icp_points or model.num_points
    n_eval_points = n_eval_points or model.num_points
    model_boundary = np.asarray(model_boundary, bool)
    evaluator = proximity_and_independent(model, ctx, mode="symmetric", sigma=2.0,
                                          n_points=n_eval_points)
    mix_icp = MixtureProgram(mixed_proposal_icp(n_points=n_icp_points,
                                                projection_direction="model"),
                             model, ctx, model_boundary)
    mix_rnd = MixtureProgram(mixed_random_shape_proposal((0.1, 0.01, 0.001)),
                             model, ctx, model_boundary)
    return ctx, evaluator, mix_icp, mix_rnd


def _harness_setup(model, target: TriangleMesh, model_boundary, normal_noise: float = 5.0):
    """The paper's harness setups for one target on the model's device: the
    MH mixture 0.9·ICP (2·rank points, both directions, tangential noise
    10, normal noise ``normal_noise``, step 0.1) + 0.1·random shape, the
    Euclidean model→target evaluator (σ = 2 over ``num_points // 2``
    points) and the Hausdorff evaluator (rate 100) → (context, mixture,
    Euclidean evaluator, Hausdorff evaluator)."""
    ctx = build_target_context(target, device=model.device)
    eval_euclid = proximity_and_independent(model, ctx, mode="model_to_target", sigma=2.0,
                                            n_points=model.num_points // 2)
    eval_hausdorff = proximity_and_hausdorff(model, ctx, rate=100.0)
    mixture = MixtureProgram(
        nest(
            (0.9, mixed_proposal_icp(
                n_points=model.rank * 2, projection_direction="model_and_target",
                tangential_noise=10.0, noise_along_normal=normal_noise, step_length=0.1,
            )),
            (0.1, mixed_random_shape_proposal()),
        ),
        model, ctx, np.asarray(model_boundary, bool),
    )
    return ctx, mixture, eval_euclid, eval_hausdorff


def run_random_init_comparison(
    model,
    target: TriangleMesh,
    model_boundary,
    target_boundary,
    n_inits: int = 5,
    n_icp_samples: int = 1000,
    rnd_multiplier: int = 5,
    n_icp_points: Optional[int] = None,
    n_eval_points: Optional[int] = None,
    seed: int = 1024,
    verbose: bool = True,
):
    """ICP-proposal chains against random-walk chains from N random inits
    (reference ``RunMHRandomInitComparison``: ICP 1,000 samples, random walk
    ``rnd_multiplier`` times as many, model-direction ICP, symmetric
    Euclidean evaluator, full-resolution point counts by default) on the
    model's device → one dict per (method, init): method, init, avg,
    hausdorff, best_coeffs."""
    dev = model.device
    _, evaluator, mix_icp, mix_rnd = _random_init_setup(
        model, target, model_boundary, target_boundary, n_icp_points, n_eval_points)

    inits = _batched_init_states(model, n_inits, _fold_in(seed, 0))
    rec_icp = _run_batch(model, mix_icp, evaluator, inits, n_icp_samples, _fold_in(seed, 1))
    rec_rnd = _run_batch(model, mix_rnd, evaluator, inits, n_icp_samples * rnd_multiplier,
                         _fold_in(seed, 2))

    results = []
    for tag, recs in (("icp", rec_icp), ("rnd", rec_rnd)):
        best = _best_states_per_chain(recs, dev)
        for i in range(n_inits):
            mesh = transformed_mesh(model, best, chain=i)
            results.append({
                "method": tag,
                "init": i,
                "avg": float(avg_distance(mesh, target)),
                "hausdorff": float(hausdorff_distance(mesh, target)),
                "best_coeffs": best.coeffs[i].cpu().numpy(),
            })
            if verbose:
                r = results[-1]
                print(f"{tag} init={i} avg={r['avg']:.3f} hausdorff={r['hausdorff']:.3f}")
    return results


def run_std_icp_vs_chain_comparison(
    model,
    targets: Sequence[TriangleMesh],
    target_paths: Sequence[str],
    model_boundary,
    experiment_path: str,
    model_path: str = "",
    n_inits: int = 100,
    n_samples: int = 1000,
    normal_noise: float = 5.0,
    seed: int = 1024,
    verbose: bool = True,
    compute_dice: bool = True,
):
    """The paper's harness (``StdIcpVsChainICPrandomInitComparisonAll``) on
    the model's device: per target, all inits as one batch for (a) the
    deterministic ICP, (b) MH with the Euclidean model→target evaluator
    (σ = 2 over ``num_points // 2`` points) and (c) MH with the Hausdorff
    evaluator (rate 100); the MH mixture is 0.9·ICP (2·rank points, both
    directions, tangential noise 10, normal noise ``normal_noise``, step
    0.1) + 0.1·random shape.  avg, Hausdorff and Dice of each method's
    result and the coefficients go into the experiment log, written to
    ``experiment_path`` after each target → the ``ExperimentLogger``."""
    from icp_proposal_tpu_torch.io.experiment_log import ExperimentLogger
    from icp_proposal_tpu_torch.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )

    logger = ExperimentLogger(experiment_path, model_path)
    dev = model.device
    n_eval = model.num_points // 2

    for t_idx, (target, tpath) in enumerate(zip(targets, target_paths)):
        ctx, mixture, eval_euclid, eval_hausdorff = _harness_setup(model, target,
                                                                   model_boundary, normal_noise)
        inits = _batched_init_states(model, n_inits, _fold_in(seed, t_idx, 0))

        # (a) the deterministic ICP over all inits as one batch
        model_ids = seeded_vertex_subset(model.num_points, model.num_points, seed=seed)
        target_pts = sample_points_on_surface(
            target, model.num_points,
            generator=torch.Generator(device=dev).manual_seed(_fold_in(seed, t_idx, 1)),
            device=dev)
        icp_coeffs, icp_nonfinite = _icp_batch(model, ctx, model_ids, target_pts,
                                               inits.coeffs, _fold_in(seed, t_idx, 2))

        # (b), (c) MH chains from the same inits
        rec_e = _run_batch(model, mixture, eval_euclid, inits, n_samples,
                           _fold_in(seed, t_idx, 3))
        rec_h = _run_batch(model, mixture, eval_hausdorff, inits, n_samples,
                           _fold_in(seed, t_idx, 4))
        best_e = _best_states_per_chain(rec_e, dev)
        best_h = _best_states_per_chain(rec_h, dev)
        icp_states = init_state(model, n_inits)._replace(coeffs=icp_coeffs)
        if verbose:
            print(f"target={t_idx} deterministic ICP: {int((icp_nonfinite > 0).sum())} of "
                  f"{n_inits} inits kept their coefficients on a non-finite iteration "
                  f"({int(icp_nonfinite.sum())} iterations)")

        for i in range(n_inits):
            dice_seed = _fold_in(seed, t_idx, 1000 + i)
            measures = {name: _distance_measures(transformed_mesh(model, states, chain=i),
                                                 target, dice_seed, compute_dice)
                        for name, states in (("euclidean", best_e), ("hausdorff", best_h),
                                             ("icp", icp_states))}
            logger.append(
                index=i,
                target_path=str(tpath),
                coeff_init=inits.coeffs[i].cpu().numpy(),
                coeff_sampling_euclidean=best_e.coeffs[i].cpu().numpy(),
                coeff_sampling_hausdorff=best_h.coeffs[i].cpu().numpy(),
                coeff_icp=icp_coeffs[i].cpu().numpy(),
                sampling_euclidean=measures["euclidean"],
                sampling_hausdorff=measures["hausdorff"],
                icp=measures["icp"],
                num_of_evaluation_points=n_eval,
                num_of_sample_points=n_samples,
                normal_noise=normal_noise,
            )
            if verbose:
                e = logger.experiments[-1]
                print(
                    f"target={t_idx} init={i} "
                    f"icp_avg={e['icp']['avg']:.3f} "
                    f"euclid_avg={e['samplingEuclidean']['avg']:.3f} "
                    f"hausdorff_avg={e['samplingHausdorff']['avg']:.3f}"
                )
        logger.write_log()
    return logger
