"""Femur workload: data and the MH configurations.

Counterpart of ``icp_proposal_tpu/apps/femur.py``.  The real femur assets
(``femur_gp_model_100-components.h5`` and the landmark-aligned target) are
not in the repository, so ``load_standin_femur_data`` builds a STAND-IN from
two in-repo meshes of the same bone: the model is a femur GPMM built on the
posterior-mean mesh (``artifacts/posterior/mean.stl``, 1,622 vertices,
3,240 faces) with the reference's kernel and Nyström builder at 100
components (rank 101, the flagship's width); the target is the MAP mesh
(``artifacts/posterior/map.stl``) in the same frame.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.io.stl import read_stl
from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
from icp_proposal_tpu_torch.models.gpmm import Gpmm

STANDIN_DIR = Path(__file__).resolve().parents[2] / "artifacts" / "posterior"


@dataclass
class FemurData:
    model: Gpmm
    target: TriangleMesh
    target_boundary_mask: np.ndarray
    model_boundary_mask: np.ndarray


def load_standin_femur_data(device=DEFAULT_DEVICE) -> FemurData:
    """The stand-in femur workload (see module docstring), model on ``device``
    (the card unless ``device="cpu"``)."""
    from icp_proposal_tpu_torch.models.build_femur import build_femur_gpmm

    device = resolve_device(device)  # before the host build, not after

    mpoints, mcells = read_stl(STANDIN_DIR / "mean.stl")
    tpoints, tcells = read_stl(STANDIN_DIR / "map.stl")
    model = build_femur_gpmm(mpoints, mcells, 100, device=device)
    return FemurData(
        model=model,
        target=make_mesh(tpoints, tcells),
        target_boundary_mask=boundary_vertex_mask(tcells, len(tpoints)),
        model_boundary_mask=boundary_vertex_mask(mcells, len(mpoints)),
    )


def make_icp_proposal_setup(data: FemurData, parity: bool = False, coarse: str = "exact"):
    """The flagship MH configuration: 0.9·ICP mixture (model + target
    directions) + 0.1·random shape; Euclidean model→target evaluator, σ = 2;
    evaluator points = 4·rank, ICP points = 2·rank (reference :59-87).

    parity=False (exact densities): the ICP model ids are a stride-2 slice of
    the evaluator's, so one closest-point pass serves both
    (``mh._fusion_plan``).  parity=True: the reference's own transition
    density (no ½·log det M, no relaxation Jacobian) and its independent
    seeded ICP subsets.  coarse: the shortlist index's coarse pass, "exact"
    (K3) or "dot" (K8)."""
    from icp_proposal_tpu_torch.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx, evaluator = _context_and_evaluator(data, 2.0, coarse)
    mixture = MixtureProgram(
        nest(
            (0.9, mixed_proposal_icp(
                n_points=2 * model.rank,
                projection_direction="model_and_target",
                tangential_noise=10.0,
                noise_along_normal=5.0,
                step_length=0.1,
            )),
            (0.1, mixed_random_shape_proposal()),
        ),
        model,
        ctx,
        data.model_boundary_mask,
        parity=parity,
        icp_model_ids=None if parity else evaluator.model_ids("distance")[::2],
    )
    return ctx, mixture, evaluator


def make_hybrid_setup(data: FemurData, icp_weight=0.5, mala_weight=0.4,
                      mala_step=0.1, rw_sigma=0.1, step_length=0.1,
                      sigma_eval=2.0, adapt=True, coarse: str = "exact"):
    """The reference's recommended exact-mode configuration for posterior
    inference: 0.5·ICP mixture (both directions, 2·rank points) + 0.4·MALA
    + 0.1·random walk, with Robbins–Monro scale adaptation (``adapt``);
    Euclidean model→target evaluator of σ = ``sigma_eval`` over 4·rank
    points.  The ICP model ids are a stride-2 slice of the evaluator's, so
    one closest-point pass serves both (``mh._fusion_plan``); MALA's
    gradient takes a second pass of its own."""
    from icp_proposal_tpu_torch.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        gradient_shape_proposal,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx, evaluator = _context_and_evaluator(data, sigma_eval, coarse)
    rw_weight = 1.0 - icp_weight - mala_weight
    mixture = MixtureProgram(
        nest(
            (icp_weight, mixed_proposal_icp(
                n_points=2 * model.rank,
                projection_direction="model_and_target",
                step_length=step_length,
            )),
            (mala_weight, gradient_shape_proposal((mala_step,))),
            (rw_weight, mixed_random_shape_proposal((rw_sigma,))),
        ),
        model,
        ctx,
        data.model_boundary_mask,
        parity=False,
        adapt=AdaptConfig() if adapt else None,
        icp_model_ids=evaluator.model_ids("distance")[::2],
    )
    return ctx, mixture, evaluator


def make_random_walk_setup(data: FemurData, shape_steps=(0.1,), sigma_eval: float = 2.0,
                           adapt: bool = False, coarse: str = "exact"):
    """Random-walk-only configuration (the comparison chain of the
    reference's ``RunMHRandomInitComparison.scala``): random-shape walks
    with one component per step size in ``shape_steps``, Euclidean
    model→target evaluator of σ = ``sigma_eval`` over 4·rank points.
    ``adapt=True`` adds Robbins–Monro scale adaptation toward acceptance
    0.234 ("rw-adapt")."""
    from icp_proposal_tpu_torch.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        mixed_random_shape_proposal,
    )

    model = data.model
    ctx, evaluator = _context_and_evaluator(data, sigma_eval, coarse)
    mixture = MixtureProgram(mixed_random_shape_proposal(shape_steps), model, ctx,
                             data.model_boundary_mask,
                             adapt=AdaptConfig() if adapt else None)
    return ctx, mixture, evaluator


def make_random_walk_adapt_setup(data: FemurData, **kw):
    """``make_random_walk_setup`` with scale adaptation on."""
    return make_random_walk_setup(data, adapt=True, **kw)


def make_mala_setup(data: FemurData, step_sizes=(0.1,), sigma_eval=2.0, adapt=True,
                    coarse: str = "exact"):
    """MALA-only configuration with scale adaptation toward the
    Langevin-optimal acceptance 0.574: one gradient of the product posterior
    a step and no GP-posterior solves; Euclidean model→target evaluator of
    σ = ``sigma_eval`` over 4·rank points."""
    from icp_proposal_tpu_torch.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        gradient_shape_proposal,
    )

    model = data.model
    ctx, evaluator = _context_and_evaluator(data, sigma_eval, coarse)
    mixture = MixtureProgram(gradient_shape_proposal(step_sizes), model, ctx,
                             data.model_boundary_mask,
                             adapt=AdaptConfig() if adapt else None)
    return ctx, mixture, evaluator


def _context_and_evaluator(data: FemurData, sigma_eval: float, coarse: str):
    """The target context (shortlist index, coarse pass ``coarse``) and the
    Euclidean model→target evaluator of σ = ``sigma_eval`` over 4·rank
    points, which every femur setup shares."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask, coarse=coarse,
                               device=model.device)
    return ctx, proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=sigma_eval, n_points=4 * model.rank)


# The named setups (CLI --setup values).  "parity" is the reference recipe
# with the reference's own transition density; every other row is exact MH.
SETUPS = {
    "flagship": make_icp_proposal_setup,
    "parity": lambda data, coarse="exact": make_icp_proposal_setup(
        data, parity=True, coarse=coarse),
    "hybrid": make_hybrid_setup,
    "rw": make_random_walk_setup,
    "rw-adapt": make_random_walk_adapt_setup,
    "mala": make_mala_setup,
}

# The reference's recommended default (its argmax of ESS per wall second).
RECOMMENDED_SETUP = "rw"


def recommended_setup() -> str:
    """Name of the recommended exact-mode configuration (``RECOMMENDED_SETUP``)."""
    return RECOMMENDED_SETUP


def run_icp_proposal_registration(num_samples: int = 10000, n_chains: int = 1,
                                  json_path=None, seed: int = 1024, verbose: bool = True,
                                  resume_log=None, resume_mode: str = "best",
                                  setup: str | None = None, coarse: str = "exact",
                                  data: FemurData | None = None,
                                  accept_info_interval: int = 1000,
                                  device=DEFAULT_DEVICE):
    """End-to-end registration run (reference ``IcpProposalRegistration.main``)
    → (FittingResult, data).

    data: the femur workload; None builds the stand-in
    (``load_standin_femur_data``) on ``device`` (the card unless
    ``device="cpu"``), because the real assets are absent.  setup: a
    ``SETUPS`` key, default ``RECOMMENDED_SETUP``; coarse: the shortlist's
    coarse pass ("exact" K3, "dot" K8).  Segments of
    min(num_samples, accept_info_interval) steps; json_path gets chain 0's
    log; resume_log/resume_mode restart from such a log ("best" = its MAP
    record, "last" = its last accepted record)."""
    from icp_proposal_tpu_torch.registration.comparison import evaluate_reconstruction
    from icp_proposal_tpu_torch.registration.sampling_registration import (
        SamplingRegistration,
    )
    from icp_proposal_tpu_torch.sampling.state import transformed_mesh

    if data is None:
        data = load_standin_femur_data(device=device)
    _, mixture, evaluator = SETUPS[setup or RECOMMENDED_SETUP](data, coarse=coarse)
    reg = SamplingRegistration(data.model, data.target, mixture, evaluator,
                               accept_info_interval=accept_info_interval, verbose=verbose)
    result = reg.runfitting(num_samples, seed=seed, n_chains=n_chains, json_path=json_path,
                            resume_log=resume_log, resume_mode=resume_mode)
    if verbose:
        evaluate_reconstruction("SAMPLE", transformed_mesh(data.model, result.best_state),
                                data.target)
    return result, data


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Femur registration on the stand-in femur GPMM-100 (the real "
                    "assets are absent)")
    p.add_argument("mode", nargs="?", default="proposal", choices=["proposal"],
                   help="proposal = MH ICP-proposal chains (deterministic ICP is "
                        "not ported yet)")
    p.add_argument("--samples", type=int, default=10000)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--json", type=str, default=None,
                   help="write chain 0's log here in the reference's JSON schema")
    p.add_argument("--resume-log", type=str, default=None,
                   help="restart from a previous run's JSON chain log")
    p.add_argument("--resume-mode", choices=["best", "last"], default="best")
    p.add_argument("--setup", choices=sorted(SETUPS), default=None,
                   help="flagship = reference recipe, exact densities; parity = "
                        "reference recipe + reference density; hybrid = exact-mode "
                        "ICP + MALA + random walk with scale adaptation; rw / "
                        "rw-adapt / mala = random walk, adaptive random walk, "
                        f"adaptive MALA. Default: {RECOMMENDED_SETUP!r}")
    p.add_argument("--coarse", choices=["exact", "dot"], default="exact",
                   help="the shortlist's coarse pass: exact nearest vertex (K3) or "
                        "its dot form (K8)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="'cuda' (the card) or 'cpu' (the kernels' plain versions)")
    args = p.parse_args(argv)
    run_icp_proposal_registration(
        num_samples=args.samples, n_chains=args.chains, json_path=args.json,
        resume_log=args.resume_log, resume_mode=args.resume_mode,
        setup=args.setup, coarse=args.coarse, device=args.device)


if __name__ == "__main__":
    main()
