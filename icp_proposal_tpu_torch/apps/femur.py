"""Femur workload: data, the MH configurations and the entry points.

Counterpart of ``icp_proposal_tpu/apps/femur.py`` (the reference's
``apps/femur`` package: ``Paths.scala``, ``LoadTestData.scala``,
``IcpProposalRegistration.scala``, ``IcpRegistration.scala``).
``load_femur_data`` reads the real assets (statismo model, landmarks, STL
target) from a directory the caller names.  Without them,
``load_standin_femur_data`` builds a STAND-IN from two in-repo meshes of the
same bone: the model is a femur GPMM built on the posterior-mean mesh
(``artifacts/posterior/mean.stl``, 1,622 vertices, 3,240 faces) with the
reference's kernel and Nyström construction (100 components by default, rank
101, the flagship's width); the target is the MAP mesh
(``artifacts/posterior/map.stl``) in the same frame.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.io.stl import read_stl
from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
from icp_proposal_tpu_torch.models.gpmm import Gpmm

STANDIN_DIR = Path(__file__).resolve().parents[2] / "artifacts" / "posterior"
# the reference's data directory (``Paths.scala``), relative to the working
# directory; ``load_femur_data(data_dir=...)`` names another
FEMUR_DATA_DIR = Path("data") / "femur"


@dataclass
class FemurData:
    model: Gpmm
    target: TriangleMesh
    target_boundary_mask: np.ndarray
    model_boundary_mask: np.ndarray
    model_landmarks: Dict[str, np.ndarray] = field(default_factory=dict)
    target_landmarks: Dict[str, np.ndarray] = field(default_factory=dict)


def load_femur_data(model_components: int = 50, data_dir: str | None = None,
                    device=DEFAULT_DEVICE) -> FemurData:
    """The real femur workload from ``data_dir`` (default ``FEMUR_DATA_DIR``):
    the statismo GPMM ``femur_gp_model_{model_components}-components.h5`` on
    ``device`` (the card unless ``device="cpu"``), the landmarks
    ``femur_reference.json`` and ``femur_target.json`` and the target
    ``femur_target.stl``, rigidly aligned to the model frame by the common
    landmarks, rotating about the origin (reference
    ``LoadTestData.scala:32-50``).  Raises when a file is missing; it never
    substitutes the stand-in."""
    from icp_proposal_tpu_torch.io.landmarks import common_landmarks, read_landmarks
    from icp_proposal_tpu_torch.io.statismo import read_statismo_gpmm
    from icp_proposal_tpu_torch.ops.rigid import rigid_landmark_alignment

    device = resolve_device(device)
    data_dir = Path(data_dir) if data_dir is not None else FEMUR_DATA_DIR
    files = {name: data_dir / name for name in (
        f"femur_gp_model_{model_components}-components.h5", "femur_reference.json",
        "femur_target.stl", "femur_target.json")}
    missing = [str(p) for p in files.values() if not p.is_file()]
    if missing:
        raise FileNotFoundError(f"femur assets missing: {missing}")
    model_path, model_lm_path, target_path, target_lm_path = files.values()
    model = read_statismo_gpmm(model_path, device=device)
    model_lms = read_landmarks(model_lm_path)
    points, cells = read_stl(target_path)
    target_lms = read_landmarks(target_lm_path)

    src, dst, _ = common_landmarks(target_lms, model_lms)
    transform = rigid_landmark_alignment(src, dst, center=np.zeros(3))
    aligned_points = np.asarray(transform.apply(points.astype(np.float32)))
    aligned_lms = {n: np.asarray(transform.apply(target_lms[n][None, :]))[0]
                   for n in target_lms}
    return FemurData(
        model=model,
        target=make_mesh(aligned_points, cells),
        target_boundary_mask=boundary_vertex_mask(cells, len(points)),
        model_boundary_mask=boundary_vertex_mask(model.cells.cpu().numpy(),
                                                 model.num_points),
        model_landmarks=model_lms,
        target_landmarks=aligned_lms,
    )


def load_standin_femur_data(device=DEFAULT_DEVICE, model_components: int = 100) -> FemurData:
    """The stand-in femur workload (see module docstring): a GPMM of
    ``model_components`` components (rank ``model_components`` + 1; the
    reference's files hold 50, 100 and 200) on ``device`` (the card unless
    ``device="cpu"``)."""
    from icp_proposal_tpu_torch.models.build_femur import build_femur_gpmm

    device = resolve_device(device)  # before the host build, not after

    mpoints, mcells = read_stl(STANDIN_DIR / "mean.stl")
    tpoints, tcells = read_stl(STANDIN_DIR / "map.stl")
    model = build_femur_gpmm(mpoints, mcells, model_components, device=device)
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


def run_icp_proposal_registration(num_samples: int = 10000, model_components: int = 50,
                                  n_chains: int = 1, json_path=None, seed: int = 1024, verbose: bool = True,
                                  resume_log=None, resume_mode: str = "best",
                                  setup: str | None = None, coarse: str = "exact",
                                  data: FemurData | None = None,
                                  accept_info_interval: int = 1000,
                                  device=DEFAULT_DEVICE):
    """End-to-end registration run (reference ``IcpProposalRegistration.main``)
    → (FittingResult, data).

    data: the femur workload; None builds the stand-in of
    ``model_components`` components (``load_standin_femur_data``) on
    ``device`` (the card unless ``device="cpu"``), because the real assets
    are absent.  setup: a
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
        data = load_standin_femur_data(device=device, model_components=model_components)
    _, mixture, evaluator = SETUPS[setup or RECOMMENDED_SETUP](data, coarse=coarse)
    reg = SamplingRegistration(data.model, data.target, mixture, evaluator,
                               accept_info_interval=accept_info_interval, verbose=verbose)
    result = reg.runfitting(num_samples, seed=seed, n_chains=n_chains, json_path=json_path,
                            resume_log=resume_log, resume_mode=resume_mode)
    if verbose:
        evaluate_reconstruction("SAMPLE", transformed_mesh(data.model, result.best_state),
                                data.target)
    return result, data


def run_deterministic_icp(num_iterations: int = 100, model_components: int = 50,
                          n_sample_points: int = None, seed: int = 1024,
                          verbose: bool = True, data: FemurData | None = None,
                          device=DEFAULT_DEVICE):
    """Deterministic non-rigid ICP entry point (reference
    ``IcpRegistration.main``: full-resolution point counts, 100 iterations,
    σ = 1e-15, model_and_target) → (coefficients [r], fitted mesh, data,
    non-finite iterations).

    data: the femur workload; None builds the stand-in GPMM of
    ``model_components`` components (``load_standin_femur_data``) on
    ``device`` (the card unless ``device="cpu"``), because the real assets
    are absent (``load_femur_data`` reads them).  The target points and the
    direction flips come from generators seeded with ``seed``; with
    ``verbose`` the reference's ``ICP-Timing`` line and reconstruction
    distances are printed."""
    import torch

    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.ops.surface_sampling import (
        sample_points_on_surface,
        seeded_vertex_subset,
    )
    from icp_proposal_tpu_torch.registration.comparison import evaluate_reconstruction
    from icp_proposal_tpu_torch.registration.icp_fitting import icp_surface_fitting
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.utils.profiling import wall_timer

    if data is None:
        data = load_standin_femur_data(device=device, model_components=model_components)
    model = data.model
    dev = model.device
    n = n_sample_points or model.num_points
    ctx = build_target_context(data.target, data.target_boundary_mask, device=dev)
    model_ids = seeded_vertex_subset(model.num_points, n, seed)
    target_pts = sample_points_on_surface(
        data.target, n, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    with wall_timer("ICP", verbose, device=dev):
        coeffs, nonfinite = icp_surface_fitting(
            model, ctx, model_ids, target_pts, num_iterations=num_iterations,
            sigma_seq=(1e-15,), projection_direction="model_and_target", key=seed)
    fitted = TriangleMesh(points=instance_points(model, coeffs), cells=model.cells)
    if verbose:
        evaluate_reconstruction("SAMPLE", fitted, data.target)
    return coeffs, fitted, data, nonfinite


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Femur registration entry points.  Without --data-dir they run on "
                    "the stand-in femur GPMM built from in-repo meshes (the real assets "
                    "are not in the repository)")
    p.add_argument("mode", nargs="?", default="proposal", choices=["proposal", "icp"],
                   help="proposal = MH ICP-proposal chains; icp = deterministic ICP")
    p.add_argument("--samples", type=int, default=10000)
    p.add_argument("--iterations", type=int, default=100,
                   help="icp: iterations of the deterministic ICP")
    p.add_argument("--components", type=int, default=None,
                   help="GPMM components (the real files hold 50, 100, 200); default: "
                        "50 for icp, 100 for proposal, the reference's entry points")
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory of the real femur assets (statismo model, landmarks, "
                        "femur_target.stl); without it the stand-in is used")
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
    components = args.components or (50 if args.mode == "icp" else 100)
    data = (load_femur_data(components, args.data_dir, device=args.device)
            if args.data_dir else
            load_standin_femur_data(device=args.device, model_components=components))
    if args.mode == "icp":
        run_deterministic_icp(num_iterations=args.iterations, model_components=components,
                              data=data, device=args.device)
        return
    run_icp_proposal_registration(
        num_samples=args.samples, n_chains=args.chains, json_path=args.json,
        resume_log=args.resume_log, resume_mode=args.resume_mode,
        setup=args.setup, coarse=args.coarse, data=data, device=args.device)


if __name__ == "__main__":
    main()
