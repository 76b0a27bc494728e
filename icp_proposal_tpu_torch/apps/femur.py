"""Femur workload: data and the flagship MH configuration.

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
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu_torch.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask, coarse=coarse,
                               device=model.device)
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=2.0, n_points=4 * model.rank)
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


def make_random_walk_setup(data: FemurData, shape_steps=(0.1,), sigma_eval: float = 2.0,
                           adapt: bool = False, coarse: str = "exact"):
    """Random-walk-only configuration (the comparison chain of the
    reference's ``RunMHRandomInitComparison.scala``): random-shape walks
    with one component per step size in ``shape_steps``, Euclidean
    model→target evaluator of σ = ``sigma_eval`` over 4·rank points.
    ``adapt=True`` (scale adaptation, "rw-adapt") comes with slice 7 and
    raises until then."""
    if adapt:
        raise NotImplementedError(
            "make_random_walk_setup(adapt=True) needs scale adaptation, which is not "
            "ported yet (ROADMAP queue 1, slice 7)")
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu_torch.sampling.proposals import (
        MixtureProgram,
        mixed_random_shape_proposal,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask, coarse=coarse,
                               device=model.device)
    mixture = MixtureProgram(mixed_random_shape_proposal(shape_steps), model, ctx,
                             data.model_boundary_mask)
    evaluator = proximity_and_independent(
        model, ctx, mode="model_to_target", sigma=sigma_eval, n_points=4 * model.rank)
    return ctx, mixture, evaluator


def _slice_7(name):
    def setup(data, coarse="exact"):
        raise NotImplementedError(
            f"setup {name!r} needs MALA and scale adaptation, which are not "
            "ported yet (ROADMAP queue 1, slice 7)")
    return setup


# The named setups (CLI --setup values).  "parity" is the reference recipe
# with the reference's own transition density; every other row is exact MH.
SETUPS = {
    "flagship": make_icp_proposal_setup,
    "parity": lambda data, coarse="exact": make_icp_proposal_setup(
        data, parity=True, coarse=coarse),
    "rw": make_random_walk_setup,
    "rw-adapt": lambda data, coarse="exact": make_random_walk_setup(
        data, adapt=True, coarse=coarse),
    "hybrid": _slice_7("hybrid"),
    "mala": _slice_7("mala"),
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
                        "reference recipe + reference density; rw = random walk. "
                        f"Default: {RECOMMENDED_SETUP!r}")
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
