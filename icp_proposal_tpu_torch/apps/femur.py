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


def make_icp_proposal_setup(data: FemurData):
    """The flagship MH configuration (exact densities): 0.9·ICP mixture
    (model + target directions) + 0.1·random shape; Euclidean model→target
    evaluator, σ = 2; evaluator points = 4·rank, ICP points = 2·rank.  The
    ICP model ids are a stride-2 slice of the evaluator's, so one
    closest-point pass serves both (``mh._fusion_plan``).  The reference's
    parity mode is not ported yet (ROADMAP queue 1, slice 7)."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu_torch.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask,
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
        icp_model_ids=evaluator.model_ids("distance")[::2],
    )
    return ctx, mixture, evaluator
