"""Carry a model, a target context, workload data and chain state across
from host arrays.

The JAX package keeps its model and context fields as numpy arrays and its
chain state as arrays with a leading chain axis; these functions take such
arrays (never JAX objects) and build the port's tensors on a device (the
card unless ``device="cpu"``), so both packages can start from identical
data.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.mesh import make_mesh
from icp_proposal_tpu_torch.models.gpmm import Gpmm, PosteriorFactors
from icp_proposal_tpu_torch.ops.surface_index import SurfaceIndex, pack_points_aug
from icp_proposal_tpu_torch.sampling.context import TargetContext
from icp_proposal_tpu_torch.sampling.mh import MhCarry
from icp_proposal_tpu_torch.sampling.state import FitState


def _f32(x, device):
    # np.array copies: arrays that come from JAX are read-only buffers
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _i64(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def gpmm_from_arrays(ref_points, cells, mean_disp, basis, variance, noise_variance,
                     sbasis, coeff_chol, device=DEFAULT_DEVICE) -> Gpmm:
    """A ``Gpmm`` whose ``sbasis`` and ``coeff_chol`` are taken as given."""
    device = resolve_device(device)
    return Gpmm(
        ref_points=_f32(ref_points, device),
        cells=_i64(cells, device),
        mean_disp=_f32(mean_disp, device),
        basis=_f32(basis, device),
        variance=_f32(variance, device),
        noise_variance=_f32(noise_variance, device),
        sbasis=_f32(sbasis, device),
        coeff_chol=_f32(coeff_chol, device),
    )


def context_from_arrays(points, cells, tri, boundary, cand=None,
                        coarse: str = "exact", device=DEFAULT_DEVICE) -> TargetContext:
    """A ``TargetContext``; with ``cand`` it carries the shortlist index over
    the same points and triangles, whose coarse pass is ``coarse`` ("exact":
    K3, "dot": K8)."""
    device = resolve_device(device)
    points_t = _f32(points, device)
    tri_t = _f32(tri, device)
    index = None
    if cand is not None:
        index = SurfaceIndex(
            points=points_t, tri=tri_t,
            cand=torch.as_tensor(np.asarray(cand, np.int32), device=device),
            points_aug=pack_points_aug(points_t), coarse=coarse,
        )
    return TargetContext(
        points=points_t,
        cells=_i64(cells, device),
        tri=tri_t,
        boundary=torch.as_tensor(np.asarray(boundary, bool), device=device),
        index=index,
    )


def bfm_data_from_arrays(model: dict, target_points, target_cells, partial_points,
                         partial_cells, model_boundary_mask, target_boundary_mask,
                         partial_boundary_mask, device=DEFAULT_DEVICE):
    """An ``apps.bfm.BfmData``: ``model`` maps the ``Gpmm`` field names to
    arrays (``gpmm_from_arrays``); meshes and masks stay host arrays."""
    from icp_proposal_tpu_torch.apps.bfm import BfmData

    return BfmData(
        model=gpmm_from_arrays(**model, device=device),
        target=make_mesh(target_points, target_cells),
        target_partial=make_mesh(partial_points, partial_cells),
        model_boundary_mask=np.asarray(model_boundary_mask, bool),
        target_boundary_mask=np.asarray(target_boundary_mask, bool),
        partial_boundary_mask=np.asarray(partial_boundary_mask, bool),
    )


def femur_data_from_arrays(model: dict, target_points, target_cells, target_boundary_mask,
                           model_boundary_mask, model_landmarks=None, target_landmarks=None,
                           device=DEFAULT_DEVICE):
    """An ``apps.femur.FemurData``: ``model`` maps the ``Gpmm`` field names
    to arrays (``gpmm_from_arrays``); the target mesh, masks and landmarks
    stay host arrays."""
    from icp_proposal_tpu_torch.apps.femur import FemurData

    return FemurData(
        model=gpmm_from_arrays(**model, device=device),
        target=make_mesh(target_points, target_cells),
        target_boundary_mask=np.asarray(target_boundary_mask, bool),
        model_boundary_mask=np.asarray(model_boundary_mask, bool),
        model_landmarks={k: np.asarray(v) for k, v in (model_landmarks or {}).items()},
        target_landmarks={k: np.asarray(v) for k, v in (target_landmarks or {}).items()},
    )


def state_from_arrays(scale, rot, trans, center, coeffs,
                      device=DEFAULT_DEVICE) -> FitState:
    """A batched ``FitState`` from arrays with a leading chain axis."""
    device = resolve_device(device)
    return FitState(scale=_f32(scale, device), rot=_f32(rot, device),
                    trans=_f32(trans, device), center=_f32(center, device),
                    coeffs=_f32(coeffs, device))


def carry_from_arrays(state: FitState, log_post, named,
                      icp_factors: Sequence = (), adapt_log_scales=None, step_idx=None,
                      device=DEFAULT_DEVICE) -> MhCarry:
    """An ``MhCarry``; ``icp_factors`` holds one anchor per anchored
    component, in component order: an ICP component's (alpha_hat [B, r],
    chol_m [B, r, r], logdet_m [B]) triple, or a MALA component's gradient
    [B, r].  ``adapt_log_scales`` [B, C] and ``step_idx`` [B]: the scale
    adaptation's state (None without adaptation)."""
    device = resolve_device(device)

    def anchor(f):
        if isinstance(f, (tuple, list)):
            return PosteriorFactors(*(_f32(a, device).contiguous() for a in f))
        return _f32(f, device)

    return MhCarry(
        state=state,
        log_post=_f32(log_post, device),
        named=_f32(named, device),
        icp_factors=tuple(anchor(f) for f in icp_factors),
        adapt_log_scales=None if adapt_log_scales is None else _f32(adapt_log_scales,
                                                                   device),
        step_idx=None if step_idx is None else _f32(step_idx, device),
    )
