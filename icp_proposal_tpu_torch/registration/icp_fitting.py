"""Deterministic non-rigid ICP, the paper's comparison method.

Counterpart of ``icp_proposal_tpu/registration/icp_fitting.py`` (reference
``api/other/IcpBasedSurfaceFitting.scala:32-127``).  Per iteration: decode
the instance, find correspondences in the chosen projection direction, take
the isotropic GP regression's mean in coefficient space, under-relax by
``step_length``; anneal σ through ``sigma_seq``.

The inits are a leading batch axis B (the JAX package vmaps instead): the
model direction queries the target through its shortlist index (K3 shared,
then K4; the dense K5 for a context without an index), the target
direction finds each init's nearest model vertices (K3 per chain), and the
regression factors and solves through K1 (r ≤ 104) or K6.  The reference's
unseeded per-iteration direction flip is drawn from a ``torch.Generator``
or passed in.  σ² is floored at 1e-8 so the reference's σ = 1e-15 stays
finite in float32; a non-positive pivot makes that init's update NaN, and
the init keeps its previous coefficients (reference :95-104).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.ops.closest_point_cuda import nearest_vertices
from icp_proposal_tpu_torch.ops.surface_index import closest_auto
from icp_proposal_tpu_torch.sampling.context import TargetContext

DIRECTIONS = ("model", "target", "model_and_target")


def _regression_mean(gpmm, ids, obs_disp, sigma2):
    """α̂ = (max(σ², 1e-8)·I + Σᵢ QᵢᵀQᵢ)⁻¹ Σᵢ Qᵢᵀỹᵢ per init over all rows
    (the reference's mask is all ones here, so no masked copy of Q is made):
    ids [B, m], obs_disp [B, m, 3] → [B, r].  The system is
    ``posterior_factors_isotropic``'s, scaled by σ² so that σ → 0 stays
    finite; it goes through ``chol_solve`` (K1/K6), whose NaN on a
    non-positive pivot is the reference's ``jnp.linalg.cholesky`` NaN."""
    gram, rhs = gp.isotropic_system(gpmm, ids, obs_disp)
    gram.diagonal(dim1=-2, dim2=-1).add_(max(float(sigma2), 1e-8))
    return gp._factor(gram, rhs).alpha_hat


class IcpStep(NamedTuple):
    """One ICP iteration for B inits."""

    coeffs: torch.Tensor  # [B, r] after the update; the previous row where not finite
    finite: torch.Tensor  # [B] bool: the update was finite and taken
    face_idx: Optional[torch.Tensor]  # [B, m] model direction's target faces
    vertex_ids: Optional[torch.Tensor]  # [B, m] target direction's model vertices


def icp_iteration(gpmm, target_ctx: TargetContext, model_ids: torch.Tensor,
                  target_points: torch.Tensor, coeffs: torch.Tensor, sigma2: float,
                  step_length: float = 1.0, projection_direction: str = "model_and_target",
                  flip: Optional[torch.Tensor] = None) -> IcpStep:
    """One iteration from coeffs [B, r]: model_ids [m] int64 and
    target_points [m, 3] on the model's device; under "model_and_target"
    both directions are computed and ``flip`` [B] bool picks the model
    direction where True (reference :63-69)."""
    if projection_direction not in DIRECTIONS:
        raise ValueError(f"projection_direction must be one of {DIRECTIONS}, "
                         f"got {projection_direction!r}")
    bsz = coeffs.shape[0]
    cur = gp.instance_points(gpmm, coeffs)  # [B, V, 3]
    face_idx = vertex_ids = None
    if projection_direction != "target":
        cp, _, face_idx = closest_auto(cur[:, model_ids], target_ctx.points,
                                       target_ctx.cells, target_ctx.index)
        ids_m, obs_m = model_ids.expand(bsz, -1), cp
    if projection_direction != "model":
        tq = target_points.expand(bsz, -1, -1).contiguous()
        vertex_ids = nearest_vertices(tq, cur.contiguous())  # [B, m]
        ids_t, obs_t = vertex_ids.long(), tq
    if projection_direction == "model":
        ids, obs = ids_m, obs_m
    elif projection_direction == "target":
        ids, obs = ids_t, obs_t
    else:
        ids = torch.where(flip[:, None], ids_m, ids_t)
        obs = torch.where(flip[:, None, None], obs_m, obs_t)
    obs_disp = obs - gpmm.ref_points[ids]
    alpha_hat = _regression_mean(gpmm, ids, obs_disp, sigma2)
    new = coeffs + (alpha_hat - coeffs) * step_length
    finite = torch.isfinite(new).all(dim=-1)
    return IcpStep(coeffs=torch.where(finite[:, None], new, coeffs), finite=finite,
                   face_idx=face_idx, vertex_ids=vertex_ids)


def icp_surface_fitting(
    gpmm,
    target_ctx: TargetContext,
    model_ids,  # [m] sampled model vertex ids
    target_points,  # [m, 3] sampled target surface points
    num_iterations: int = 100,
    sigma_seq=(1e-15,),
    step_length: float = 1.0,
    projection_direction: str = "model_and_target",
    initial_coeffs=None,
    key=None,
    flips=None,
):
    """→ (coefficients, non-finite iterations): the fit of every init after
    ``num_iterations`` iterations per σ stage (femur entry point
    ``IcpRegistration.scala:28-75``: 100 iterations, σ = 1e-15,
    model_and_target).

    initial_coeffs: [B, r] (B inits), [r] (one) or None (zeros [r]); the
    coefficients come back in the same shape, the count of iterations whose
    update was not finite (and not taken) as int64 [B] or [].  The direction
    flips come from ``flips`` [stages, iterations, B] bool if given, else
    from a generator on the model's device seeded with ``key`` (default
    1024, the reference's ``PRNGKey(1024)``)."""
    dev = gpmm.device
    r = gpmm.rank

    def tensor(x, dtype):  # numpy arrays copied: those from JAX are read-only
        x = np.array(x) if isinstance(x, np.ndarray) else x
        return torch.as_tensor(x, dtype=dtype, device=dev)

    if initial_coeffs is None:
        initial_coeffs = torch.zeros(r, device=dev)
    coeffs = tensor(initial_coeffs, torch.float32)
    single = coeffs.dim() == 1
    coeffs = coeffs.reshape(-1, r)
    bsz = coeffs.shape[0]
    model_ids = tensor(model_ids, torch.int64)
    target_points = tensor(target_points, torch.float32)
    generator = torch.Generator(device=dev).manual_seed(1024 if key is None else key)
    nonfinite = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for stage, sigma in enumerate(sigma_seq):
        sigma2 = float(torch.tensor(float(sigma) ** 2, dtype=torch.float32))
        stage_flips = None
        if projection_direction == "model_and_target":
            stage_flips = (tensor(flips[stage], torch.bool)
                           if flips is not None else
                           torch.rand((num_iterations, bsz), generator=generator,
                                      device=dev) < 0.5)
        for it in range(num_iterations):
            out = icp_iteration(gpmm, target_ctx, model_ids, target_points, coeffs, sigma2,
                                step_length, projection_direction,
                                None if stage_flips is None else stage_flips[it])
            coeffs = out.coeffs
            nonfinite += ~out.finite
    return (coeffs[0], nonfinite[0]) if single else (coeffs, nonfinite)
