"""The MH chain state, batched over chains, and its geometric transforms.

Counterpart of ``icp_proposal_tpu/sampling/state.py`` with chains as an
explicit leading dimension B.  Conventions (scalismo):

    pose(p)   = R(p − c) + c + t,   R = Rz(φ) · Ry(θ) · Rx(ψ)
    full(p)   = s · pose(p + u(p))
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icp_proposal_tpu_torch.mesh import TriangleMesh
from icp_proposal_tpu_torch.models.gpmm import Gpmm, instance_points


class FitState(NamedTuple):
    scale: torch.Tensor  # [B]
    rot: torch.Tensor  # [B, 3] Euler angles (φ, θ, ψ)
    trans: torch.Tensor  # [B, 3]
    center: torch.Tensor  # [B, 3] rotation center (fixed during sampling)
    coeffs: torch.Tensor  # [B, r] shape coefficients


def init_state(gpmm: Gpmm, n_chains: int, coeffs=None, center=None) -> FitState:
    """Zero pose for ``n_chains`` chains on the model's device; rotation
    center ``center`` [3] (default: the reference-mesh centroid, computed on
    the host as the reference does) and coefficients ``coeffs`` [r]
    (default zero), the same for every chain."""
    dev = gpmm.device
    if center is None:
        center = gpmm.ref_points.cpu().numpy().mean(axis=0)
    if coeffs is None:
        coeffs = np.zeros(gpmm.rank, np.float32)
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    return FitState(
        scale=torch.ones(n_chains, device=dev),
        rot=torch.zeros(n_chains, 3, device=dev),
        trans=torch.zeros(n_chains, 3, device=dev),
        center=center.expand(n_chains, 3).clone(),
        coeffs=coeffs.expand(n_chains, gpmm.rank).clone(),
    )


def euler_matrix(rot: torch.Tensor) -> torch.Tensor:
    """rot [..., 3] → R = Rz(φ) @ Ry(θ) @ Rx(ψ), [..., 3, 3]."""
    phi, theta, psi = rot.unbind(-1)
    cz, sz = torch.cos(phi), torch.sin(phi)
    cy, sy = torch.cos(theta), torch.sin(theta)
    cx, sx = torch.cos(psi), torch.sin(psi)
    zero, one = torch.zeros_like(phi), torch.ones_like(phi)

    def mat(*rows):
        return torch.stack(rows, dim=-1).reshape(rot.shape[:-1] + (3, 3))

    rz = mat(cz, -sz, zero, sz, cz, zero, zero, zero, one)
    ry = mat(cy, zero, sy, zero, one, zero, -sy, zero, cy)
    rx = mat(one, zero, zero, zero, cx, -sx, zero, sx, cx)
    return rz @ ry @ rx


def pose_apply(state: FitState, points: torch.Tensor) -> torch.Tensor:
    """points [B, N, 3] → R(p − c) + c + t."""
    r = euler_matrix(state.rot)
    c = state.center[:, None, :]
    return (points - c) @ r.transpose(-1, -2) + c + state.trans[:, None, :]


def pose_inverse_apply(state: FitState, points: torch.Tensor) -> torch.Tensor:
    """Inverse of the scale∘pose part: world points [B, N, 3] → model frame."""
    r = euler_matrix(state.rot)
    c = state.center[:, None, :]
    return (points / state.scale[:, None, None] - c
            - state.trans[:, None, :]) @ r + c


def transformed_points(gpmm: Gpmm, state: FitState) -> torch.Tensor:
    """scale ∘ pose ∘ shape applied to the reference mesh → [B, V, 3]."""
    shaped = instance_points(gpmm, state.coeffs)
    return state.scale[:, None, None] * pose_apply(state, shaped)


def transformed_mesh(gpmm: Gpmm, state: FitState, chain: int = 0) -> TriangleMesh:
    """Chain ``chain``'s current mesh: points [V, 3] and the model's cells,
    as tensors on the model's device."""
    one = FitState(*(x[chain:chain + 1] for x in state))
    return TriangleMesh(points=transformed_points(gpmm, one)[0], cells=gpmm.cells)


def flat_parameters(state: FitState) -> torch.Tensor:
    """[B, 1+9+r] in the reference's ``allParameters`` order: scale,
    translation, rotation, center, shape."""
    return torch.cat([state.scale[:, None], state.trans, state.rot, state.center,
                      state.coeffs], dim=-1)
