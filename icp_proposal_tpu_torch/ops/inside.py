"""Point-in-mesh tests by generalized winding numbers.

Counterpart of ``icp_proposal_tpu/ops/inside.py`` (plain PyTorch; the JAX
package has no kernel here either).  The generalized winding number
(Jacobson et al.) is exact for closed meshes and a smooth inside-ness
measure for open ones; it serves the Dice metrics of ``ops/metrics.py``.
"""
from __future__ import annotations

import math

import torch


def winding_numbers(queries: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """queries [P, 3], triangles [F, 3, 3] → winding numbers [P] (≈ 1
    inside, ≈ 0 outside a closed mesh): the Van Oosterom–Strackee signed
    solid angle of every face, summed and divided by 4π."""
    a = triangles[None, :, 0, :] - queries[:, None, :]  # [P, F, 3]
    b = triangles[None, :, 1, :] - queries[:, None, :]
    c = triangles[None, :, 2, :] - queries[:, None, :]
    la = torch.linalg.vector_norm(a, dim=-1)
    lb = torch.linalg.vector_norm(b, dim=-1)
    lc = torch.linalg.vector_norm(c, dim=-1)
    numer = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
    denom = (la * lb * lc + torch.sum(a * b, dim=-1) * lc
             + torch.sum(b * c, dim=-1) * la + torch.sum(c * a, dim=-1) * lb)
    omega = 2.0 * torch.atan2(numer, denom)  # [P, F]
    return torch.sum(omega, dim=1) / (4.0 * math.pi)


def points_inside(queries: torch.Tensor, triangles: torch.Tensor,
                  threshold: float = 0.5) -> torch.Tensor:
    return winding_numbers(queries, triangles) > threshold
