"""Posterior-variability maps over mesh vertices from thinned chain samples.

Counterpart of ``icp_proposal_tpu/analysis/posterior_variability.py``
(reference ``apps/util/PosteriorVariability.scala:30-73``):

* total map: the trace of each vertex's 3×3 sample covariance;
* normal map: the variance of the displacement projected on the vertex
  normal of the mean mesh (or of a reference mesh).

Inputs are the decoded meshes of the thinned accepted samples, stacked on
the leading axis ([S, V, 3] on any device); outputs are per-vertex fields
[V] on the same device, for colour-mapped export (``io/scalar_field.py``).
Both are population statistics (divisor S), as ``jnp.var`` computes them.
"""
from __future__ import annotations

import torch

from icp_proposal_tpu_torch.mesh import vertex_normals


def variability_map_total(sample_points: torch.Tensor) -> torch.Tensor:
    """sample_points [S, V, 3] → [V] trace of the per-vertex sample
    covariance (reference ``computeDistanceMapFromMeshesTotal``, :30-50)."""
    centered = sample_points - sample_points.mean(dim=0, keepdim=True)
    # trace of the covariance = mean squared deviation summed over xyz
    return (centered * centered).sum(dim=-1).mean(dim=0)


def variability_map_normal(sample_points: torch.Tensor, cells, use_mean_normals: bool = True,
                           reference_points=None) -> torch.Tensor:
    """sample_points [S, V, 3] → [V] population variance of the displacement
    along the vertex normal (reference ``computeDistanceMapFromMeshesNormal``,
    :52-73); normals from the mean mesh (default) or ``reference_points``
    [V, 3]."""
    mean_pts = sample_points.mean(dim=0)
    normal_src = mean_pts if use_mean_normals else torch.as_tensor(
        reference_points, dtype=sample_points.dtype, device=sample_points.device)
    cells = torch.as_tensor(cells, dtype=torch.int64, device=sample_points.device)
    normals = vertex_normals(normal_src, cells)  # [V, 3]
    proj = ((sample_points - mean_pts) * normals).sum(dim=-1)  # [S, V]
    return proj.var(dim=0, correction=0)
