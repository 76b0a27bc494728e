"""The static target context shared by proposals and evaluators."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask
from icp_proposal_tpu_torch.ops.morton import morton_sort_faces
from icp_proposal_tpu_torch.ops.surface_index import (
    INDEX_K,
    SurfaceIndex,
    build_surface_index,
)


@dataclass(frozen=True)
class TargetContext:
    """Everything the samplers need to know about the static target mesh."""

    points: torch.Tensor  # [Vt, 3]
    cells: torch.Tensor  # [Ft, 3] int64
    tri: torch.Tensor  # [Ft, 3, 3]
    boundary: torch.Tensor  # [Vt] bool
    index: SurfaceIndex | None = None  # shortlist index; None needs K5


def build_target_context(target: TriangleMesh, boundary_mask=None,
                         device=DEFAULT_DEVICE) -> TargetContext:
    """Morton-sort the faces (as the reference does) and build the K = 64
    face shortlist index, always: it is how the card answers closest-point
    queries until the dense kernel K5 is ported."""
    device = resolve_device(device)
    points = np.array(target.points, np.float32)  # a writable copy
    cells = np.asarray(target.cells)
    if boundary_mask is None:
        boundary_mask = boundary_vertex_mask(cells, len(points))
    cells = np.asarray(cells[morton_sort_faces(points, cells)], np.int32)
    return TargetContext(
        points=torch.as_tensor(points, device=device),
        cells=torch.as_tensor(cells, dtype=torch.int64, device=device),
        tri=torch.as_tensor(points[cells], device=device),
        boundary=torch.as_tensor(np.asarray(boundary_mask, bool), device=device),
        index=build_surface_index(points, cells, k=INDEX_K, device=device),
    )
