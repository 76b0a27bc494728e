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
    check_coarse,
)


@dataclass(frozen=True)
class TargetContext:
    """Everything the samplers need to know about the static target mesh."""

    points: torch.Tensor  # [Vt, 3]
    cells: torch.Tensor  # [Ft, 3] int64
    tri: torch.Tensor  # [Ft, 3, 3]
    boundary: torch.Tensor  # [Vt] bool
    index: SurfaceIndex | None = None  # shortlist index; None → dense K5


def build_target_context(target: TriangleMesh, boundary_mask=None,
                         morton_faces: bool = True, index_k: int = INDEX_K,
                         build_index: bool = True, coarse: str = "exact",
                         device=DEFAULT_DEVICE) -> TargetContext:
    """The target mesh on ``device`` (the card unless ``device="cpu"``).

    morton_faces: sort the faces in Morton order, as the reference does.
    build_index: build the K = ``index_k`` face shortlist index (the fast
    path on the card; the reference builds it by default on a TPU); without
    it every closest-point query takes the dense kernel K5.  coarse: the
    index's coarse pass, "exact" (K3) or "dot" (K8).  Closest-point dispatch
    depends only on what is decided here."""
    check_coarse(coarse)
    device = resolve_device(device)
    points = np.array(target.points, np.float32)  # a writable copy
    cells = np.asarray(target.cells)
    if boundary_mask is None:
        boundary_mask = boundary_vertex_mask(cells, len(points))
    if morton_faces:
        cells = cells[morton_sort_faces(points, cells)]
    cells = np.asarray(cells, np.int32)
    index = (build_surface_index(points, cells, k=index_k, coarse=coarse, device=device)
             if build_index else None)
    return TargetContext(
        points=torch.as_tensor(points, device=device),
        cells=torch.as_tensor(cells, dtype=torch.int64, device=device),
        tri=torch.as_tensor(points[cells], device=device),
        boundary=torch.as_tensor(np.asarray(boundary_mask, bool), device=device),
        index=index,
    )
