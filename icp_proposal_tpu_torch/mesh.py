"""Triangle meshes: host topology tables (numpy) and batched normals (torch).

Counterpart of ``icp_proposal_tpu/mesh.py``.  Topology is static, so the
boundary mask and the vertex→face adjacency are computed once on the host;
normals are computed on the device, batched over a leading chain dimension.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TriangleMesh(NamedTuple):
    """A mesh: points [V, 3] float32 and cells [F, 3] integer, as host numpy
    arrays (``make_mesh``) or as tensors on a device
    (``sampling.state.transformed_mesh``)."""

    points: np.ndarray
    cells: np.ndarray

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def with_points(self, points) -> "TriangleMesh":
        return TriangleMesh(points=points, cells=self.cells)

    def triangles(self):
        """[F, 3, 3] triangle corner positions."""
        cells = self.cells.long() if isinstance(self.cells, torch.Tensor) else self.cells
        return self.points[cells]


def make_mesh(points, cells) -> TriangleMesh:
    return TriangleMesh(points=np.asarray(points, np.float32),
                        cells=np.asarray(cells, np.int32))


def boundary_vertex_mask(cells: np.ndarray, num_points: int) -> np.ndarray:
    """Boolean [V] mask of vertices on an edge that belongs to one triangle."""
    cells = np.asarray(cells)
    edges = np.concatenate(
        [cells[:, [0, 1]], cells[:, [1, 2]], cells[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    _, inverse, counts = np.unique(
        edges, axis=0, return_inverse=True, return_counts=True
    )
    boundary_edges = edges[counts[inverse.reshape(-1)] == 1]
    mask = np.zeros(num_points, dtype=bool)
    mask[boundary_edges.ravel()] = True
    return mask


def vertex_adjacency_counts(cells: np.ndarray, num_points: int) -> np.ndarray:
    """Number of faces at each vertex, [V] int32."""
    counts = np.zeros(num_points, dtype=np.int32)
    np.add.at(counts, np.asarray(cells).ravel(), 1)
    return counts


def vertex_face_adjacency(cells, num_points: int) -> np.ndarray:
    """Padded vertex→face adjacency [V, D] int32 (D = max vertex degree);
    padding index = F, a virtual zero-normal face."""
    cells_np = np.asarray(cells)
    f = len(cells_np)
    lists = [[] for _ in range(num_points)]
    for fi, tri in enumerate(cells_np):
        for vid in tri:
            lists[vid].append(fi)
    d = max((len(l) for l in lists), default=1)
    adj = np.full((num_points, d), f, dtype=np.int32)
    for vid, l in enumerate(lists):
        adj[vid, : len(l)] = l
    return adj


def _face_cross(points: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """(b − a) × (c − a) per face: points [..., V, 3] → [..., F, 3]."""
    tri = points[..., cells, :]  # [..., F, 3, 3]
    return torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                              tri[..., 2, :] - tri[..., 0, :], dim=-1)


def face_normals(points: torch.Tensor, cells: torch.Tensor,
                 normalize: bool = True) -> torch.Tensor:
    """points [..., V, 3], cells [F, 3] → [..., F, 3] face normals, unit if
    ``normalize`` (else the edge cross products, twice the areas long)."""
    n = _face_cross(points, cells)
    if not normalize:
        return n
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                           min=1e-20)


def face_areas(points: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """points [..., V, 3], cells [F, 3] → [..., F] triangle areas."""
    return 0.5 * torch.linalg.vector_norm(_face_cross(points, cells), dim=-1)


def vertex_normals(points: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """Unit vertex normals [..., V, 3], the normalized sum of the adjacent
    unit face normals, accumulated by scatter-add (scalismo's
    ``vertexNormals``); ``vertex_normals_gather`` is the hot loop's form."""
    fn = face_normals(points, cells)  # [..., F, 3]
    acc = torch.zeros_like(points)
    for k in range(3):
        acc.index_add_(acc.dim() - 2, cells[:, k], fn)
    return acc / torch.clamp(torch.linalg.vector_norm(acc, dim=-1, keepdim=True),
                             min=1e-20)


def vertex_normals_gather(points: torch.Tensor, cells: torch.Tensor,
                          adjacency: torch.Tensor) -> torch.Tensor:
    """Unit vertex normals [..., V, 3]: the normalized sum of the adjacent
    unit face normals, gathered through a [V, D] adjacency table."""
    fn = face_normals(points, cells)  # [..., F, 3]
    fn_pad = torch.cat([fn, fn.new_zeros(fn.shape[:-2] + (1, 3))], dim=-2)
    acc = fn_pad[..., adjacency, :].sum(dim=-2)  # [..., V, D, 3] → [..., V, 3]
    return acc / torch.clamp(torch.linalg.vector_norm(acc, dim=-1, keepdim=True),
                             min=1e-20)
