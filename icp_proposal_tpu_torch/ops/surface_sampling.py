"""Random surface sampling and seeded vertex subsets.

Counterpart of ``icp_proposal_tpu/ops/surface_sampling.py``.
``sample_points_on_surface`` is scalismo's ``UniformMeshSampler3D``
(area-weighted; reference ``IcpBasedSurfaceFitting.scala:51-53``) on a
device, its draws taken from a ``torch.Generator`` (or passed in, so that
the JAX package's draws can be replayed).  ``seeded_vertex_subset`` and
``area_weighted_vertex_subset`` are host numpy copies: the same
``RandomState`` draws give the same ids, so both packages observe the same
vertices.
"""
from __future__ import annotations

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.mesh import TriangleMesh, face_areas


def _mesh_on(mesh: TriangleMesh, device):
    points = torch.as_tensor(mesh.points, dtype=torch.float32, device=device)
    cells = torch.as_tensor(mesh.cells, dtype=torch.int64, device=device)
    return points, cells


def surface_draws(mesh: TriangleMesh, n: int, generator: torch.Generator | None = None,
                  device=DEFAULT_DEVICE):
    """The random draws of ``sample_points_on_surface``: (face_idx [n]
    int64, drawn with probability proportional to each face's area,
    max(area, 1e-20) as the reference's logits floor it; r [n, 2] uniform
    in [0, 1)), on ``device`` from ``generator``."""
    device = resolve_device(device)
    points, cells = _mesh_on(mesh, device)
    weights = torch.clamp_min(face_areas(points, cells), 1e-20)
    face_idx = torch.multinomial(weights, n, replacement=True, generator=generator)
    r = torch.rand((n, 2), generator=generator, device=device)
    return face_idx, r


def sample_points_on_surface(mesh: TriangleMesh, n: int,
                             generator: torch.Generator | None = None, draws=None,
                             device=DEFAULT_DEVICE) -> torch.Tensor:
    """n area-weighted uniform random points [n, 3] on the mesh's surface,
    on ``device`` (the card unless ``device="cpu"``): a face drawn by area,
    then u = 1 − √r₁, v = r₂·√r₁, w = 1 − u − v over its corners (a, b, c).
    ``draws`` = (face_idx [n], r [n, 2]) replaces the random draws
    (``surface_draws`` from ``generator`` otherwise)."""
    device = resolve_device(device)
    if draws is None:
        draws = surface_draws(mesh, n, generator, device)
    face_idx, r = (torch.as_tensor(np.array(d) if isinstance(d, np.ndarray) else d,
                                   device=device) for d in draws)
    points, cells = _mesh_on(mesh, device)
    tri = points[cells[face_idx.long()]]  # [n, 3, 3]
    r = r.to(torch.float32)
    sqrt_r1 = torch.sqrt(r[:, 0])
    u = 1.0 - sqrt_r1
    v = r[:, 1] * sqrt_r1
    w = 1.0 - u - v
    return u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1] + w[:, None] * tri[:, 2]


def seeded_vertex_subset(num_points: int, n: int, seed: int = 1024) -> np.ndarray:
    """Deterministic sorted subset of n vertex ids."""
    n = min(n, num_points)
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_points, size=n, replace=False)).astype(np.int32)


def area_weighted_vertex_subset(
    mesh_points: np.ndarray, cells: np.ndarray, n: int, seed: int = 1024
) -> np.ndarray:
    """Vertex subset weighted by one-ring area (uniform surface coverage)."""
    pts = np.asarray(mesh_points, dtype=np.float64)
    c = np.asarray(cells)
    tri = pts[c]
    fa = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1
    )
    w = np.zeros(len(pts))
    for k in range(3):
        np.add.at(w, c[:, k], fa / 3.0)
    w = w / w.sum()
    n = min(n, len(pts))
    rng = np.random.RandomState(seed)
    ids = rng.choice(len(pts), size=n, replace=False, p=w)
    return np.sort(ids).astype(np.int32)
