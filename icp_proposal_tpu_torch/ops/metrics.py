"""Mesh comparison metrics.

Counterpart of ``icp_proposal_tpu/ops/metrics.py`` (scalismo's
``MeshMetrics``; reference ``RegistrationComparison.scala:24-48``).  The
distances are reductions over the dense closest-point kernel K5; the Dice
overlaps count winding-number inside tests (``ops/inside.py``).

A mesh is a ``TriangleMesh`` of host arrays or of tensors.  The metrics run
where the meshes' tensors lie; meshes of host arrays alone go to the card
unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import torch

from icp_proposal_tpu_torch.device import resolve_device
from icp_proposal_tpu_torch.mesh import TriangleMesh
from icp_proposal_tpu_torch.ops.closest_point import (
    closest_points_on_surface,
    nearest_vertex_of_faces,
    surface_distances_auto,
)
from icp_proposal_tpu_torch.ops.inside import points_inside, winding_numbers


def _device_of(*points, device=None) -> torch.device:
    """``device`` if given, else that of the first tensor among ``points``,
    else the card."""
    if device is not None:
        return resolve_device(device)
    for p in points:
        if isinstance(p, torch.Tensor):
            return p.device
    return resolve_device()


def _on(mesh: TriangleMesh, device) -> tuple:
    """(points [V, 3] float32, cells [F, 3] int32), contiguous, on ``device``."""
    return (torch.as_tensor(mesh.points, dtype=torch.float32, device=device).contiguous(),
            torch.as_tensor(mesh.cells, dtype=torch.int32, device=device).contiguous())


def directed_distances(points, target: TriangleMesh, device=None) -> torch.Tensor:
    """Point→surface distances [P] from points [P, 3] to the target mesh."""
    dev = _device_of(points, target.points, device=device)
    q = torch.as_tensor(points, dtype=torch.float32, device=dev).contiguous()
    d2, _ = surface_distances_auto(q[None], *_on(target, dev))
    return torch.sqrt(d2[0])


def avg_distance(mesh_a: TriangleMesh, mesh_b: TriangleMesh, device=None) -> torch.Tensor:
    """Mean distance from mesh_a's vertices to mesh_b's surface (one
    direction, scalismo ``MeshMetrics.avgDistance``)."""
    dev = _device_of(mesh_a.points, mesh_b.points, device=device)
    return torch.mean(directed_distances(_on(mesh_a, dev)[0], mesh_b, dev))


def hausdorff_distance(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                       device=None) -> torch.Tensor:
    """The larger of the two directed max point→surface distances (scalismo
    ``MeshMetrics.hausdorffDistance``)."""
    dev = _device_of(mesh_a.points, mesh_b.points, device=device)
    d_ab = torch.amax(directed_distances(_on(mesh_a, dev)[0], mesh_b, dev))
    d_ba = torch.amax(directed_distances(_on(mesh_b, dev)[0], mesh_a, dev))
    return torch.maximum(d_ab, d_ba)


def _bounds(pa: torch.Tensor, pb: torch.Tensor):
    lo = torch.minimum(torch.amin(pa, dim=0), torch.amin(pb, dim=0))
    hi = torch.maximum(torch.amax(pa, dim=0), torch.amax(pb, dim=0))
    return lo, hi


def dice_coefficient(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                     generator: torch.Generator | None = None, n_samples: int = 20000,
                     device=None) -> torch.Tensor:
    """Volumetric Dice overlap 2·|A∩B| / (|A| + |B|), a Monte-Carlo estimate
    from ``n_samples`` uniform points of the joint bounding box drawn from
    ``generator`` (a fresh one seeded 0 by default) and winding-number
    inside tests (scalismo voxelizes instead; the same quantity up to
    discretization)."""
    dev = _device_of(mesh_a.points, mesh_b.points, device=device)
    (pa, ca), (pb, cb) = _on(mesh_a, dev), _on(mesh_b, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    lo, hi = _bounds(pa, pb)
    pts = lo + (hi - lo) * torch.rand((n_samples, 3), generator=generator, device=dev)
    in_a = points_inside(pts, pa[ca.long()])
    in_b = points_inside(pts, pb[cb.long()])
    total = torch.sum(in_a) + torch.sum(in_b)
    return 2.0 * torch.sum(in_a & in_b) / torch.clamp_min(total, 1)


def dice_coefficient_voxel(mesh_a: TriangleMesh, mesh_b: TriangleMesh, grid_n: int = 48,
                           chunk: int = 8192, device=None) -> torch.Tensor:
    """Volumetric Dice on a regular grid of grid_n³ voxel centers over the
    joint bounding box, the scalismo convention (it rasterizes both meshes);
    inside tests by winding numbers, ``chunk`` points at a time."""
    dev = _device_of(mesh_a.points, mesh_b.points, device=device)
    (pa, ca), (pb, cb) = _on(mesh_a, dev), _on(mesh_b, dev)
    lo, hi = _bounds(pa, pb)
    steps = torch.arange(grid_n, dtype=torch.float32, device=dev) + 0.5
    axes = [lo[i] + (hi[i] - lo[i]) * steps / grid_n for i in range(3)]
    pts = torch.stack([g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")], -1)
    tri_a, tri_b = pa[ca.long()], pb[cb.long()]
    inter = total = 0
    for c0 in range(0, pts.shape[0], chunk):
        ina = winding_numbers(pts[c0:c0 + chunk], tri_a) > 0.5
        inb = winding_numbers(pts[c0:c0 + chunk], tri_b) > 0.5
        inter = inter + torch.sum(ina & inb)
        total = total + torch.sum(ina) + torch.sum(inb)
    return 2.0 * inter / torch.clamp_min(torch.as_tensor(total, device=dev), 1)


def avg_and_max_distance_boundary_aware(mesh_a: TriangleMesh, mesh_b: TriangleMesh,
                                        boundary_mask_b, device=None):
    """(avg, max) distance from mesh_a's vertices to mesh_b's surface over
    the correspondences whose nearest mesh_b vertex is not on its boundary
    (reference ``RegistrationComparison.scala:31-48``): excluded entries
    weigh 0 in the mean and −∞ in the max."""
    dev = _device_of(mesh_a.points, mesh_b.points, device=device)
    (pa, _), (pb, cb) = _on(mesh_a, dev), _on(mesh_b, dev)
    cp, d2, fidx = closest_points_on_surface(pa[None], pb, cb)
    near = nearest_vertex_of_faces(cb, fidx, cp, pb)[0]
    keep = ~torch.as_tensor(boundary_mask_b, dtype=torch.bool, device=dev)[near.long()]
    d = torch.sqrt(d2[0])
    avg = torch.sum(torch.where(keep, d, 0.0)) / torch.clamp_min(torch.sum(keep), 1)
    mx = torch.amax(torch.where(keep, d, -torch.inf))
    return avg, mx
