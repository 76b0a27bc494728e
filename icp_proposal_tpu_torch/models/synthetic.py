"""Synthetic meshes and models for the stand-in workloads and tests.

Copy of ``icp_proposal_tpu/models/synthetic.py``: the meshes are host
numpy (the synthetic face stand-in is an open icosphere patch, built the
same way in both packages); ``make_synthetic_gpmm`` builds a small GPMM on
any mesh, its tensors on a device.
"""
from __future__ import annotations

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE


def make_icosphere(subdivisions: int = 2, radius: float = 50.0):
    """Icosphere mesh → (points [V,3] f32, cells [F,3] i32)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = verts_list[i] + verts_list[j]
                m = m / np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def make_open_patch(subdivisions: int = 2, radius: float = 50.0, z_cut: float = 0.3):
    """Icosphere with the top cap removed → an open mesh with boundary
    (partial-target stand-in)."""
    points, cells = make_icosphere(subdivisions, radius)
    keep_vertex = points[:, 2] < z_cut * radius
    keep_face = keep_vertex[cells].all(axis=1)
    cells = cells[keep_face]
    used = np.unique(cells)
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return points[used], remap[cells].astype(np.int32)


def make_synthetic_gpmm(points, cells, rank: int = 8, sigma: float = 30.0,
                        scale: float = 3.0, seed: int = 0, device=DEFAULT_DEVICE):
    """Small GPMM over an arbitrary mesh through the production models'
    kernel and Nyström pipeline (a diagonal Gaussian kernel), on ``device``
    (the card unless ``device="cpu"``)."""
    from icp_proposal_tpu_torch.models.gpmm import make_gpmm
    from icp_proposal_tpu_torch.models.kernels import DiagonalKernel, GaussianScalar
    from icp_proposal_tpu_torch.models.nystrom import nystrom_lowrank
    from icp_proposal_tpu_torch.ops.surface_sampling import area_weighted_vertex_subset

    kernel = DiagonalKernel(GaussianScalar(sigma)) * scale
    n_sample = min(max(2 * rank, 16), len(points))
    sample_ids = area_weighted_vertex_subset(points, cells, n_sample, seed=seed + 1)
    points64 = np.asarray(points, np.float64)
    basis, variance = nystrom_lowrank(kernel, points64[sample_ids], points64,
                                      num_basis=rank)
    return make_gpmm(ref_points=np.asarray(points, np.float32), cells=cells,
                     mean_disp=np.zeros_like(points, dtype=np.float32), basis=basis,
                     variance=variance, noise_variance=0.0, device=device)
