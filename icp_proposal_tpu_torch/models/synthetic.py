"""Synthetic meshes for the stand-in workloads (host numpy).

Copy of ``make_icosphere`` and ``make_open_patch`` from
``icp_proposal_tpu/models/synthetic.py``: the synthetic face stand-in is an
open icosphere patch, built the same way in both packages.
"""
from __future__ import annotations

import numpy as np


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
