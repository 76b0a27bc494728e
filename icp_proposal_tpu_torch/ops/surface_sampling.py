"""Seeded vertex subsets (host-side numpy).

Copy of ``seeded_vertex_subset`` and ``area_weighted_vertex_subset`` from
``icp_proposal_tpu/ops/surface_sampling.py``: the same ``RandomState`` draws
give the same ids, so both packages observe the same vertices.
"""
from __future__ import annotations

import numpy as np


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
