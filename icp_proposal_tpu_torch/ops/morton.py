"""Morton (Z-order) spatial sorting — host-side preprocessing.

numpy copy of ``icp_proposal_tpu/ops/morton.py``.  Face and query orders
decide which ids the seeded subsets pick and how the shortlist index is laid
out, so the port sorts exactly as the reference does.
"""
from __future__ import annotations

import numpy as np


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x.astype(np.uint64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: np.ndarray) -> np.ndarray:
    """[N,3] float → [N] uint64 Morton codes (10 bits/axis)."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(axis=0)
    extent = np.maximum(pts.max(axis=0) - lo, 1e-12)
    q = np.clip(((pts - lo) / extent) * 1023.0, 0, 1023).astype(np.uint64)
    return (
        _spread_bits(q[:, 0])
        | (_spread_bits(q[:, 1]) << 1)
        | (_spread_bits(q[:, 2]) << 2)
    )


def morton_sort_faces(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Permutation of faces by Morton code of their centroid."""
    pts = np.asarray(points, np.float64)
    cls = np.asarray(cells)
    centroids = pts[cls].mean(axis=1)
    return np.argsort(morton_codes(centroids), kind="stable")


def morton_sort_ids(points: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Reorder a vertex-id subset by Morton code of the vertex positions."""
    pts = np.asarray(points, np.float64)[np.asarray(ids)]
    return np.asarray(ids)[np.argsort(morton_codes(pts), kind="stable")]
