"""Shortlist index for closest-point queries against a static surface.

Counterpart of ``icp_proposal_tpu/ops/surface_index.py``.  A query is split
into a coarse nearest-vertex pass over the V target vertices (K3, shared
mode) and an exact point→triangle refine over that vertex's K precomputed
candidate faces (K4).  The winner's closest point and d² are then
recomputed once, elementwise.

The index is built on the host with numpy: the reference's chunked-numpy
path, exact float64 distances plus top-K.  The reference's native OpenMP
builder is not loaded; its library is compiled for another host's CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.ops.closest_point import closest_point_on_triangle
from icp_proposal_tpu_torch.ops.closest_point_cuda import (
    nearest_vertices,
    refine_shortlist,
)

INDEX_K = 64  # the reference's shortlist width (context.build_target_context)
_CHUNK = 256  # query vertices per block of the host build


@dataclass(frozen=True)
class SurfaceIndex:
    """Static-surface shortlist index, as tensors on one device.

    ``cand_tri`` holds the K candidate faces' corners per vertex in
    COMPONENT-MAJOR rows ([V, 9·K]: ax[K] ay[K] az[K] bx ... cz[K]), so a
    warp reads each component of its K candidates as one coalesced row."""

    points: torch.Tensor  # [V, 3]
    tri: torch.Tensor  # [F, 3, 3]
    cand: torch.Tensor  # [V, K] int32 — K nearest faces per vertex
    cand_tri: torch.Tensor  # [V, 9*K] f32

    @property
    def k(self) -> int:
        return self.cand.shape[1]


def _np_point_tri_dist2(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Exact point→triangle squared distances: p [N, 3], tri [F, 3, 3] →
    [N, F] (the Ericson cascade in numpy)."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab, ac = b - a, c - a
    p = p[:, None, :]
    ap, bp, cp = p - a, p - b, p - c

    def dot(x, y):
        return np.sum(x * y, axis=-1)

    d1, d2_ = dot(ab, ap), dot(ac, ap)
    d3, d4 = dot(ab, bp), dot(ac, bp)
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2_ - d1 * d6
    vc = d1 * d4 - d3 * d2_

    def safe_div(num, den):
        return num / np.where(np.abs(den) < 1e-30, 1.0, den)

    denom = safe_div(1.0, va + vb + vc)
    v = vb * denom
    w = vc * denom

    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    v = np.where(in_bc, 1.0 - w_bc, v)
    w = np.where(in_bc, w_bc, w)
    in_ac = (vb <= 0) & (d2_ >= 0) & (d6 <= 0)
    w_ac = safe_div(d2_, d2_ - d6)
    v = np.where(in_ac, 0.0, v)
    w = np.where(in_ac, w_ac, w)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v_ab = safe_div(d1, d1 - d3)
    v = np.where(in_ab, v_ab, v)
    w = np.where(in_ab, 0.0, w)
    in_c = (d6 >= 0) & (d5 <= d6)
    v = np.where(in_c, 0.0, v)
    w = np.where(in_c, 1.0, w)
    in_b = (d3 >= 0) & (d4 <= d3)
    v = np.where(in_b, 1.0, v)
    w = np.where(in_b, 0.0, w)
    in_a = (d1 <= 0) & (d2_ <= 0)
    v = np.where(in_a, 0.0, v)
    w = np.where(in_a, 0.0, w)

    v = np.clip(v, 0.0, 1.0)
    w = np.clip(w, 0.0, 1.0)
    s = v + w
    scale = np.where(s > 1.0, 1.0 / np.maximum(s, 1e-30), 1.0)
    v, w = v * scale, w * scale
    cpnt = a + v[..., None] * ab + w[..., None] * ac
    diff = p - cpnt
    return np.sum(diff * diff, axis=-1)


def build_shortlist(points, cells, k: int = INDEX_K):
    """Host build: O(V·F) exact distances + top-K, each shortlist sorted by
    distance → (cand [V, K] int32, cand_tri [V, 9K] f32 component-major)."""
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells, np.int32)
    tri = points[cells]  # [F, 3, 3]
    v, f = points.shape[0], tri.shape[0]
    k = min(k, f)
    cand = np.empty((v, k), np.int32)
    for lo in range(0, v, _CHUNK):
        hi = min(lo + _CHUNK, v)
        d2 = _np_point_tri_dist2(points[lo:hi].astype(np.float64),
                                 tri.astype(np.float64))
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(d2, part, axis=1), axis=1)
        cand[lo:hi] = np.take_along_axis(part, order, axis=1).astype(np.int32)
    # [V, K, 3, 3] → [V, (corner, axis), K] → [V, 9·K]
    cand_tri = np.ascontiguousarray(
        tri[cand].transpose(0, 2, 3, 1).reshape(v, 9 * k).astype(np.float32)
    )
    return cand, cand_tri


def build_surface_index(points, cells, k: int = INDEX_K,
                        device=DEFAULT_DEVICE) -> SurfaceIndex:
    """Build the shortlist index on the host and place it on ``device`` (the
    card unless ``device="cpu"``)."""
    device = resolve_device(device)
    cand, cand_tri = build_shortlist(points, cells, k)
    points = np.asarray(points, np.float32)
    return SurfaceIndex(
        points=torch.as_tensor(points, device=device),
        tri=torch.as_tensor(points[np.asarray(cells)], device=device),
        cand=torch.as_tensor(cand, device=device),
        cand_tri=torch.as_tensor(cand_tri, device=device),
    )


def index_closest(index: SurfaceIndex, queries: torch.Tensor):
    """queries [B, P, 3] → (cp [B, P, 3], d2 [B, P], face_idx [B, P] int32):
    coarse nearest vertex (K3), exact refine over its shortlist (K4), then
    the winner's closest point recomputed elementwise."""
    queries = queries.contiguous()
    coarse = nearest_vertices(queries, index.points)
    fidx, wtri = refine_shortlist(queries, coarse, index.cand, index.cand_tri)
    cp, d2 = closest_point_on_triangle(
        queries, wtri[..., 0:3], wtri[..., 3:6], wtri[..., 6:9])
    return cp, d2, fidx


def _require_index(index: SurfaceIndex | None) -> SurfaceIndex:
    if index is None:
        raise NotImplementedError(
            "a target context without a shortlist index needs the dense "
            "closest-point kernel K5 (ROADMAP queue 2, K5)")
    return index


def closest_auto(queries, tri, index: SurfaceIndex | None):
    """(cp, d2, face_idx) through the index; ``tri`` serves the dense path
    of the reference, which waits for K5."""
    return index_closest(_require_index(index), queries)


def distances_auto(queries, tri, index: SurfaceIndex | None):
    """(d2, face_idx) through the index (see ``closest_auto``)."""
    _, d2, fidx = index_closest(_require_index(index), queries)
    return d2, fidx
