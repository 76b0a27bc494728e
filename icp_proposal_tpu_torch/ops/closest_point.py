"""Batched point→surface closest-point helpers (plain PyTorch).

Counterpart of ``icp_proposal_tpu/ops/closest_point.py``.  The hot queries
go through the kernels of ``ops/closest_point_cuda.py``: K3 or K8 and K4
behind the shortlist index, K5 for the dense queries
(``surface_distances_auto``).  This module holds their plain versions: the
elementwise Ericson cascade (K4's, and the winner recompute), the dense
nearest-vertex argmin (K3's), its dot form (K8's) and the dense
point→triangle argmin (K5's).  All round term by term in the
Pallas kernels' order (``_tile_dist2``, closest_point_pallas.py:58-119), as
the CUDA kernels compiled with -fmad=false do, so ids agree exactly.
"""
from __future__ import annotations

import torch

_DENSE_CHUNK = 1 << 24  # (chain, query, face) triples per block of the dense twin


def _dot(a, b):
    """a·b over the last axis of size 3, summed as (x + y) + z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _safe_div(num, den):
    return num / torch.where(torch.abs(den) < 1e-30, torch.ones_like(den), den)


def closest_point_on_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, broadcasting over leading
    dims → (point [..., 3], dist2 [...]).  Branchless region cascade."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = _safe_div(torch.ones_like(va), va + vb + vc)  # interior
    v = vb * denom
    w = vc * denom

    in_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)
    w_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    v = torch.where(in_bc, 1.0 - w_bc, v)
    w = torch.where(in_bc, w_bc, w)

    in_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    w_ac = _safe_div(d2, d2 - d6)
    v = torch.where(in_ac, 0.0, v)
    w = torch.where(in_ac, w_ac, w)

    in_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    v_ab = _safe_div(d1, d1 - d3)
    v = torch.where(in_ab, v_ab, v)
    w = torch.where(in_ab, 0.0, w)

    in_c = (d6 >= 0.0) & (d5 <= d6)
    v = torch.where(in_c, 0.0, v)
    w = torch.where(in_c, 1.0, w)

    in_b = (d3 >= 0.0) & (d4 <= d3)
    v = torch.where(in_b, 1.0, v)
    w = torch.where(in_b, 0.0, w)

    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    v = torch.where(in_a, 0.0, v)
    w = torch.where(in_a, 0.0, w)

    # degenerate-triangle safety: clamp to the valid barycentric range
    v = torch.clamp(v, 0.0, 1.0)
    w = torch.clamp(w, 0.0, 1.0)
    s = v + w
    scale = torch.where(s > 1.0, 1.0 / torch.clamp_min(s, 1e-30), 1.0)
    v = v * scale
    w = w * scale

    point = a + v[..., None] * ab + w[..., None] * ac
    diff = p - point
    return point, _dot(diff, diff)


def _argmin_finite(d2):
    """argmin over the last axis, first minimum on ties, a NaN never winning:
    a row with no finite value (a NaN query, an all-NaN vertex set) gets 0,
    as K3 and K8 give it; int32."""
    d2 = d2.masked_fill_(torch.isnan(d2), float("inf"))
    return torch.argmin(d2, dim=-1).to(torch.int32)


def nearest_vertices(queries, points):
    """Nearest-vertex ids: queries [B, P, 3] vs points [V, 3] (shared) or
    [B, V, 3] (one set per chain) → ids [B, P] int32, ties to the lowest id,
    a NaN d² never winning (no finite d² → id 0).  d² = dx·dx + dy·dy +
    dz·dz, rounded term by term as K3 does.  Works through the chains in
    blocks of at most ``_DENSE_CHUNK`` (chain, query, vertex) triples."""
    bsz, p = queries.shape[0], queries.shape[1]
    batched = points.dim() == 3
    step = max(1, _DENSE_CHUNK // max(1, p * points.shape[-2]))
    ids = [torch.empty((0, p), dtype=torch.int32, device=queries.device)]
    for lo in range(0, bsz, step):
        pts = points[lo:lo + step] if batched else points[None]
        q = queries[lo:lo + step]
        dx = q[..., :, None, 0] - pts[..., None, :, 0]
        dy = q[..., :, None, 1] - pts[..., None, :, 1]
        dz = q[..., :, None, 2] - pts[..., None, :, 2]
        ids.append(_argmin_finite(dx * dx + dy * dy + dz * dz))  # [n, P, V]
    return torch.cat(ids)


def coarse_nearest_dot(queries, points_aug):
    """Dot-form coarse nearest vertex (K8's plain version): queries [B, P, 3]
    against one shared table points_aug [V, 4] of rows (−2x, −2y, −2z, ‖v‖²)
    (``surface_index.pack_points_aug``) → ids [B, P] int32, the argmin over
    v of ((qx·ax + qy·ay) + qz·az) + ‖v‖², each product and sum rounded on
    its own as K8 does; ties to the lowest id, a NaN s never winning (no
    finite s → id 0).  Works through the chains in blocks of at most
    ``_DENSE_CHUNK`` (chain, query, vertex) triples."""
    bsz, p = queries.shape[0], queries.shape[1]
    ax, ay, az, n2 = points_aug.unbind(-1)  # [V] each
    step = max(1, _DENSE_CHUNK // max(1, p * points_aug.shape[0]))
    ids = [torch.empty((0, p), dtype=torch.int32, device=queries.device)]
    for lo in range(0, bsz, step):
        q = queries[lo:lo + step, :, None, :]  # [n, P, 1, 3]
        s = q[..., 0] * ax + q[..., 1] * ay
        s = s + q[..., 2] * az
        ids.append(_argmin_finite(s + n2))  # [n, P, V]
    return torch.cat(ids)


def surface_distances(queries, points, cells):
    """Dense squared distance and nearest face of each query (K5's plain
    version): queries [B, P, 3] or [P, 3] (shared by all chains), points
    [V, 3] (shared) or [B, V, 3] (one mesh per chain), cells [F, 3] →
    (d2 [B, P] float32, face_idx [B, P] int32); ties to the lowest face
    index.  A NaN d² never wins, as in K5 and the Pallas kernel's running
    minimum: a query with no finite d² (a NaN query) gets (+inf, 0).
    Works through the chains in blocks of at most ``_DENSE_CHUNK``
    (chain, query, face) triples."""
    q_batched, p_batched = queries.dim() == 3, points.dim() == 3
    if not (q_batched or p_batched):
        raise ValueError("surface_distances needs a chain dimension on the "
                         "queries or on the points")
    bsz = queries.shape[0] if q_batched else points.shape[0]
    tri = points[..., cells.long(), :]  # [(B,) F, 3, 3]
    if not p_batched:
        tri = tri[None]
    p, f = queries.shape[-2], cells.shape[0]
    step = max(1, _DENSE_CHUNK // max(1, p * f))
    d2s, ids = [], []
    for lo in range(0, bsz, step):
        hi = min(lo + step, bsz)
        q = (queries[lo:hi] if q_batched else queries[None])[:, :, None, :]
        t = (tri[lo:hi] if p_batched else tri)[:, None]  # [n, 1, F, 3, 3]
        _, d2 = closest_point_on_triangle(q, t[..., 0, :], t[..., 1, :],
                                          t[..., 2, :])  # [n, P, F]
        d2 = d2.masked_fill_(torch.isnan(d2), float("inf"))
        d2s.append(torch.amin(d2, dim=-1))
        ids.append(torch.argmin(d2, dim=-1).to(torch.int32))
    return torch.cat(d2s), torch.cat(ids)


def surface_distances_auto(queries, points, cells):
    """(d2, face_idx) through the culled K5
    (``closest_point_cuda.surface_distances``, bitwise the dense scan; its
    wrapper takes the plain version for tensors on the CPU); same arguments
    as ``surface_distances``.  Under grad, K5 takes its inputs detached and
    the winner's d² is recomputed from the live queries and points, the
    only evaluation gradients flow through (as in the shortlist index)."""
    from icp_proposal_tpu_torch.ops.closest_point_cuda import surface_distances as k5

    if not (torch.is_grad_enabled() and (queries.requires_grad or points.requires_grad)):
        return k5(queries, points, cells)
    _, fidx = k5(queries.detach(), points.detach(), cells)
    tri, _ = _corners(points, cells, fidx)
    q = queries if queries.dim() == 3 else queries.expand(fidx.shape[0], -1, -1)
    _, d2 = closest_point_on_triangle(q, tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
    return d2, fidx


def _corners(points, cells, face_idx):
    """Corners [B, P, 3, 3] of faces face_idx [B, P] on points [V, 3] or
    [B, V, 3]; and their vertex ids [B, P, 3]."""
    corner_ids = cells[face_idx.long()]  # [B, P, 3]
    if points.dim() == 2:
        return points[corner_ids], corner_ids
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, corner_ids], corner_ids


def closest_points_on_surface(queries, points, cells):
    """Full dense closest-point query (K5, then the winner's point):
    same arguments as ``surface_distances`` → (cp [B, P, 3], d2 [B, P],
    face_idx [B, P])."""
    d2, fidx = surface_distances_auto(queries, points, cells)
    tri, _ = _corners(points, cells, fidx)
    q = queries if queries.dim() == 3 else queries.expand(d2.shape[0], -1, -1)
    cp, _ = closest_point_on_triangle(q, tri[..., 0, :], tri[..., 1, :],
                                      tri[..., 2, :])
    return cp, d2, fidx


def nearest_vertex_of_faces(cells, face_idx, cp, points):
    """Nearest of the 3 corners of each hit face to its closest point:
    cells [F, 3], face_idx [B, P], cp [B, P, 3], points [V, 3] (shared) or
    [B, V, 3] (one mesh per chain) → [B, P]."""
    corners, corner_ids = _corners(points, cells, face_idx)  # [B, P, 3, 3]
    d2 = torch.sum((corners - cp[..., None, :]) ** 2, dim=-1)  # [B, P, 3]
    pick = torch.argmin(d2, dim=-1, keepdim=True)
    return torch.gather(corner_ids, -1, pick)[..., 0]
