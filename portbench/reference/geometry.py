"""Plain geometry for the reference: poses, normals, closest points.

Everything works on a leading batch dimension N (one entry per judged
chain-step) and in the dtype of its inputs.  Large pairwise problems go
through in blocks of at most ``BLOCK`` (query, candidate) pairs.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 24
# two nearest vertices whose squared distances lie closer than TIE·(1 + d²)
# tie at the program's float32 rounding: either is a right answer
TIE = 1e-3


def euler_matrix(rot):
    """rot [..., 3] (φ, θ, ψ) → Rz(φ) Ry(θ) Rx(ψ) [..., 3, 3]."""
    phi, theta, psi = rot.unbind(-1)
    cz, sz = torch.cos(phi), torch.sin(phi)
    cy, sy = torch.cos(theta), torch.sin(theta)
    cx, sx = torch.cos(psi), torch.sin(psi)
    o, i = torch.zeros_like(phi), torch.ones_like(phi)
    rz = torch.stack([cz, -sz, o, sz, cz, o, o, o, i], -1).reshape(rot.shape[:-1] + (3, 3))
    ry = torch.stack([cy, o, sy, o, i, o, -sy, o, cy], -1).reshape(rot.shape[:-1] + (3, 3))
    rx = torch.stack([i, o, o, o, cx, -sx, o, sx, cx], -1).reshape(rot.shape[:-1] + (3, 3))
    return rz @ ry @ rx


def world_points(shape_points, scale, rot, trans, center):
    """s · (R(p − c) + c + t) for points [N, P, 3]."""
    r = euler_matrix(rot)
    c = center[:, None, :]
    posed = torch.einsum("nij,npj->npi", r, shape_points - c) + c + trans[:, None, :]
    return scale[:, None, None] * posed


def model_frame(points, scale, rot, trans, center):
    """The inverse of ``world_points``' pose and scale for points [N, P, 3]."""
    r = euler_matrix(rot)
    c = center[:, None, :]
    local = points / scale[:, None, None] - c - trans[:, None, :]
    return torch.einsum("nji,npj->npi", r, local) + c


def boundary_mask(cells: np.ndarray, n_points: int) -> np.ndarray:
    """Vertices on an edge that only one triangle has."""
    edges = np.sort(np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                    cells[:, [2, 0]]]), axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    mask = np.zeros(n_points, bool)
    mask[uniq[counts == 1].ravel()] = True
    return mask


def vertex_normals(points, cells):
    """Unit vertex normals [N, V, 3]: the normalised sum of the unit normals
    of the faces around each vertex."""
    tri = points[:, cells]  # [N, F, 3, 3]
    fn = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0],
                            dim=-1)
    fn = fn / torch.linalg.vector_norm(fn, dim=-1, keepdim=True).clamp_min(1e-20)
    acc = torch.zeros_like(points)
    for k in range(3):
        acc.index_add_(1, cells[:, k], fn)
    return acc / torch.linalg.vector_norm(acc, dim=-1, keepdim=True).clamp_min(1e-20)


def closest_on_triangle(p, a, b, c):
    """Closest point of triangle (a, b, c) to p and its squared distance,
    broadcasting over leading dimensions (Ericson, Real-Time Collision
    Detection, 5.1.5): the Voronoi region of p decides the barycentrics."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2

    def div(n, d):
        return n / torch.where(d.abs() < 1e-30, torch.ones_like(d), d)

    denom = div(torch.ones_like(va), va + vb + vc)
    v, w = vb * denom, vc * denom
    regions = [  # checked last to first wins, as the cascade's early returns
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         1 - div(d4 - d3, (d4 - d3) + (d5 - d6)), div(d4 - d3, (d4 - d3) + (d5 - d6))),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), torch.zeros_like(v), div(d2, d2 - d6)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), div(d1, d1 - d3), torch.zeros_like(v)),
        ((d6 >= 0) & (d5 <= d6), torch.zeros_like(v), torch.ones_like(v)),
        ((d3 >= 0) & (d4 <= d3), torch.ones_like(v), torch.zeros_like(v)),
        ((d1 <= 0) & (d2 <= 0), torch.zeros_like(v), torch.zeros_like(v)),
    ]
    for cond, vv, ww in regions:
        v, w = torch.where(cond, vv, v), torch.where(cond, ww, w)
    v, w = v.clamp(0, 1), w.clamp(0, 1)
    s = v + w
    shrink = torch.where(s > 1, 1 / s.clamp_min(1e-30), torch.ones_like(s))
    v, w = v * shrink, w * shrink
    point = a + v[..., None] * ab + w[..., None] * ac
    return point, ((p - point) ** 2).sum(-1)


def nearest_vertex(queries, points, second: bool = False):
    """Index of the nearest of points [V, 3] or [N, V, 3] to each of queries
    [N, P, 3] → [N, P] (the lowest index on ties); with ``second`` also the
    second nearest and whether the two tie at rounding (``TIE``)."""
    n, p = queries.shape[:2]
    out = torch.empty((n, p, 2), dtype=torch.long, device=queries.device)
    tie = torch.zeros((n, p), dtype=torch.bool, device=queries.device)
    step = max(1, BLOCK // (p * points.shape[-2]))
    for lo in range(0, n, step):
        pts = points[lo:lo + step] if points.dim() == 3 else points[None]
        d2 = ((queries[lo:lo + step, :, None, :] - pts[:, None, :, :]) ** 2).sum(-1)
        if second:
            best, out[lo:lo + step] = torch.topk(d2, 2, dim=-1, largest=False, sorted=True)
            tie[lo:lo + step] = best[..., 1] - best[..., 0] <= TIE * (1 + best[..., 0])
        else:
            out[lo:lo + step, :, 0] = torch.argmin(d2, dim=-1)
    return (out[..., 0], out[..., 1], tie) if second else out[..., 0]


def closest_over_faces(queries, tri, face_ids=None):
    """The closest point to each query over candidate triangles.

    queries [N, P, 3]; tri [F, 3, 3] (shared), [N, F, 3, 3] (one mesh per
    entry) or, with ``face_ids`` [N, P, K], the table the ids index.
    → (cp [N, P, 3], d2 [N, P], face [N, P]): the first minimum wins."""
    n, p = queries.shape[:2]
    f = face_ids.shape[-1] if face_ids is not None else tri.shape[-3]
    cp = queries.new_empty((n, p, 3))
    d2 = queries.new_empty((n, p))
    face = torch.empty((n, p), dtype=torch.long, device=queries.device)
    rows = max(1, BLOCK // (p * f))
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        q = queries[lo:hi, :, None, :]
        if face_ids is not None:
            ids = face_ids[lo:hi]
            t = tri[ids]  # [n, P, K, 3, 3]
        elif tri.dim() == 4:
            t = tri[lo:hi, None]
        else:
            t = tri[None, None]
        pt, dd = closest_on_triangle(q, t[..., 0, :], t[..., 1, :], t[..., 2, :])
        k = torch.argmin(dd, dim=-1, keepdim=True)
        d2[lo:hi] = torch.gather(dd, -1, k)[..., 0]
        cp[lo:hi] = torch.gather(pt, -2, k[..., None].expand(-1, -1, -1, 3))[..., 0, :]
        face[lo:hi] = (torch.gather(ids, -1, k)[..., 0] if face_ids is not None
                       else k[..., 0])
    return cp, d2, face


def nearest_corner(cells, face, cp, points):
    """The corner of each hit face nearest its closest point → vertex ids;
    points [V, 3] or [N, V, 3]."""
    corners = cells[face]  # [N, P, 3]
    if points.dim() == 2:
        xyz = points[corners]
    else:
        xyz = points[torch.arange(points.shape[0], device=points.device)[:, None, None],
                     corners]
    pick = torch.argmin(((xyz - cp[..., None, :]) ** 2).sum(-1), dim=-1, keepdim=True)
    return torch.gather(corners, -1, pick)[..., 0]


class Shortlist:
    """Closest points on a static surface through a shortlist index: the
    nearest surface vertex, then the ``k`` faces nearest that vertex (by
    exact point-to-triangle distance, ascending, lower face index first on
    ties), searched exactly.  Built here from the surface alone."""

    def __init__(self, points, cells, k: int):
        self.points, self.cells = points, cells
        self.tri = points[cells]  # [F, 3, 3]
        v = points.shape[0]
        d2 = torch.empty((v, cells.shape[0]), dtype=points.dtype, device=points.device)
        rows = max(1, BLOCK // cells.shape[0])
        for lo in range(0, v, rows):
            q = points[lo:lo + rows, None, :]
            _, d2[lo:lo + rows] = closest_on_triangle(
                q, self.tri[None, :, 0], self.tri[None, :, 1], self.tri[None, :, 2])
        order = torch.sort(d2, dim=1, stable=True).indices
        self.cand = order[:, :k]  # [V, k]

    def closest(self, queries, alternate: bool = False):
        """queries [N, P, 3] → (cp, d2, face, tied): ``tied`` marks the
        queries whose nearest vertex ties with the second at rounding; with
        ``alternate`` those take the second's faces."""
        coarse, other, tied = nearest_vertex(queries, self.points, second=True)
        if alternate:
            coarse = torch.where(tied, other, coarse)
        return closest_over_faces(queries, self.tri, self.cand[coarse]) + (tied,)
