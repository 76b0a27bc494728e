"""Shortlist index for closest-point queries against a static surface.

Counterpart of ``icp_proposal_tpu/ops/surface_index.py``.  A query is split
into a coarse nearest-vertex pass over the V target vertices and an exact
point→triangle refine over that vertex's K precomputed candidate faces
(K4).  The winner's closest point and d² are then recomputed once,
elementwise.  The coarse pass is chosen once, when the index is built:
``coarse="exact"`` takes the subtractive nearest vertex (K3), ``"dot"`` the
dot form argminᵥ ‖v‖² − 2q·v over ``points_aug`` (K8; the reference's
``ICP_TPU_COARSE_MXU=1``), whose anchors may swap on near ties.  The refine
is exact either way.

The index is built where its tensors live, by ``native.shortlist_topk``:
exact float64 point→triangle distances from every vertex to every face and
the K nearest faces of each, ascending by (d², face id).  On the card that
is kernel K9; on the CPU its plain twin.  Either way the shortlist is the
one the reference builds by default, with its native OpenMP builder
(``icp_proposal_tpu/native/point_tri.cpp``): ids and order equal, ties
included, where that builder rounds each operation on its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from icp_proposal_tpu_torch import native
from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.ops.closest_point import (
    closest_point_on_triangle,
    closest_points_on_surface,
    surface_distances_auto,
)
from icp_proposal_tpu_torch.ops.closest_point_cuda import (
    coarse_nearest_dot,
    face_table,
    nearest_vertices,
    refine_shortlist,
)
from icp_proposal_tpu_torch.utils.profiling import span

INDEX_K = 64  # the reference's shortlist width (context.build_target_context)
COARSE_MODES = ("exact", "dot")  # K3, K8


@dataclass(frozen=True)
class SurfaceIndex:
    """Static-surface shortlist index, as tensors on one device.

    The refine (K4) reads each candidate's corners by face id from
    ``faces``, the face table of ``tri`` (``closest_point_cuda.face_table``),
    which the index builds from ``tri`` itself; the reference instead keeps
    them per vertex in its ``cand_tri``, which is ``faces[cand, :9]`` in
    component-major order."""

    points: torch.Tensor  # [V, 3]
    tri: torch.Tensor  # [F, 3, 3]
    cand: torch.Tensor  # [V, K] int32 — K nearest faces per vertex
    points_aug: torch.Tensor  # [V, 4] f32 rows (−2x, −2y, −2z, ‖v‖²), for K8
    coarse: str = "exact"  # the coarse pass: "exact" (K3) or "dot" (K8)
    faces: torch.Tensor = field(init=False, repr=False)  # [F, 12] f32, K4's table of tri

    def __post_init__(self):
        check_coarse(self.coarse)
        object.__setattr__(self, "faces", face_table(self.tri))

    @property
    def k(self) -> int:
        return self.cand.shape[1]


def check_coarse(coarse: str) -> str:
    if coarse not in COARSE_MODES:
        raise ValueError(f"coarse must be one of {COARSE_MODES}, got {coarse!r}")
    return coarse


def pack_points_aug(points: torch.Tensor) -> torch.Tensor:
    """points [V, 3] → [V, 4] float32 rows (−2x, −2y, −2z, ‖v‖²), no padding:
    the reference's ``pack_points_aug`` transposed.  ‖v‖² is summed as
    (x·x + y·y) + z·z, each product and sum rounded on its own, which is
    bitwise the reference's row; −2v is exact."""
    p = points.to(torch.float32)
    n2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]
    return torch.cat([-2.0 * p, n2[:, None]], dim=1).contiguous()


def _np_point_tri_dist2(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Exact point→triangle squared distances: p [N, 3], tri [F, 3, 3] →
    [N, F] (the Ericson cascade in numpy, branch-free: the reference's
    numpy fallback formula, an independent check of ``native``)."""
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


def _shortlist(points_t: torch.Tensor, cells_t: torch.Tensor, k: int):
    """(tri [F, 3, 3], cand [V, K] int32) of float32 points [V, 3] and cells
    [F, 3] on one device: corners gathered there, then float64, as the
    reference casts its float32 points for the native builder."""
    tri = points_t[cells_t]
    cand, _ = native.shortlist_topk(points_t.double(), tri.reshape(-1, 9).double(), k)
    return tri, cand


def build_shortlist(points, cells, k: int = INDEX_K):
    """The K nearest faces of every vertex, each shortlist ascending by
    (d², face id), built on the CPU (``native``'s twin) → cand [V, K] int32
    numpy."""
    points_t = torch.as_tensor(np.asarray(points, np.float32))
    cells_t = torch.as_tensor(np.asarray(cells), dtype=torch.int64)
    return _shortlist(points_t, cells_t, k)[1].numpy()


def build_surface_index(points, cells, k: int = INDEX_K, coarse: str = "exact",
                        device=DEFAULT_DEVICE) -> SurfaceIndex:
    """Build the shortlist index on ``device`` (the card unless
    ``device="cpu"``): the points go there once as float32, and the
    shortlist is built there (K9 on the card); ``coarse`` picks the coarse
    pass.  ``points`` may already be a float32 tensor on ``device``, which
    the index then shares."""
    check_coarse(coarse)
    device = resolve_device(device)
    if not isinstance(points, torch.Tensor):
        points = np.array(points, np.float32)  # a writable copy
    points_t = torch.as_tensor(points, dtype=torch.float32, device=device)
    cells_t = torch.as_tensor(cells, dtype=torch.int64, device=device)
    tri, cand = _shortlist(points_t, cells_t, k)
    return SurfaceIndex(points=points_t, tri=tri, cand=cand,
                        points_aug=pack_points_aug(points_t), coarse=coarse)


def index_closest(index: SurfaceIndex, queries: torch.Tensor):
    """queries [B, P, 3] → (cp [B, P, 3], d2 [B, P], face_idx [B, P] int32):
    coarse nearest vertex (K3, or K8 under ``coarse="dot"``), exact refine
    over its shortlist (K4), then the winner's closest point recomputed
    elementwise.

    The kernels take the queries detached; gradients flow through the
    recompute alone, from the live ``queries`` (the winner is piecewise
    constant in the queries), as the reference's ``stop_gradient`` does."""
    fixed = queries.detach().contiguous()
    if index.coarse == "dot":
        coarse = coarse_nearest_dot(fixed, index.points_aug)
    else:
        coarse = nearest_vertices(fixed, index.points)
    fidx, wtri = refine_shortlist(fixed, coarse, index.cand, index.faces)
    cp, d2 = closest_point_on_triangle(
        queries, wtri[..., 0:3], wtri[..., 3:6], wtri[..., 6:9])
    return cp, d2, fidx


def index_distances(index: SurfaceIndex, queries: torch.Tensor):
    """(d2 [B, P], face_idx [B, P]): ``index_closest`` without the points."""
    _, d2, fidx = index_closest(index, queries)
    return d2, fidx


def closest_auto(queries, points, cells, index: SurfaceIndex | None):
    """(cp, d2, face_idx) of queries [B, P, 3] on the surface (points [V, 3],
    cells [F, 3]): through the index when there is one, else the dense
    kernel K5.  Dispatch depends only on the index's presence, decided when
    the context was built."""
    with span("surface.query"):
        if index is not None:
            return index_closest(index, queries)
        return closest_points_on_surface(queries.contiguous(), points,
                                         cells.to(torch.int32))


def distances_auto(queries, points, cells, index: SurfaceIndex | None):
    """(d2, face_idx) (see ``closest_auto``)."""
    with span("surface.query"):
        if index is not None:
            return index_distances(index, queries)
        return surface_distances_auto(queries.contiguous(), points, cells.to(torch.int32))


def validate_index(index: SurfaceIndex, queries, atol: float = 1e-4,
                   with_rel: bool = False):
    """The index's distances against the dense kernel K5 over ``index.tri``
    for queries [P, 3] (or [B, P, 3]) → (max_abs_err, frac_mismatched), or
    with ``with_rel=True`` (max_abs_err, max_rel_err, frac_mismatched); a
    mismatch is an error above ``atol``.  The index is exact near the
    surface; far queries may miss the true face (the reference's error
    model, ``validate_index`` in ``icp_proposal_tpu/ops/surface_index.py``)."""
    dev = index.points.device
    if not isinstance(queries, torch.Tensor):
        queries = np.asarray(queries, np.float32)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if q.dim() == 2:
        q = q[None]
    q = q.contiguous()
    d2_fast, _ = index_distances(index, q)
    nf = index.tri.shape[0]
    soup = index.tri.reshape(-1, 3).contiguous()
    cells = torch.arange(3 * nf, dtype=torch.int32, device=dev).reshape(nf, 3)
    d2_ref, _ = surface_distances_auto(q, soup, cells)
    d_fast, d_ref = torch.sqrt(d2_fast), torch.sqrt(d2_ref)
    err = torch.abs(d_fast - d_ref)
    frac = float(torch.mean((err > atol).to(torch.float32)))
    if with_rel:
        rel = err / torch.clamp_min(d_ref, 1e-6)
        return float(err.max()), float(rel.max()), frac
    return float(err.max()), frac
