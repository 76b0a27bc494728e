"""K3 ``nearest_vertices``, K4 ``refine_shortlist``, K5 ``surface_distances``
and K8 ``coarse_nearest_dot``: wrappers and plain twins.

Counterpart of the nearest-vertex, shortlist-refine, dense-distance and
dot-form coarse kernels of ``icp_proposal_tpu/ops/closest_point_pallas.py``.  The kernels are in
``csrc/closest_point.cu``, whose header says what bounds each on the H100
and how its design answers that.

Dispatch: a tensor on the CPU takes the plain PyTorch twin; a tensor on a
CUDA device launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches (the plain twin does not count); K3 and K5 also count their
per-chain-mode launches in ``<wrapper>.per_chain_launches``.  The
twins round term by term in the kernels' order (``ops/closest_point.py``),
so ids agree exactly, ties included.
"""
from __future__ import annotations

import ctypes

import torch

from icp_proposal_tpu_torch._build import check_tensor, kernel_device, launch, load_library
from icp_proposal_tpu_torch.ops import closest_point

_NO_ID = 2 ** 30

nearest_vertices_plain = closest_point.nearest_vertices
surface_distances_plain = closest_point.surface_distances
coarse_nearest_dot_plain = closest_point.coarse_nearest_dot


def nearest_vertices(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """argminᵥ ‖q − v‖² per query, ties to the lowest id, a NaN d² never
    winning (no finite d² → id 0): queries [B, P, 3], points [V, 3] (shared
    by all chains) or [B, V, 3] (one set per chain), float32 contiguous →
    ids [B, P] int32.

    Kernel K3 (``csrc/closest_point.cu``) replaces ``_make_nv_kernel`` in
    ``icp_proposal_tpu/ops/closest_point_pallas.py``.  Bound by instruction
    issue: 8 FP32 operations a (query, vertex) pair that may not fuse into
    FMAs (the ids must round as the twin's do).  A lane holds Q queries in
    registers, so one 16-byte shared-memory broadcast of a staged vertex
    feeds Q pairs, and each pair adds one ``fminf`` to its group's running
    minimum; only the group that holds a query's best is rescanned for the
    lowest id.  A shared vertex set is staged once per block, whose warps
    walk the flat list of B·P queries; a per-chain set is staged by
    ``cp.async`` while the block scans the one before, and the block's warps
    split it into slices merged by the least (d², id)."""
    check_tensor(queries, "queries", torch.float32, (None, None, 3))
    bsz, p = queries.shape[0], queries.shape[1]
    batched = points.dim() == 3
    check_tensor(points, "points", torch.float32,
                 (bsz, None, 3) if batched else (None, 3))
    dev = kernel_device(queries, points)
    if dev.type == "cpu":
        return nearest_vertices_plain(queries, points)
    ids = torch.empty((bsz, p), dtype=torch.int32, device=dev)
    launch("icp_nearest_vertices", dev, queries.data_ptr(), points.data_ptr(),
           ids.data_ptr(), bsz, p, points.shape[-2], int(batched))
    nearest_vertices.launches += 1
    nearest_vertices.per_chain_launches += int(batched)
    return ids


def nearest_vertices_config(bsz: int, p: int, v: int, per_chain: bool,
                            dot: bool = False) -> dict:
    """K3's launch on the current card for ``bsz`` chains of ``p`` queries
    against ``v`` vertices (shared or one set per chain), as
    ``nearest_vertices`` makes it, or with ``dot`` K8's (a shared set) as
    ``coarse_nearest_dot`` makes it: queries a lane holds, threads per
    block, blocks, dynamic shared bytes per block and blocks per SM."""
    out = (ctypes.c_int * 5)()
    err = load_library().icp_nearest_vertices_config(bsz, p, v, int(per_chain), int(dot), out)
    if err != 0:
        raise RuntimeError(f"no {'K8' if dot else 'K3'} launch for B={bsz}, P={p}, "
                           f"V={v}: CUDA error {err}")
    return dict(zip(("q", "threads", "blocks", "smem_bytes", "ctas_per_sm"), out))


nearest_vertices.launches = 0
nearest_vertices.per_chain_launches = 0


def face_table(tri: torch.Tensor) -> torch.Tensor:
    """K4's face table: tri [F, 3, 3] float32 → [F, 12] rows (a, b, c, 0, 0,
    0), three float4 a face."""
    tri = tri.to(torch.float32)
    return torch.cat([tri.reshape(-1, 9), tri.new_zeros(tri.shape[0], 3)], dim=1).contiguous()


def refine_pick(d2, faces):
    """The refine's winning slot [..., 1] int64 over the last axis of d2 and
    faces [..., K]: the least d², then the smallest face id, then the lowest
    slot; a NaN d² in any slot makes slot 0 the winner (``amin`` propagates
    the NaN, so no slot ties with it), as ``jnp.min`` does in the
    reference."""
    k = d2.shape[-1]
    best = torch.amin(d2, dim=-1, keepdim=True)
    fid_tied = torch.where(d2 == best, faces, _NO_ID)
    fmin = torch.amin(fid_tied, dim=-1, keepdim=True)
    slot = torch.arange(k, device=d2.device, dtype=torch.int32)
    return torch.amin(torch.where(fid_tied == fmin, slot, _NO_ID), dim=-1,
                      keepdim=True).long()


def refine_shortlist_plain(queries, coarse, cand, faces):
    """Plain twin of ``refine_shortlist`` (same arguments and results)."""
    v = cand.shape[0]
    rows = coarse.long().clamp(0, v - 1)  # out-of-range ids clamp, as in K4
    fids = cand[rows]  # [B, P, K]
    corners = faces[fids.long().clamp(0, faces.shape[0] - 1), :9]  # [B, P, K, 9]
    _, d2 = closest_point.closest_point_on_triangle(
        queries[..., None, :], corners[..., 0:3], corners[..., 3:6],
        corners[..., 6:9])  # [B, P, K]
    kidx = refine_pick(d2, fids)  # [B, P, 1]
    fidx = torch.gather(fids, -1, kidx)[..., 0]
    wtri = torch.gather(corners, -2, kidx[..., None].expand(rows.shape + (1, 9)))
    return fidx, wtri[..., 0, :]


def refine_shortlist(queries: torch.Tensor, coarse: torch.Tensor,
                     cand: torch.Tensor, faces: torch.Tensor):
    """Exact point→triangle refine over each query's shortlist.

    queries [B, P, 3] f32; coarse [B, P] int32 rows of the static index (the
    coarse nearest vertex); cand [V, K] int32 candidate face ids per vertex;
    faces [F, 12] f32, the face table (``face_table``).
    → (winner face id [B, P] int32, winner corners [B, P, 9] f32); the winner
    has the least d², then the smallest face id, then the lowest slot, and a
    NaN d² in any slot makes slot 0 the winner.  Out-of-range rows and face
    ids clamp.

    Kernel K4 (``csrc/closest_point.cu``) replaces ``_make_refine_kernel`` in
    ``icp_proposal_tpu/ops/closest_point_pallas.py``, whose path pregathers
    the [B, P, 9K] corners.  Bound by the cascade's instruction issue once
    the rows are near: the kernel reads each candidate's corners from the
    face table by face id through the read-only path, with L1 (no shared
    memory) holding the table, and a group of lanes per query merges by
    (d², face id) with a warp vote for the NaN rule."""
    check_tensor(queries, "queries", torch.float32, (None, None, 3))
    bsz, p = queries.shape[0], queries.shape[1]
    check_tensor(coarse, "coarse", torch.int32, (bsz, p))
    check_tensor(cand, "cand", torch.int32, (None, None))
    v, k = cand.shape
    if k < 1:
        raise ValueError("refine_shortlist needs at least one candidate per vertex")
    check_tensor(faces, "faces", torch.float32, (None, None))
    if faces.shape[1] != 12 or faces.shape[0] < 1:
        raise ValueError(f"faces must be a face table [F >= 1, 12], got {tuple(faces.shape)}")
    dev = kernel_device(queries, coarse, cand, faces)
    if dev.type == "cpu":
        return refine_shortlist_plain(queries, coarse, cand, faces)
    if faces.data_ptr() % 16:
        raise ValueError("faces must start on a 16-byte boundary (float4 rows)")
    fidx = torch.empty((bsz, p), dtype=torch.int32, device=dev)
    wtri = torch.empty((bsz, p, 9), dtype=torch.float32, device=dev)
    launch("icp_refine_shortlist", dev, queries.data_ptr(), coarse.data_ptr(),
           cand.data_ptr(), faces.data_ptr(), fidx.data_ptr(), wtri.data_ptr(),
           bsz * p, v, faces.shape[0], k)
    refine_shortlist.launches += 1
    return fidx, wtri


refine_shortlist.launches = 0


def refine_shortlist_config(n_queries: int) -> dict:
    """K4's launch on the current card for ``n_queries`` queries, as
    ``refine_shortlist`` makes it: lanes a query, threads per block, blocks,
    registers a thread and blocks per SM."""
    out = (ctypes.c_int * 5)()
    err = load_library().icp_refine_shortlist_config(n_queries, out)
    if err != 0:
        raise RuntimeError(f"no K4 launch for {n_queries} queries: CUDA error {err}")
    return dict(zip(("lanes", "threads", "blocks", "registers", "ctas_per_sm"), out))


TILE_FACES = 32  # K5's culling tile (kTileFaces in csrc/closest_point.cu)


def surface_distances(queries: torch.Tensor, points: torch.Tensor,
                      cells: torch.Tensor, cull: bool = True,
                      visits: torch.Tensor | None = None):
    """Point→triangle min d² and nearest face per query, ties to the lowest
    face index, a NaN d² never winning (a NaN query gets (+inf, 0)):
    queries [B, P, 3] or [P, 3] (shared by all chains), points [V, 3]
    (shared) or [B, V, 3] (one mesh per chain), float32 contiguous; cells
    [F, 3] int32 contiguous → (d2 [B, P] float32, face_idx [B, P] int32).

    Kernel K5 (``csrc/closest_point.cu``) replaces ``_make_kernel`` /
    ``_dist2_call`` in ``icp_proposal_tpu/ops/closest_point_pallas.py``.
    Unlike ``pack_triangles``, it takes vertices and cells, not a triangle
    soup.  Bound by instruction issue on the (query, face) pairs it runs
    the cascade on (233 instructions a pair in SASS, 324 with the packing's
    shuffles), so it runs few: each warp of 32 queries visits the tiles of ``TILE_FACES``
    consecutive faces nearest first by the bounding boxes its own pre-pass
    (``tile_boxes_kernel``) computes, and skips a tile when no query can
    reach its running best plus a stated rounding margin; inside a visited
    tile each face's own box is tested against each query the same way,
    and the surviving pairs are packed onto the warp's lanes (or, where
    most survive, every lane runs every kept face).  So the result is
    bitwise the dense scan's.  ``cull=False`` is that dense scan (every
    tile in ascending order), kept only as what the checks compare the
    culled kernel with.  ``visits``, an int64 CUDA tensor of 3 that the
    call adds to, counts (active queries × tiles visited, × faces visited,
    cascades run: packed pairs, and active queries × faces of the direct
    loop); None on the main path."""
    q_batched, p_batched = queries.dim() == 3, points.dim() == 3
    if not (q_batched or p_batched):
        raise ValueError("surface_distances needs a chain dimension on the "
                         "queries or on the points")
    bsz = queries.shape[0] if q_batched else points.shape[0]
    check_tensor(queries, "queries", torch.float32,
                 (bsz, None, 3) if q_batched else (None, 3))
    check_tensor(points, "points", torch.float32,
                 (bsz, None, 3) if p_batched else (None, 3))
    check_tensor(cells, "cells", torch.int32, (None, 3))
    if visits is not None:
        check_tensor(visits, "visits", torch.int64, (3,))
    dev = kernel_device(queries, points, cells,
                        *(() if visits is None else (visits,)))
    if dev.type == "cpu":
        if visits is not None:
            raise ValueError("visits counts the CUDA kernel's tile visits; "
                             "the plain version has none")
        return surface_distances_plain(queries, points, cells)
    if bsz > 65535:
        raise ValueError(f"surface_distances takes at most 65,535 chains, got {bsz}")
    p, f = queries.shape[-2], cells.shape[0]
    n_tiles = -(-f // TILE_FACES)
    d2 = torch.empty((bsz, p), dtype=torch.float32, device=dev)
    idx = torch.empty((bsz, p), dtype=torch.int32, device=dev)
    boxes = (torch.empty((bsz if p_batched else 1, n_tiles, 8), dtype=torch.float32,
                         device=dev) if cull else None)
    launch("icp_surface_distances", dev, queries.data_ptr(), points.data_ptr(),
           cells.data_ptr(), None if boxes is None else boxes.data_ptr(),
           None if visits is None else visits.data_ptr(), d2.data_ptr(), idx.data_ptr(),
           bsz, p, points.shape[-2], f, int(q_batched), int(p_batched), int(cull))
    surface_distances.launches += 1
    surface_distances.per_chain_launches += int(p_batched)
    return d2, idx


surface_distances.launches = 0
surface_distances.per_chain_launches = 0


def coarse_nearest_dot(queries: torch.Tensor, points_aug: torch.Tensor) -> torch.Tensor:
    """Dot-form coarse nearest vertex, the shortlist's coarse pass under
    ``coarse="dot"``: argminᵥ ((qx·ax + qy·ay) + qz·az) + ‖v‖² per query,
    ties to the lowest id.  queries [B, P, 3]; points_aug [V, 4], one
    surface shared by all chains (``surface_index.pack_points_aug``), float32
    contiguous → ids [B, P] int32.  As in the reference, only a shared
    surface is taken: per-chain vertex sets go to ``nearest_vertices``.
    The dot form rounds otherwise than ‖q − v‖², so near-tied anchors may
    differ from K3's; the refine that follows is exact.

    Kernel K8 (``csrc/closest_point.cu``) replaces ``_make_coarse_mxu_kernel``
    / ``_coarse_mxu_call`` in ``icp_proposal_tpu/ops/closest_point_pallas.py``.
    Bound by instruction issue (6 FP32 operations per query-vertex pair, no
    tensor cores: TF32 and bf16 inputs break the anchors' exactness).  It is
    K3's register-blocked scan over the flat list of B·P queries with the
    dot-form pair: one 16-byte shared-memory broadcast of a staged row feeds
    the Q queries a lane holds, group minima by ``fminf`` and a rescan of
    the winning group for the lowest id.  A NaN value never wins (no finite
    value → id 0)."""
    check_tensor(queries, "queries", torch.float32, (None, None, 3))
    if points_aug.dim() != 2:
        raise ValueError("coarse_nearest_dot takes one surface shared by all "
                         f"chains ([V, 4]), got shape {tuple(points_aug.shape)}; "
                         "per-chain vertex sets go to nearest_vertices")
    check_tensor(points_aug, "points_aug", torch.float32, (None, 4))
    if points_aug.shape[0] == 0:
        raise ValueError("coarse_nearest_dot needs at least one vertex")
    dev = kernel_device(queries, points_aug)
    if dev.type == "cpu":
        return coarse_nearest_dot_plain(queries, points_aug)
    if points_aug.data_ptr() % 16:
        raise ValueError("points_aug must start on a 16-byte boundary (float4 rows)")
    bsz, p = queries.shape[0], queries.shape[1]
    ids = torch.empty((bsz, p), dtype=torch.int32, device=dev)
    launch("icp_coarse_nearest_dot", dev, queries.data_ptr(), points_aug.data_ptr(),
           ids.data_ptr(), bsz, p, points_aug.shape[0])
    coarse_nearest_dot.launches += 1
    return ids


coarse_nearest_dot.launches = 0
