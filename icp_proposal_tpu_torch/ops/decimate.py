"""Mesh decimation (host numpy, offline data preparation).

Copy of ``icp_proposal_tpu/ops/decimate.py``, which replaces scalismo's
``operations.decimate`` (reference call sites ``NonRigidIcpProposal.scala:45-46``,
``BfmFittingComplete.scala:45-47``, ``bfm/CreateGPModel.scala:43``).

Algorithm: quadric-error-metric half-edge collapse, with collapses restricted
to *endpoints* (no optimal-position solve).  The surviving vertices are then
an exact subset of the input vertices, which makes GPMM decimation a pure
row gather of the basis (``decimate_gpmm``), with no re-interpolation.
``decimate`` is the reference's code line for line: heap ties and set
iteration order decide which vertices survive.
"""
from __future__ import annotations

import heapq

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _vertex_quadrics(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Per-vertex 4×4 error quadrics = sum of face plane quadrics."""
    tri = points[cells]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-20)
    d = -np.sum(n * tri[:, 0], axis=1)
    plane = np.concatenate([n, d[:, None]], axis=1)  # [F,4]
    quad = plane[:, :, None] * plane[:, None, :]  # [F,4,4]
    # weight by face area for scale robustness
    quad = quad * np.maximum(norm, 1e-20)[:, :, None]
    q = np.zeros((len(points), 4, 4))
    for k in range(3):
        np.add.at(q, cells[:, k], quad)
    return q


def decimate(points, cells, target_vertices: int):
    """→ (new_points [V',3], new_cells [F',3], kept_ids [V'] into the input).

    Greedy QEM endpoint collapses until `target_vertices` remain (or no valid
    collapse is left).  Boundary edges are collapse targets too; degenerate
    and flipped faces are dropped at the end.
    """
    points = np.asarray(points, np.float64)
    cells = np.asarray(cells, np.int64)
    v = len(points)
    target_vertices = max(4, int(target_vertices))
    if target_vertices >= v:
        ids = np.arange(v)
        return points.astype(np.float32), cells.astype(np.int64), ids

    q = _vertex_quadrics(points, cells)
    parent = np.arange(v)  # union-find to track collapsed vertices

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # adjacency
    neighbors = [set() for _ in range(v)]
    edges = set()
    for a, b, c in cells:
        for i, j in ((a, b), (b, c), (c, a)):
            neighbors[i].add(j)
            neighbors[j].add(i)
            edges.add((min(i, j), max(i, j)))

    def cost(i, j):
        """Cost of collapsing i into j (j survives at its position)."""
        p = np.append(points[j], 1.0)
        return float(p @ (q[i] + q[j]) @ p)

    heap = []
    for (i, j) in edges:
        heapq.heappush(heap, (cost(i, j), i, j))
        heapq.heappush(heap, (cost(j, i), j, i))

    alive = np.ones(v, dtype=bool)
    n_alive = v
    version = np.zeros(v, dtype=np.int64)

    def live_neighbors(i):
        return {find(k) for k in neighbors[i] if alive[find(k)] and find(k) != i}

    while n_alive > target_vertices and heap:
        c, i, j = heapq.heappop(heap)
        ri, rj = find(i), find(j)
        if ri == rj or not alive[ri] or not alive[rj]:
            continue
        if ri != i or rj != j:  # stale entry
            continue
        # link condition (manifold preservation): the collapse of an interior
        # edge must have exactly 2 common neighbors (1 for a boundary edge);
        # more would create fins/non-manifold junctions.
        common = live_neighbors(ri) & live_neighbors(rj)
        if len(common) > 2:
            continue
        # collapse i -> j
        alive[ri] = False
        parent[ri] = rj
        n_alive -= 1
        q[rj] = q[rj] + q[ri]
        nbrs = neighbors[ri]
        for k in nbrs:
            rk = find(k)
            if rk != rj and alive[rk]:
                neighbors[rj].add(rk)
                neighbors[rk].discard(ri)
                neighbors[rk].add(rj)
        neighbors[ri] = set()
        # push refreshed costs for rj's edges
        for k in list(neighbors[rj]):
            rk = find(k)
            if rk != rj and alive[rk]:
                heapq.heappush(heap, (cost(rj, rk), rj, rk))
                heapq.heappush(heap, (cost(rk, rj), rk, rj))

    kept = np.where(alive)[0]
    remap = -np.ones(v, dtype=np.int64)
    remap[kept] = np.arange(len(kept))

    new_cells_full = np.array([[find(a), find(b), find(c)] for a, b, c in cells])
    valid = (
        (new_cells_full[:, 0] != new_cells_full[:, 1])
        & (new_cells_full[:, 1] != new_cells_full[:, 2])
        & (new_cells_full[:, 0] != new_cells_full[:, 2])
    )
    new_cells = remap[new_cells_full[valid]]
    # drop ALL copies of duplicated vertex-triples (collapse fins — two
    # coincident faces of opposite orientation are both artifacts)
    key = np.sort(new_cells, axis=1)
    _, inverse, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    new_cells = new_cells[counts[inverse] == 1]

    return points[kept].astype(np.float32), new_cells.astype(np.int64), kept


def decimate_gpmm(gpmm, target_vertices: int, device=DEFAULT_DEVICE):
    """Decimate a GPMM's domain: collapse the reference mesh, then gather
    mean and basis rows at the surviving vertices on the host (the exact
    restriction of the discrete GP, scalismo ``StatisticalMeshModel.decimate``)
    → (the port's ``Gpmm`` on ``device``, the card unless ``device="cpu"``;
    kept ids [V'] into the input)."""
    from icp_proposal_tpu_torch.models.gpmm import make_gpmm

    device = resolve_device(device)
    pts = gpmm.ref_points.cpu().numpy()
    cls = gpmm.cells.cpu().numpy()
    new_pts, new_cells, kept = decimate(pts, cls, target_vertices)
    return make_gpmm(
        ref_points=new_pts,
        cells=new_cells,
        mean_disp=gpmm.mean_disp.cpu().numpy()[kept],
        basis=gpmm.basis.cpu().numpy()[kept],
        variance=gpmm.variance.cpu().numpy(),
        noise_variance=float(gpmm.noise_variance),
        device=device,
    ), kept
