"""K9 ``shortlist_topk`` and K10 ``point_tri_d2``: wrappers and plain twins.

Counterpart of ``icp_proposal_tpu/native`` (``point_tri.cpp``, a host C++
kernel of the JAX package, loaded with ctypes), which builds the shortlist
index of every target context: exact float64 point→triangle distances from
every target vertex to every face, and the K nearest faces of each vertex.
The kernels are in ``csrc/point_tri.cu``, whose header says what bounds them
on the H100 and how their design answers that.

Dispatch: a tensor on the CPU takes the plain PyTorch twin; a tensor on a
CUDA device launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches (the plain twin does not count).  The twin evaluates the
cascade of ``point_tri.cpp`` term by term in its order, so d² is bitwise
the kernels' and that of native built without floating-point contraction
(``-ffp-contract=off``), and ids agree exactly, ties included.
"""
from __future__ import annotations

import torch

from icp_proposal_tpu_torch._build import check_tensor, kernel_device, launch

MAX_K = 1024  # K9's largest K (kTopkMaxK in csrc/point_tri.cu)
TOPK_SORT = 2048  # K9's shared (d², id) buffer (kTopkSort): a tile holds TOPK_SORT − K faces
_PAIRS = 1 << 18  # (query, face) pairs a block of the twin holds

# float64 operations of the cascade by the region that ends it, in the
# order it tests them: vertex A, vertex B, edge AB, vertex C, edge AC, edge
# BC, the face interior (comparisons not counted)
REGIONS = ("A", "B", "AB", "C", "AC", "BC", "interior")
REGION_OPS = (24, 37, 48, 53, 64, 72, 78)


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _axpy(p, s, e):  # p − s·e, component by component
    return (p[0] - s * e[0], p[1] - s * e[1], p[2] - s * e[2])


def _cascade(queries, tri, regions=False):
    """The cascade of ``point_tri.cpp:49-97`` for queries [n, 3] against
    tri [F, 9]: every region evaluated, then the region that ends the
    cascade selected, last region first → d² [n, F], or with ``regions``
    (d², region [n, F] int64 indices into ``REGIONS``)."""
    p = tuple(queries[:, i, None] for i in range(3))
    a, b, c = (tuple(tri[:, 3 * v + i] for i in range(3)) for v in range(3))
    ab, ac, ap = _sub(b, a), _sub(c, a), _sub(p, a)
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = _sub(p, b)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    vc = d1 * d4 - d3 * d2
    cp = _sub(p, c)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    e43, e56 = d4 - d3, d5 - d6
    denom = torch.reciprocal(va + vb + vc)
    v, w = vb * denom, vc * denom
    d_in = _axpy(_axpy(ap, v, ab), w, ac)
    d_bc = _axpy(bp, e43 / (e43 + e56), _sub(c, b))
    d_ac = _axpy(ap, d2 / (d2 - d6), ac)
    d_ab = _axpy(ap, d1 / (d1 - d3), ab)
    out = _dot(d_in, d_in)
    region = torch.full_like(out, 6, dtype=torch.int64) if regions else None
    for code, mask, d in (
            (5, (va <= 0.0) & (e43 >= 0.0) & (e56 >= 0.0), d_bc),
            (4, (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0), d_ac),
            (3, (d6 >= 0.0) & (d5 <= d6), cp),
            (2, (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0), d_ab),
            (1, (d3 >= 0.0) & (d4 <= d3), bp),
            (0, (d1 <= 0.0) & (d2 <= 0.0), ap)):
        out = torch.where(mask, _dot(d, d), out)
        if regions:
            region = torch.where(mask, code, region)
    return (out, region) if regions else out


def _blocks(queries, tri):
    """Query ranges of the twin's blocks, ``_PAIRS`` pairs or fewer each."""
    n, f = queries.shape[0], tri.shape[0]
    step = max(1, _PAIRS // max(f, 1))
    return ((lo, min(lo + step, n)) for lo in range(0, n, step))


def point_tri_d2_plain(queries, tri):
    """Plain twin of ``point_tri_d2`` (same arguments and result)."""
    out = queries.new_empty((queries.shape[0], tri.shape[0]))
    for lo, hi in _blocks(queries, tri):
        out[lo:hi] = _cascade(queries[lo:hi], tri)
    return out


def _topk_rows(d2, k):
    """The first k columns of each row's order by (NaN last, d², column):
    a stable sort with NaN as +inf, then a stable sort of the NaN flags,
    so the order does not hang on how a backend sorts NaN → [n, k] int64."""
    nan = torch.isnan(d2)
    order = torch.sort(torch.where(nan, torch.inf, d2), dim=1, stable=True).indices
    if bool(nan.any()):
        flags = torch.gather(nan, 1, order).to(torch.int8)
        order = torch.gather(order, 1, torch.sort(flags, dim=1, stable=True).indices)
    return order[:, :k]


def shortlist_topk_plain(queries, tri, k):
    """Plain twin of ``shortlist_topk`` (same arguments and results)."""
    k = _check_k(k, tri.shape[0])
    n = queries.shape[0]
    idx = torch.empty((n, k), dtype=torch.int32, device=queries.device)
    d2 = queries.new_empty((n, k))
    for lo, hi in _blocks(queries, tri):
        full = _cascade(queries[lo:hi], tri)
        order = _topk_rows(full, k)
        idx[lo:hi] = order.to(torch.int32)
        d2[lo:hi] = torch.gather(full, 1, order)
    return idx, d2


def cascade_ops(queries, tri) -> int:
    """The float64 operations the cascade executes on these inputs: each
    pair's region cost (``REGION_OPS``), summed.  The kernels' bound."""
    ops = torch.as_tensor(REGION_OPS, dtype=torch.int64, device=queries.device)
    total = 0
    for lo, hi in _blocks(queries, tri):
        total += int(ops[_cascade(queries[lo:hi], tri, regions=True)[1]].sum())
    return total


def _check_k(k, f: int) -> int:
    """k as native takes it (at most F), or ValueError."""
    k = int(k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"shortlist_topk takes 1 <= k <= {MAX_K}, got {k}")
    return min(k, f)


def _check_inputs(queries, tri):
    check_tensor(queries, "queries", torch.float64, (None, 3))
    check_tensor(tri, "tri", torch.float64, (None, 9))
    if max(queries.shape[0], tri.shape[0]) >= 2 ** 31:
        raise ValueError("the kernels take fewer than 2^31 queries and faces")
    return kernel_device(queries, tri)


def shortlist_topk(queries: torch.Tensor, tri: torch.Tensor, k: int):
    """The k nearest faces of each query by exact point→triangle distance:
    queries [N, 3] and tri [F, 9] (corners a, b, c a row) float64
    contiguous, 1 ≤ k ≤ ``MAX_K`` (k above F takes F) → (idx [N, k] int32,
    d2 [N, k] float64), ascending by (d², face id); a NaN d² sorts after
    every number.

    Kernel K9 (``csrc/point_tri.cu``) replaces ``icp_shortlist_topk`` in
    ``icp_proposal_tpu/native/point_tri.cpp`` (host C++, not a Pallas
    kernel).  Bound by the cascade's float64 operations over the FP64
    rate: one block a query streams the faces through shared memory in
    tiles, and a bitonic sort of the running top-K with each tile keeps the
    best K."""
    dev = _check_inputs(queries, tri)
    if dev.type == "cpu":
        return shortlist_topk_plain(queries, tri, k)
    n, f = queries.shape[0], tri.shape[0]
    k = _check_k(k, f)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float64, device=dev)
    launch("icp_shortlist_topk", dev, queries.data_ptr(), tri.data_ptr(), idx.data_ptr(),
           d2.data_ptr(), n, f, k)
    shortlist_topk.launches += 1
    return idx, d2


shortlist_topk.launches = 0


def point_tri_d2(queries: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Exact point→triangle d² of every (query, face) pair: queries [N, 3],
    tri [F, 9] float64 contiguous → [N, F] float64.

    Kernel K10 (``csrc/point_tri.cu``) replaces ``icp_point_tri_d2`` in
    ``icp_proposal_tpu/native/point_tri.cpp``: one thread a pair, bound by
    the [N, F] store over HBM bandwidth or the cascade's FP64 operations."""
    dev = _check_inputs(queries, tri)
    if dev.type == "cpu":
        return point_tri_d2_plain(queries, tri)
    n, f = queries.shape[0], tri.shape[0]
    out = torch.empty((n, f), dtype=torch.float64, device=dev)
    launch("icp_point_tri_d2", dev, queries.data_ptr(), tri.data_ptr(), out.data_ptr(), n, f)
    point_tri_d2.launches += 1
    return out


point_tri_d2.launches = 0
