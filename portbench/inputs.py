"""The cell's inputs: model arrays and target mesh, made from the
configuration's file alone.

A configuration names a model ``builder``:

* ``femur-standin``: a femur GPMM on the mesh ``model_mesh`` with the
  anisotropic multi-scale Gaussian kernel of the reference's femur model
  (A·g90·10 + I·g40·5 + I·g10·3, A = U diag(10, 1, 1) Uᵀ over the principal
  axes), low-rank by Nyström over ``nystrom_points`` area-weighted
  vertices; target ``target_mesh``.
* ``face-standin``: the open icosphere patch (``subdivisions``,
  ``radius_mm``, the cap above z = ``z_cut``·radius cut away) with the
  multiscale B-spline face kernel (levels −6…−2, scales 128…4, in mm as
  the BFM's, so the patch has a face's size in the kernel's units;
  0.7 mirrored + 0.3 plain, trivial region masks),
  Nyström over 4·rank area-weighted vertices; the target is the model's
  instance at ``target_scale`` times standard normals (RandomState
  ``target_seed``), with the V // 6 vertices nearest its highest point cut
  away.

The kernel matrices and the eigen-decomposition run on ``device`` in
float64; the subsets and meshes are host numpy.  The arrays are the same
for every seed: they are the deployment, as a model file and a scan would
be.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def read_stl(path):
    """Binary STL → (points [V, 3] float32, cells [F, 3] int32), exactly
    coincident corners welded, vertices in order of first appearance."""
    with open(path, "rb") as f:
        f.seek(80)
        (n,) = struct.unpack("<I", f.read(4))
        rec = np.fromfile(f, dtype=np.uint8, count=50 * n).reshape(n, 50)
    corners = np.ascontiguousarray(rec[:, 12:48].copy().view("<f4").reshape(3 * n, 3))
    flat = corners.view([("", corners.dtype)] * 3).ravel()
    _, first, inverse = np.unique(flat, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return corners[np.sort(first)], rank[inverse].reshape(-1, 3).astype(np.int32)


def area_weighted_subset(points, cells, n: int, seed: int) -> np.ndarray:
    """n vertex ids drawn without replacement, weighted by one third of the
    area of the faces around each vertex (RandomState ``seed``)."""
    pts = np.asarray(points, np.float64)
    tri = pts[np.asarray(cells)]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                                axis=-1)
    w = np.zeros(len(pts))
    for k in range(3):
        np.add.at(w, np.asarray(cells)[:, k], area / 3.0)
    n = min(n, len(pts))
    ids = np.random.RandomState(seed).choice(len(pts), size=n, replace=False,
                                             p=w / w.sum())
    return np.sort(ids)


def nystrom(kernel, samples, points, rank: int):
    """(basis [V, 3, rank], variance [rank]) of the matrix kernel
    ``kernel(x [..., 3], y [..., 3]) → [..., 3, 3]``: K_nn = UΛUᵀ over the n
    samples, λᵢ = Λᵢ/n, φᵢ(x) = (√n/Λᵢ) K(x, X) uᵢ."""
    n = samples.shape[0]

    def matrix(xs, ys):
        rows = []
        for lo in range(0, xs.shape[0], 256):
            k = kernel(xs[lo:lo + 256, None, :], ys[None, :, :])  # [a, b, 3, 3]
            rows.append(k.permute(0, 2, 1, 3).reshape(-1, 3 * ys.shape[0]))
        return torch.cat(rows)

    k_nn = matrix(samples, samples)
    k_nn = 0.5 * (k_nn + k_nn.T) + 1e-10 * torch.eye(3 * n, dtype=k_nn.dtype,
                                                     device=k_nn.device)
    evals, evecs = torch.linalg.eigh(k_nn)
    evals, evecs = evals.flip(0)[:rank].clamp_min(1e-12), evecs.flip(1)[:, :rank]
    basis = (matrix(points, samples) @ evecs) * (n ** 0.5 / evals)[None, :]
    return basis.reshape(points.shape[0], 3, rank), evals / n


def _gauss(sigma):
    return lambda d2: torch.exp(-d2 / sigma ** 2)


def femur_kernel(ref):
    centered = ref - ref.mean(0)
    u, _, _ = torch.linalg.svd(centered.T @ centered / ref.shape[0])
    a = u @ torch.diag(torch.tensor([10.0, 1.0, 1.0], dtype=ref.dtype,
                                    device=ref.device)) @ u.T
    eye = torch.eye(3, dtype=ref.dtype, device=ref.device)

    def k(x, y):
        d2 = ((x - y) ** 2).sum(-1)[..., None, None]
        return a * _gauss(90.0)(d2) * 10.0 + eye * _gauss(40.0)(d2) * 5.0 \
            + eye * _gauss(10.0)(d2) * 3.0
    return k


LEVELS = ((-6, 128.0), (-5, 64.0), (-4, 32.0), (-3, 10.0), (-2, 4.0))


def _b3(u):
    u = u.abs()
    return torch.where(u < 1, 2.0 / 3.0 - u * u + 0.5 * u ** 3,
                       torch.where(u < 2, (2.0 - u) ** 3 / 6.0, torch.zeros_like(u)))


def _bspline(x, y, level):
    """Π_d Σ_k β₃(x_d·2^l − k) β₃(y_d·2^l − k), the sum over the shifts
    whose supports overlap."""
    xs, ys = x * 2.0 ** level, y * 2.0 ** level
    lo = torch.floor(torch.minimum(xs, ys)) - 2
    acc = 0
    for off in range(6):
        acc = acc + _b3(xs - (lo + off)) * _b3(ys - (lo + off))
    return acc.prod(-1)


def face_kernel(x, y):
    """base(x, y)·I + 0.7·diag(−1, 1, 1)·base(x, ȳ), ȳ = y mirrored in x:
    0.7·symmetrised + 0.3·plain of the multiscale B-spline base kernel with
    every region weight 1."""
    mirror = torch.tensor([-1.0, 1.0, 1.0], dtype=x.dtype, device=x.device)

    def base(a, b):
        return sum(scale * _bspline(a, b, level) for level, scale in LEVELS)

    plain = base(x, y)[..., None, None] * torch.eye(3, dtype=x.dtype, device=x.device)
    return plain + 0.7 * base(x, y * mirror)[..., None, None] * torch.diag(mirror)


def icosphere(subdivisions: int, radius: float):
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
             [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
             [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
             [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
             [8, 6, 7], [9, 8, 1]]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        mid, new = {}, []

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new
    return (np.asarray(verts) * radius).astype(np.float32), np.asarray(faces, np.int64)


def keep_vertices(points, cells, keep):
    """The mesh without the vertices not in ``keep`` and their faces."""
    cells = cells[keep[cells].all(axis=1)]
    used = np.unique(cells)
    remap = -np.ones(len(points), np.int64)
    remap[used] = np.arange(len(used))
    return points[used], remap[cells].astype(np.int32)


def make_inputs(config: dict, device) -> dict:
    """Host arrays ``ref_points``, ``cells``, ``mean``, ``basis``,
    ``variance``, ``target_points``, ``target_cells`` of a configuration."""
    model = config["model"]
    rank = int(config["rank"])
    f64 = dict(dtype=torch.float64, device=device)
    if model["builder"] == "femur-standin":
        ref, cells = read_stl(HERE / model["model_mesh"])
        tgt, tcells = read_stl(HERE / model["target_mesh"])
        ref_t = torch.as_tensor(ref, **f64)
        ids = area_weighted_subset(ref, cells, int(model["nystrom_points"]),
                                   int(model["nystrom_seed"]))
        basis, var = nystrom(femur_kernel(ref_t), ref_t[ids], ref_t, rank)
    elif model["builder"] == "face-standin":
        radius = float(model["radius_mm"])
        pts, cls = icosphere(int(model["subdivisions"]), radius)
        ref, cells = keep_vertices(pts, cls, pts[:, 2] < float(model["z_cut"]) * radius)
        ref_t = torch.as_tensor(ref, **f64)
        ids = area_weighted_subset(ref, cells, min(4 * rank, len(ref)),
                                   int(model["nystrom_seed"]))
        basis, var = nystrom(face_kernel, ref_t[ids], ref_t, rank)
        alpha = np.random.RandomState(int(model["target_seed"])).randn(rank)
        alpha = torch.as_tensor(alpha * float(model["target_scale"]), **f64)
        q = basis * torch.sqrt(var)[None, None, :]
        full = (ref_t + (q.reshape(-1, rank) @ alpha).reshape(-1, 3)).cpu().numpy()
        full = full.astype(np.float32)
        nose = full[np.argmax(full[:, 2])]
        cut = np.argsort(((full - nose) ** 2).sum(-1))[: len(full) // 6]
        keep = np.ones(len(full), bool)
        keep[cut] = False
        tgt, tcells = keep_vertices(full, cells, keep)
    else:
        raise ValueError(f"unknown model builder {model['builder']!r}")
    return dict(ref_points=ref, cells=np.asarray(cells, np.int32),
                mean=np.zeros_like(ref), basis=basis.cpu().numpy(),
                variance=var.cpu().numpy(), target_points=tgt,
                target_cells=np.asarray(tcells, np.int32))
