"""STL mesh reader (binary and ASCII) with vertex welding, and the binary
writer.

numpy copy of ``icp_proposal_tpu/io/stl.py``: STL stores a triangle soup;
exactly coincident vertices are welded to recover the shared topology that
vertex normals, boundary masks and GPMM vertex ids need.
"""
from __future__ import annotations

import struct

import numpy as np


def _weld(tri_vertices: np.ndarray):
    """tri_vertices [F*3, 3] → (points [V,3], cells [F,3]) by exact matching."""
    v = np.ascontiguousarray(tri_vertices, dtype=np.float32)
    flat = v.view([("", v.dtype)] * 3).ravel()
    _, first_idx, inverse = np.unique(flat, return_index=True, return_inverse=True)
    # first-appearance vertex order
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    points = v[np.sort(first_idx)]
    cells = rank[inverse].reshape(-1, 3).astype(np.int32)
    return points, cells


def read_stl(path):
    """Read an STL file → (points [V,3] f32, cells [F,3] i32)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            data = f.read()
            try:
                text = data.decode("ascii")
                if "facet" in text:
                    return _read_ascii(text)
            except UnicodeDecodeError:
                pass
        return _read_binary(f)


def _read_binary(f):
    f.seek(80)
    (n_tri,) = struct.unpack("<I", f.read(4))
    raw = np.fromfile(f, dtype=np.uint8, count=n_tri * 50)
    rec = raw.reshape(n_tri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 12)
    tri = floats[:, 3:12].reshape(n_tri * 3, 3)
    return _weld(tri)


def _read_ascii(text):
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    tri = np.asarray(verts, dtype=np.float32)
    if tri.shape[0] % 3 != 0:
        raise ValueError("malformed ASCII STL: vertex count not divisible by 3")
    return _weld(tri)


def write_stl(path, points, cells):
    """Write a binary STL: unit face normals, then the three corners, per
    face (host arrays; tensors go through ``.cpu().numpy()`` first)."""
    points = np.asarray(points, dtype=np.float32)
    cells = np.asarray(cells, dtype=np.int32)
    n_tri = len(cells)
    tri = points[cells]  # [F, 3, 3]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n_tri))
        rec = np.zeros((n_tri, 50), dtype=np.uint8)
        floats = np.concatenate([n, tri.reshape(n_tri, 9)], axis=1).astype("<f4")
        rec[:, :48] = floats.view(np.uint8).reshape(n_tri, 48)
        rec.tofile(f)
