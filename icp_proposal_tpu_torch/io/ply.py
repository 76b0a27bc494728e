"""PLY mesh IO (ascii and binary little-endian), host numpy.

Copy of ``icp_proposal_tpu/io/ply.py``: replaces ``scalismo.faces.io.MeshIO``
for the BFM scan assets (reference call site ``apps/bfm/AlignShapes.scala:76``).
Reads vertex x/y/z (other properties are skipped) and triangular faces
(quads are split); writes ascii.  Arrays in and out are numpy; a tensor goes
through ``.cpu().numpy()`` first.
"""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def read_ply(path):
    """→ (points [V,3] f32, cells [F,3] i32)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))

        elements = []  # (name, count, [properties])
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property" and elements:
                elements[-1][2].append(parts[1:])

        points, cells = None, None
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    idx = [i for i, p in enumerate(props) if p[-1] in ("x", "y", "z")]
                    points = np.array(
                        [[float(r[i]) for i in idx] for r in rows], np.float32
                    )
                elif name == "face":
                    cells = np.array(
                        [[int(x) for x in r[1:4]] for r in rows], np.int32
                    )
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if name == "vertex":
                    dtype = np.dtype(
                        [(f"p{i}", "<" + _PLY_TYPES[p[0]][0]) for i, p in enumerate(props)]
                    )
                    data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
                    cols = [i for i, p in enumerate(props) if p[-1] in ("x", "y", "z")]
                    points = np.stack(
                        [data[f"p{i}"].astype(np.float32) for i in cols], axis=1
                    )
                elif name == "face":
                    # assume single list property (count_type, index_type)
                    lp = props[0]
                    ct, cs = _PLY_TYPES[lp[1]]
                    it, isz = _PLY_TYPES[lp[2]]
                    faces = []
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cs), dtype="<" + ct)[0])
                        idx = np.frombuffer(f.read(isz * n), dtype="<" + it)
                        if n == 3:
                            faces.append(idx)
                        elif n == 4:  # split quads
                            faces.append(idx[[0, 1, 2]])
                            faces.append(idx[[0, 2, 3]])
                    cells = np.asarray(faces, np.int32)
                else:
                    # skip unknown fixed-size element
                    row = sum(_PLY_TYPES[p[0]][1] for p in props)
                    f.read(row * count)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    if points is None:
        raise ValueError("PLY file has no vertex element")
    return points, (cells if cells is not None else np.zeros((0, 3), np.int32))


def write_ply(path, points, cells) -> None:
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells, np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(cells)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for c in cells:
            f.write(f"3 {c[0]} {c[1]} {c[2]}\n")
