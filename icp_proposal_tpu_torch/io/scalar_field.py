"""Per-vertex scalar-field export (colour-mapped PLY), host numpy.

Copy of ``icp_proposal_tpu/io/scalar_field.py``: the headless replacement
for the reference's ``ScalarMeshField`` and ScalismoUI colour rendering
(``PosteriorVariabilityToMeshColor.scala:54-63``).  A field is written as an
ascii PLY with a perceptual vertex-colour ramp and the raw value per vertex
(``quality``).  Points, cells and values are converted to numpy (float32,
int64, float64) before formatting, so a CPU tensor writes the same bytes as
its array; a tensor on the card goes through ``.cpu()`` first.
"""
from __future__ import annotations

import numpy as np


def _colormap(t: np.ndarray) -> np.ndarray:
    """Simple perceptual ramp (dark blue → green → yellow), t in [0,1] → RGB u8."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(1.5 * t - 0.25, 0, 1)
    g = np.clip(1.5 * t, 0, 1) * (0.4 + 0.6 * t)
    b = np.clip(1.0 - 1.2 * t, 0, 1) * 0.9 + 0.1
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_scalar_field_ply(path, points, cells, values) -> None:
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells, np.int64)
    values = np.asarray(values, np.float64)
    vmin, vmax = float(values.min()), float(values.max())
    t = (values - vmin) / (vmax - vmin) if vmax > vmin else np.zeros_like(values)
    rgb = _colormap(t)

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"comment scalar range [{vmin}, {vmax}]\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("property float quality\n")
        f.write(f"element face {len(cells)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p, c, v in zip(points, rgb, values):
            f.write(
                f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} {v}\n"
            )
        for tri in cells:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
