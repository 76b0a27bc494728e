"""Landmark JSON IO (scalismo ``LandmarkIO`` format), host numpy.

Copy of ``icp_proposal_tpu/io/landmarks.py`` (reference call sites
``apps/femur/LoadTestData.scala:38,43``).  Format: a JSON array of objects
with "id" and "coordinates" (3 floats); extra keys (e.g. "uncertainty") are
ignored.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np


def read_landmarks(path) -> Dict[str, np.ndarray]:
    """→ ordered dict name → [3] float64 coordinates."""
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for entry in data:
        out[entry["id"]] = np.asarray(entry["coordinates"], dtype=np.float64)
    return out


def write_landmarks(path, landmarks: Dict[str, np.ndarray]) -> None:
    data = [
        {"id": name, "coordinates": [float(x) for x in np.asarray(pt)]}
        for name, pt in landmarks.items()
    ]
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def common_landmarks(
    a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Intersect landmark sets by name, preserving ``a``'s order (reference
    ``AlignmentTransforms.scala:27-28``) → (points_a [N, 3], points_b [N, 3],
    names)."""
    names = [n for n in a if n in b]
    pa = np.stack([a[n] for n in names])
    pb = np.stack([b[n] for n in names])
    return pa, pb, names
