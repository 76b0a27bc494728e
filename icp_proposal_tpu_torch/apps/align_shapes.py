"""Dataset preparation: rigid alignment of scan meshes to a reference (host
numpy).

Counterpart of ``icp_proposal_tpu/apps/align_shapes.py`` (reference
``apps/femur/AlignShapes.scala:27-56``: align every mesh and its landmarks
to the model's reference landmarks and write an ``aligned/`` tree; the
alignment half of ``apps/bfm/AlignShapes.scala``).  Runs on any directory
of (mesh, landmark JSON) pairs.

    python -m icp_proposal_tpu_torch.apps.align_shapes MESH_DIR LANDMARK_DIR \\
        REFERENCE_LANDMARKS OUT_DIR [--scale S]
"""
from __future__ import annotations

import os

import numpy as np

from icp_proposal_tpu_torch.io.landmarks import (
    common_landmarks,
    read_landmarks,
    write_landmarks,
)
from icp_proposal_tpu_torch.ops.rigid import rigid_landmark_alignment


def _read_mesh_any(path):
    from icp_proposal_tpu_torch.io.ply import read_ply
    from icp_proposal_tpu_torch.io.stl import read_stl

    if path.lower().endswith(".ply"):
        return read_ply(path)
    return read_stl(path)


def align_shapes(
    mesh_dir: str,
    landmark_dir: str,
    reference_landmarks_path: str,
    out_dir: str,
    scale: float = 1.0,
    verbose: bool = True,
) -> int:
    """Align every ``.stl`` or ``.ply`` mesh in ``mesh_dir`` to the reference
    landmarks by its own landmarks in ``landmark_dir`` (matched by basename;
    a mesh without them is skipped), after scaling both by ``scale``; write
    the aligned meshes (binary STL) and landmarks under
    ``out_dir/{meshes,landmarks}``.  Returns the number aligned."""
    from icp_proposal_tpu_torch.io.stl import write_stl

    model_lms = read_landmarks(reference_landmarks_path)
    meshes_out = os.path.join(out_dir, "meshes")
    lms_out = os.path.join(out_dir, "landmarks")
    os.makedirs(meshes_out, exist_ok=True)
    os.makedirs(lms_out, exist_ok=True)

    count = 0
    for fname in sorted(os.listdir(mesh_dir)):
        if not fname.lower().endswith((".stl", ".ply")):
            continue
        base = os.path.splitext(fname)[0]
        lm_path = os.path.join(landmark_dir, base + ".json")
        if not os.path.exists(lm_path):
            if verbose:
                print(f"skipping {fname}: no landmarks at {lm_path}")
            continue
        points, cells = _read_mesh_any(os.path.join(mesh_dir, fname))
        lms = read_landmarks(lm_path)
        if scale != 1.0:
            points = points * scale
            lms = {k: v * scale for k, v in lms.items()}
        src, dst, _ = common_landmarks(lms, model_lms)
        t = rigid_landmark_alignment(src, dst, center=np.zeros(3))
        aligned = t.apply(points.astype(np.float32))
        aligned_lms = {k: t.apply(v[None, :].astype(np.float32))[0]
                       for k, v in lms.items()}
        write_stl(os.path.join(meshes_out, base + ".stl"), aligned, cells)
        write_landmarks(os.path.join(lms_out, base + ".json"), aligned_lms)
        count += 1
        if verbose:
            print(f"aligned {fname}")
    return count


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Rigid landmark alignment of a dataset")
    p.add_argument("mesh_dir")
    p.add_argument("landmark_dir")
    p.add_argument("reference_landmarks")
    p.add_argument("out_dir")
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    align_shapes(args.mesh_dir, args.landmark_dir, args.reference_landmarks,
                 args.out_dir, scale=args.scale)


if __name__ == "__main__":
    main()
