"""Registration quality reporting.

Counterpart of ``icp_proposal_tpu/registration/comparison.py`` (reference
``RegistrationComparison.scala:24-49``); the distances go through K5.
"""
from __future__ import annotations

from icp_proposal_tpu_torch.mesh import TriangleMesh
from icp_proposal_tpu_torch.ops.metrics import (
    avg_and_max_distance_boundary_aware,
    avg_distance,
    hausdorff_distance,
)


def evaluate_reconstruction(tag: str, reconstruction: TriangleMesh,
                            ground_truth: TriangleMesh, verbose=True, device=None):
    """Average distance to the surface and Hausdorff distance to the ground
    truth (reference :24-29) → (avg, hausdorff) as floats."""
    avg = float(avg_distance(reconstruction, ground_truth, device))
    hd = float(hausdorff_distance(reconstruction, ground_truth, device))
    if verbose:
        print(f"ID: {tag} average2surface: {avg} hausdorff: {hd}")
    return avg, hd


def evaluate_reconstruction_boundary_aware(tag: str, reconstruction: TriangleMesh,
                                           ground_truth: TriangleMesh, gt_boundary_mask,
                                           verbose=True, device=None):
    """The boundary-aware (avg, max) variant (reference :31-48)."""
    avg, mx = avg_and_max_distance_boundary_aware(reconstruction, ground_truth,
                                                  gt_boundary_mask, device)
    avg, mx = float(avg), float(mx)
    if verbose:
        print(f"ID: {tag} average2surface: {avg} max: {mx}")
    return avg, mx
