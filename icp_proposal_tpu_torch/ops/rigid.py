"""Closed-form rigid landmark alignment (Kabsch, no scaling).

Copy of ``icp_proposal_tpu/ops/rigid.py``: scalismo's
``LandmarkRegistration.rigid3DLandmarkRegistration`` (reference
``apps/util/AlignmentTransforms.scala:29``), which ``LoadTestData`` uses to
align the target to the model frame at load time.  Computed on the host in
float64, stored float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _like(x: np.ndarray, points):
    """``x`` as a tensor beside ``points`` when ``points`` is a tensor."""
    if isinstance(points, torch.Tensor):
        return torch.as_tensor(x, dtype=points.dtype, device=points.device)
    return x


class RigidTransform(NamedTuple):
    """x ↦ R (x − center) + center + t: rotation about ``center``, then
    translation (the reference's TranslationAfterRotation,
    ``ModelFittingParameters.scala:79-86``).  Fields are float32 numpy
    arrays; ``apply`` and ``inverse_apply`` take numpy arrays or tensors
    [..., 3] and return the same kind."""

    rotation: np.ndarray  # [3, 3]
    translation: np.ndarray  # [3]
    center: np.ndarray  # [3]

    def apply(self, points):
        r, t, c = (_like(x, points) for x in self)
        return (points - c) @ r.T + c + t

    def inverse_apply(self, points):
        r, t, c = (_like(x, points) for x in self)
        return (points - c - t) @ r + c


def rigid_landmark_alignment(source, target, center=None) -> RigidTransform:
    """Least-squares rigid transform mapping the source landmarks [N, 3]
    onto the target landmarks [N, 3], rotating about ``center`` (default
    the origin, as the reference passes, ``LoadTestData.scala:45``)."""
    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)

    mu_s = source.mean(axis=0)
    mu_t = target.mean(axis=0)
    h = (source - mu_s).T @ (target - mu_t)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    # target ≈ R(source − c) + c + t
    t = mu_t - (r @ (mu_s - center) + center)
    return RigidTransform(rotation=r.astype(np.float32), translation=t.astype(np.float32),
                          center=center.astype(np.float32))
