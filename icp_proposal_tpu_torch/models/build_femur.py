"""Femur GPMM construction (offline model building, host numpy).

Copy of ``icp_proposal_tpu/models/build_femur.py``: the analytic
anisotropic multi-scale Gaussian kernel plus Nyström,

    A = U · diag(10, 1, 1) · Uᵀ   (U = principal axes of the reference mesh)
    k(x,y) = A·Gauss(90)(x,y)·10 + I·Gauss(40)(x,y)·5 + I·Gauss(10)(x,y)·3

The basis is computed in float64 on the host and the model's tensors are
placed on the requested device.
"""
from __future__ import annotations

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.models.kernels import (
    ConstantMatrixKernel,
    DiagonalKernel,
    GaussianScalar,
)
from icp_proposal_tpu_torch.models.nystrom import nystrom_lowrank, total_variance_estimate


def main_variance_axes(points: np.ndarray) -> np.ndarray:
    """Principal axes of the vertex cloud."""
    pts = np.asarray(points, np.float64)
    centered = pts - pts.mean(axis=0)
    cov = centered.T @ centered / len(pts)
    u, _, _ = np.linalg.svd(cov)
    return u


def femur_kernel(ref_points: np.ndarray):
    u = main_variance_axes(ref_points)
    base_matrix = u @ np.diag([10.0, 1.0, 1.0]) @ u.T
    return (
        ConstantMatrixKernel(base_matrix, GaussianScalar(90.0)) * 10.0
        + DiagonalKernel(GaussianScalar(40.0)) * 5.0
        + DiagonalKernel(GaussianScalar(10.0)) * 3.0
    )


def build_femur_gpmm(ref_points, ref_cells, num_components: int,
                     seed: int = 1024, device=DEFAULT_DEVICE):
    """→ ``Gpmm`` with ``num_components + 1`` basis functions, on ``device``
    (the card unless ``device="cpu"``)."""
    from icp_proposal_tpu_torch.models.gpmm import make_gpmm
    from icp_proposal_tpu_torch.ops.surface_sampling import (
        area_weighted_vertex_subset,
    )

    device = resolve_device(device)
    kernel = femur_kernel(ref_points)
    n_sample = min(num_components * 2, len(ref_points))
    sample_ids = area_weighted_vertex_subset(ref_points, ref_cells, n_sample, seed)
    basis, variance = nystrom_lowrank(
        kernel,
        np.asarray(ref_points, np.float64)[sample_ids],
        np.asarray(ref_points, np.float64),
        num_basis=num_components + 1,
    )
    return make_gpmm(
        ref_points=ref_points,
        cells=ref_cells,
        mean_disp=np.zeros_like(ref_points),
        basis=basis,
        variance=variance,
        noise_variance=0.0,
        device=device,
    )


def variance_capture_ratio(kernel, ref_points, variance) -> float:
    """Share of the kernel's total variance that the basis ``variance``
    captures."""
    total = total_variance_estimate(kernel, np.asarray(ref_points, np.float64))
    return float(np.sum(variance) / total)
