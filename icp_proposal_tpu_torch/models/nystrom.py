"""Nyström low-rank GP approximation (host numpy, float64).

Copy of ``icp_proposal_tpu/models/nystrom.py``'s ``nystrom_lowrank`` and
``total_variance_estimate``:

    K_nn = U Λ Uᵀ on n sampled points,  λ_i = Λ_i / n,
    φ_i(x) = (√n / Λ_i) · K(x, X) u_i
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def kernel_matrix(kernel, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Dense [3m, 3n] kernel matrix between point sets, in row blocks on
    one thread per CPU (numpy's elementwise work releases the GIL).  Every
    entry depends on its own pair only, so the blocking changes no value."""
    m, n = len(xs), len(ys)
    out = np.empty((m, 3, n, 3))
    workers = os.cpu_count() or 1
    block = max(1, min(int(2e7 // (n * 9)), -(-m // workers)))

    def fill(i0):
        i1 = min(i0 + block, m)
        out[i0:i1] = np.transpose(
            kernel(xs[i0:i1, None, :], ys[None, :, :]), (0, 2, 1, 3)
        )

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(0, m, block)))
    return out.reshape(3 * m, 3 * n)


def nystrom_lowrank(kernel, sample_points: np.ndarray, eval_points: np.ndarray,
                    num_basis: int, jitter: float = 1e-10):
    """→ (basis [V, 3, k], variance [k]), eigenvalues descending."""
    n = len(sample_points)
    k_nn = kernel_matrix(kernel, sample_points, sample_points)
    k_nn = 0.5 * (k_nn + k_nn.T) + jitter * np.eye(3 * n)
    evals, evecs = np.linalg.eigh(k_nn)
    order = np.argsort(evals)[::-1]
    num_basis = min(num_basis, 3 * n)
    evals = np.maximum(evals[order][:num_basis], 1e-12)
    evecs = evecs[:, order][:, :num_basis]

    k_vn = kernel_matrix(kernel, eval_points, sample_points)  # [3V, 3n]
    basis = (k_vn @ evecs) * (np.sqrt(n) / evals)[None, :]  # [3V, k]
    variance = evals / n
    v = len(eval_points)
    return basis.reshape(v, 3, num_basis), variance


def total_variance_estimate(kernel, points: np.ndarray) -> float:
    """Mean trace of the kernel at the points (the model-building
    variance-capture diagnostic, reference ``CreateGPModel.scala:38-46,95-98``)."""
    kxx = kernel(points, points)  # [N, 3, 3]
    return float(np.trace(kxx, axis1=-2, axis2=-1).mean())
