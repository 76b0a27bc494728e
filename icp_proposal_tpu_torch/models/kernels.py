"""Matrix-valued covariance kernels for GPMM construction (host numpy).

Copy of the part of ``icp_proposal_tpu/models/kernels.py`` the femur
builder uses: Gaussian scalar kernels, diagonal lifting, constant-matrix
scaling, sums and scalar multiples.  A kernel is a callable
``k(x, y) -> [..., 3, 3]`` over broadcastable point arrays ``[..., 3]``,
evaluated in float64 on the host; only the resulting basis ships to the card.
"""
from __future__ import annotations

import numpy as np


class MatrixKernel:
    """Base: matrix-valued positive-definite kernel with operator algebra."""

    def __call__(self, x, y):  # pragma: no cover - interface
        raise NotImplementedError

    def __add__(self, other):
        return _Sum(self, other)

    def __mul__(self, scalar):
        return _Scaled(self, float(scalar))

    __rmul__ = __mul__


class _Sum(MatrixKernel):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, x, y):
        return self.a(x, y) + self.b(x, y)


class _Scaled(MatrixKernel):
    def __init__(self, k, s):
        self.k, self.s = k, s

    def __call__(self, x, y):
        return self.s * self.k(x, y)


class GaussianScalar:
    """k(x,y) = exp(−‖x−y‖²/σ²)."""

    def __init__(self, sigma: float):
        self.sigma2 = float(sigma) ** 2

    def __call__(self, x, y):
        d = np.asarray(x) - np.asarray(y)
        return np.exp(-np.sum(d * d, axis=-1) / self.sigma2)


class DiagonalKernel(MatrixKernel):
    """Scalar kernel lifted to k(x,y)·I₃."""

    def __init__(self, scalar_kernel, dim: int = 3):
        self.sk = scalar_kernel
        self.dim = dim

    def __call__(self, x, y):
        s = self.sk(x, y)
        return s[..., None, None] * np.eye(self.dim)


class ConstantMatrixKernel(MatrixKernel):
    """A·k(x,y) for a fixed 3×3 matrix A."""

    def __init__(self, matrix, scalar_kernel):
        self.a = np.asarray(matrix, dtype=np.float64)
        self.sk = scalar_kernel

    def __call__(self, x, y):
        s = self.sk(x, y)
        return s[..., None, None] * self.a
