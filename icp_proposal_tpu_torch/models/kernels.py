"""Matrix-valued covariance kernels for GPMM construction (host numpy).

Copy of the part of ``icp_proposal_tpu/models/kernels.py`` the femur and
face model constructions use: Gaussian and cubic B-spline scalar kernels, diagonal
lifting, constant-matrix scaling, spatial weighting, mirroring, sums and
scalar multiples.  A kernel is a callable
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


class BSplineScalar:
    """scalismo-faces ``BSplineKernel(scale=2^j)`` per dimension:
    k_j(x, y) = Π_d Σ_k β₃(x_d/2^j − k) β₃(y_d/2^j − k) · 2^j

    (sum over integer shifts of cubic B-splines at dyadic scale j; compact
    support makes the shift sum finite).  Used by the face prior
    (``apps/bfm/FaceKernel.scala:30-44``).
    """

    def __init__(self, j: int):
        self.j = int(j)
        self.scale = 2.0 ** j

    @staticmethod
    def _b3(u):
        """Cubic B-spline β₃ with support [−2, 2]."""
        u = np.abs(u)
        out = np.zeros_like(u)
        m1 = u < 1.0
        m2 = (u >= 1.0) & (u < 2.0)
        out = np.where(m1, 2.0 / 3.0 - u * u + 0.5 * u ** 3, out)
        out = np.where(m2, ((2.0 - u) ** 3) / 6.0, out)
        return out

    def _corr_1d(self, u, v):
        """Σ_k β₃(u−k) β₃(v−k) — finite sum over the overlapping support."""
        lo = np.floor(np.minimum(u, v)).astype(np.int64) - 2
        acc = np.zeros(np.broadcast(u, v).shape)
        for off in range(6):
            k = lo + off
            acc = acc + self._b3(u - k) * self._b3(v - k)
        return acc

    def __call__(self, x, y):
        x = np.asarray(x) / self.scale
        y = np.asarray(y) / self.scale
        out = np.ones(np.broadcast(x[..., 0], y[..., 0]).shape)
        for d in range(x.shape[-1]):
            out = out * self._corr_1d(x[..., d], y[..., d])
        return out


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


class SpatiallyWeightedKernel(MatrixKernel):
    """w(x)·w(y)·k(x,y): region-weighted kernels (the face prior's smoothed
    region masks, ``FaceKernel.scala:63-68``).  ``weight_fn(points)->[...]``."""

    def __init__(self, weight_fn, inner: MatrixKernel):
        self.weight_fn = weight_fn
        self.inner = inner

    def __call__(self, x, y):
        wx = np.asarray(self.weight_fn(x))
        wy = np.asarray(self.weight_fn(y))
        return (wx * wy)[..., None, None] * self.inner(x, y)


class MirroredKernel(MatrixKernel):
    """Symmetrized kernel about the x=0 plane:
    k_sym(x,y) = k(x,y) + J k(Jx, y)ᵀ... — implemented as the reference's
    face-prior blend helper (``FaceKernel.scala:72-105``): the mirrored term
    flips the x axis of both the input point and the output displacement:

        k_mirror(x, y) = J · k(mirror(x), mirror(y)) · J,  J = diag(−1, 1, 1)
    """

    def __init__(self, inner: MatrixKernel):
        self.inner = inner
        self.j = np.diag([-1.0, 1.0, 1.0])

    def __call__(self, x, y):
        xm = np.asarray(x) * np.array([-1.0, 1.0, 1.0])
        ym = np.asarray(y) * np.array([-1.0, 1.0, 1.0])
        inner = self.inner(xm, ym)
        return self.j @ inner @ self.j
