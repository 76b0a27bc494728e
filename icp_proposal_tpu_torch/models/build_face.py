"""Face GPMM construction: region masks and the multiscale B-spline face
prior (host numpy).

Copy of ``FaceMask``, ``SpatiallyVaryingMultiscaleKernel`` and ``FaceKernel``
from ``icp_proposal_tpu/models/build_face.py`` (reference
``apps/bfm/FaceMask.scala:26-56``, ``apps/bfm/FaceKernel.scala:26-114``):

    base(x,y)  = Σ_levels scale_l · w_l(x) · w_l(y) · I₃ ·
                 bspline3(2^l·x, 2^l·y)          levels −6…−2, scales 128…4
    k          = 0.7·symmetrize(base) + 0.3·base
    symmetrize = I·base(x,y) + diag(−1,1,1)·base(x, mirror_x(y))

``FaceKernel`` evaluates base(x, y) once per call where the reference
evaluates it twice; the values are the same.  ``build_face_gpmm`` is the
reference's model builder (``bfm/CreateGPModel.scala:32-65``); the
synthetic face stand-in (``apps/bfm.load_synthetic_face_data``) builds its
model directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.models.kernels import BSplineScalar, MatrixKernel

LEVELS_WITH_SCALE: Tuple[Tuple[int, float], ...] = (
    (-6, 128.0),
    (-5, 64.0),
    (-4, 32.0),
    (-3, 10.0),
    (-2, 4.0),
)


@dataclass
class FaceMask:
    """Integer level/semantic masks over reference-mesh vertices (reference
    uses constant all-3 masks in the production model build,
    ``bfm/CreateGPModel.scala:48-51``)."""

    level_mask: np.ndarray  # [V] int
    semantic_mask: np.ndarray  # [V] int

    @staticmethod
    def trivial(num_points: int, value: int = 3) -> "FaceMask":
        m = np.full(num_points, value, dtype=np.int64)
        return FaceMask(level_mask=m.copy(), semantic_mask=m)

    def is_nose_region(self, vid: int) -> bool:
        return int(self.semantic_mask[vid]) == 3

    def is_ear_region(self, vid: int) -> bool:
        return int(self.semantic_mask[vid]) == 3

    def is_lip_point(self, vid: int) -> bool:
        return int(self.semantic_mask[vid]) == 3

    def smoothed_region_weights(
        self, points: np.ndarray, level: int, stddev: float = 40.0
    ) -> np.ndarray:
        """[V] weight in [0,1]: Gaussian(σ)(‖p − nearest region point‖)
        (reference ``computeSmoothedRegions``, memoized per vertex — here a
        vectorized precomputation)."""
        region = points[self.level_mask >= level]
        if len(region) == 0:
            return np.zeros(len(points))
        # nearest region point per vertex (blocked pairwise distances)
        out = np.empty(len(points))
        block = max(1, int(5e6 // max(len(region), 1)))
        for i0 in range(0, len(points), block):
            i1 = min(i0 + block, len(points))
            d2 = np.sum(
                (points[i0:i1, None, :] - region[None, :, :]) ** 2, axis=-1
            )
            out[i0:i1] = d2.min(axis=1)
        return np.exp(-out / (stddev * stddev))


class SpatiallyVaryingMultiscaleKernel(MatrixKernel):
    """Σ_l scale_l · w_l(x)w_l(y) · bspline(2^l x, 2^l y) · I₃.

    Region weights are precomputed per reference vertex; off-vertex inputs
    use the nearest reference vertex's weight (matching the reference's
    memoized nearest-point lookup).
    """

    def __init__(self, levels_with_scale, mask: FaceMask, ref_points: np.ndarray,
                 smooth_stddev: float = 40.0):
        self.levels_with_scale = tuple(levels_with_scale)
        self.ref_points = np.asarray(ref_points, np.float64)
        self.weights: Dict[int, np.ndarray] = {
            level: mask.smoothed_region_weights(self.ref_points, level, smooth_stddev)
            for level, _ in self.levels_with_scale
        }
        self.bsplines = {
            level: BSplineScalar(j=-level) for level, _ in self.levels_with_scale
        }

    def _weight_at(self, level: int, x: np.ndarray) -> np.ndarray:
        flat = np.asarray(x, np.float64).reshape(-1, 3)
        out = np.empty(len(flat))
        block = max(1, int(5e6 // max(len(self.ref_points), 1)))
        for i0 in range(0, len(flat), block):
            i1 = min(i0 + block, len(flat))
            d2 = np.sum(
                (flat[i0:i1, None, :] - self.ref_points[None, :, :]) ** 2, axis=-1
            )
            out[i0:i1] = self.weights[level][np.argmin(d2, axis=1)]
        return out.reshape(np.asarray(x).shape[:-1])

    def __call__(self, x, y):
        shape = np.broadcast(np.asarray(x)[..., 0], np.asarray(y)[..., 0]).shape
        acc = np.zeros(shape)
        for level, scale in self.levels_with_scale:
            wx = self._weight_at(level, x)
            wy = self._weight_at(level, y)
            # bspline kernel on 2^level-scaled coordinates:
            # BSplineScalar(j=-level) divides by 2^{-level} ≡ multiplies by 2^level
            k = self.bsplines[level](x, y)
            acc = acc + scale * wx * wy * k
        return acc[..., None, None] * np.eye(3)


class FaceKernel(MatrixKernel):
    """0.7·symmetrized + 0.3·asymmetric face prior (reference
    ``FaceKernel.scala:26-58``)."""

    def __init__(self, mask: FaceMask, ref_points: np.ndarray,
                 levels_with_scale=LEVELS_WITH_SCALE):
        self.base = SpatiallyVaryingMultiscaleKernel(levels_with_scale, mask, ref_points)
        self._jbar = np.diag([-1.0, 1.0, 1.0])

    def __call__(self, x, y):
        base = self.base(x, y)
        ybar = np.asarray(y) * np.array([-1.0, 1.0, 1.0])
        symmetrized = base + np.einsum("ij,...jk->...ik", self._jbar, self.base(x, ybar))
        return 0.7 * symmetrized + 0.3 * base


def build_face_gpmm(
    ref_points,
    ref_cells,
    num_components: int = 200,
    num_sample_points: int = 800,
    decimate_to: int | None = 2000,
    seed: int = 1024,
    device=DEFAULT_DEVICE,
):
    """The face model builder (reference ``bfm/CreateGPModel.scala:32-65``):
    decimate the reference mesh to ``decimate_to`` vertices (None keeps it),
    trivial all-3 masks, ``FaceKernel``, Nyström over ``num_sample_points``
    area-weighted vertices (``seed``) with ``num_components`` basis
    functions, zero mean.  Built in float64 on the host, the model's tensors
    on ``device`` (the card unless ``device="cpu"``)."""
    from icp_proposal_tpu_torch.models.gpmm import make_gpmm
    from icp_proposal_tpu_torch.models.nystrom import nystrom_lowrank
    from icp_proposal_tpu_torch.ops.decimate import decimate
    from icp_proposal_tpu_torch.ops.surface_sampling import area_weighted_vertex_subset

    device = resolve_device(device)  # before the host build, not after
    pts = np.asarray(ref_points, np.float64)
    cls = np.asarray(ref_cells)
    if decimate_to is not None and decimate_to < len(pts):
        new_pts, new_cells, _ = decimate(pts, cls, decimate_to)
        pts, cls = np.asarray(new_pts, np.float64), new_cells

    kernel = FaceKernel(FaceMask.trivial(len(pts)), pts)
    n_sample = min(num_sample_points, len(pts))
    sample_ids = area_weighted_vertex_subset(pts, cls, n_sample, seed)
    basis, variance = nystrom_lowrank(kernel, pts[sample_ids], pts,
                                      num_basis=num_components)
    return make_gpmm(
        ref_points=pts.astype(np.float32),
        cells=cls,
        mean_disp=np.zeros((len(pts), 3), np.float32),
        basis=basis,
        variance=variance,
        noise_variance=0.0,
        device=device,
    )
