"""Statismo-format HDF5 GPMM IO.

Counterpart of ``icp_proposal_tpu/io/statismo.py`` (scalismo's
``StatisticalModelIO``; reference call site ``apps/femur/LoadTestData.scala:35``).
Layout:

    representer/points   [3, V] f32   reference mesh vertices
    representer/cells    [3, F] i32   triangle indices
    model/mean           [3V]   f32   mean shape points, xyz-interleaved
    model/pcaBasis       [3V, r] f32  basis functions at the vertices
    model/pcaVariance    [r]    f32   per-component variance λ
    model/noiseVariance  [1]    f32

The GP is over displacement fields: mean displacement = mean − points.
``h5py`` is imported inside the functions: nothing on the card's path needs
it.
"""
from __future__ import annotations

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE


def read_statismo_arrays(path) -> dict:
    """The model's host arrays: points [V, 3], cells [F, 3], mean_disp
    [V, 3], basis [V, 3, r], variance [r] and noise_variance (a float)."""
    import h5py

    with h5py.File(path, "r") as f:
        points = np.asarray(f["representer/points"], dtype=np.float32).T  # [V,3]
        cells = np.asarray(f["representer/cells"], dtype=np.int32).T  # [F,3]
        mean_shape = np.asarray(f["model/mean"], dtype=np.float32).reshape(-1, 3)
        basis = np.asarray(f["model/pcaBasis"], dtype=np.float32)  # [3V, r]
        variance = np.asarray(f["model/pcaVariance"], dtype=np.float32)
        noise = float(np.asarray(f["model/noiseVariance"]).ravel()[0])
    v = points.shape[0]
    r = basis.shape[1]
    return {
        "points": points,
        "cells": cells,
        "mean_disp": mean_shape - points,
        "basis": basis.reshape(v, 3, r),
        "variance": variance,
        "noise_variance": noise,
    }


def read_statismo_gpmm(path, device=DEFAULT_DEVICE):
    """A ``Gpmm`` from a statismo file, on ``device`` (the card unless
    ``device="cpu"``)."""
    from icp_proposal_tpu_torch.models.gpmm import make_gpmm

    arr = read_statismo_arrays(path)
    return make_gpmm(
        ref_points=arr["points"],
        cells=arr["cells"],
        mean_disp=arr["mean_disp"],
        basis=arr["basis"],
        variance=arr["variance"],
        noise_variance=arr["noise_variance"],
        device=device,
    )


def write_statismo_gpmm(path, gpmm) -> None:
    """Write a ``Gpmm`` in the statismo layout (readable by
    ``read_statismo_gpmm``, by the JAX package's reader and by scalismo)."""
    import h5py

    points = gpmm.ref_points.cpu().numpy().astype(np.float32)
    cells = gpmm.cells.cpu().numpy().astype(np.int32)
    mean_shape = points + gpmm.mean_disp.cpu().numpy().astype(np.float32)
    basis = gpmm.basis.cpu().numpy().astype(np.float32)
    v, _, r = basis.shape
    with h5py.File(path, "w") as f:
        f.create_dataset("representer/points", data=points.T)
        f.create_dataset("representer/cells", data=cells.T)
        f["representer"].attrs["datasetType"] = np.bytes_("POLYGON_MESH")
        f.create_dataset("model/mean", data=mean_shape.reshape(-1))
        f.create_dataset("model/pcaBasis", data=basis.reshape(3 * v, r))
        f.create_dataset("model/pcaVariance",
                         data=gpmm.variance.cpu().numpy().astype(np.float32))
        f.create_dataset("model/noiseVariance",
                         data=np.asarray([float(gpmm.noise_variance)], dtype=np.float32))
        f.create_dataset("version/majorVersion", data=np.int32(0))
        f.create_dataset("version/minorVersion", data=np.int32(9))
