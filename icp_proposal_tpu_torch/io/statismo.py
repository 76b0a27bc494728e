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
The files go through ``io/hdf5.py`` (numpy), since the H100 host has no
``h5py``.  Only the six datasets above are read (groups off their paths are
not opened), in any layout the HDF5 library writes: contiguous, compact or
chunked (deflate, shuffle, fletcher32), any library version bounds, either
byte order, dense groups and soft links.  A dataset behind another filter
(szip, nbit, scale-offset, lzf, a plugin), of another datatype class or
behind an external link raises ``ValueError``, as does a chunk whose
fletcher32 checksum fails.  The writer stores the ``h5py`` default layout,
as the JAX package's writer does.
"""
from __future__ import annotations

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE


def read_statismo_arrays(path) -> dict:
    """The model's host arrays: points [V, 3], cells [F, 3], mean_disp
    [V, 3], basis [V, 3, r], variance [r] and noise_variance (a float)."""
    from icp_proposal_tpu_torch.io.hdf5 import read_datasets

    f = read_datasets(path, ["representer/points", "representer/cells", "model/mean",
                             "model/pcaBasis", "model/pcaVariance", "model/noiseVariance"])
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
    from icp_proposal_tpu_torch.io.hdf5 import write_datasets

    points = gpmm.ref_points.cpu().numpy().astype(np.float32)
    cells = gpmm.cells.cpu().numpy().astype(np.int32)
    mean_shape = points + gpmm.mean_disp.cpu().numpy().astype(np.float32)
    basis = gpmm.basis.cpu().numpy().astype(np.float32)
    v, _, r = basis.shape
    write_datasets(path, {
        "representer/points": points.T,
        "representer/cells": cells.T,
        "model/mean": mean_shape.reshape(-1),
        "model/pcaBasis": basis.reshape(3 * v, r),
        "model/pcaVariance": gpmm.variance.cpu().numpy().astype(np.float32),
        "model/noiseVariance": np.asarray([float(gpmm.noise_variance)], dtype=np.float32),
        "version/majorVersion": np.int32(0),
        "version/minorVersion": np.int32(9),
    }, {"representer": {"datasetType": np.bytes_("POLYGON_MESH")}})
