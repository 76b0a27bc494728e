"""Write the statismo model files of ``tests/data/statismo/`` and their
``MANIFEST.json``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_statismo_fixtures.py

The port reads statismo files with its own numpy HDF5 reader
(``icp_proposal_tpu_torch/io/hdf5.py``), and the GPU host has no ``h5py``
to write test files, so these files are committed: ``chip_smoke.py`` reads
them there, and ``tests/test_torch_hdf5_layouts.py`` holds the reader to
``h5py`` and to the JAX package's ``read_statismo_arrays`` on them.  Each
file is written by ``h5py`` in a layout other than its default:

* ``femur_gp_model_50-components.h5``: the stand-in femur GPMM-50 at full
  width (JAX's ``build_femur_gpmm`` on ``artifacts/posterior/mean.stl``:
  1,622 vertices, 51 basis columns), the name and width of the
  reference's default model file; ``libver="latest"`` (superblock 3,
  version 2 object headers), chunked with shuffle + gzip + fletcher32, and
  ``model/`` holds nine links, so the group is stored dense (a fractal
  heap and a version 2 B-tree);
* small icosphere models (42 vertices, rank 4), a few kilobytes each:
  version 1 B-tree chunking with internal nodes; extensible-array and
  version 2 B-tree chunk indices; big-endian numbers; a 512-byte user
  block.

The manifest records the ``h5py`` and HDF5 versions, each file's layout
arguments, and the sha256 of each of the six arrays exactly as JAX's
``read_statismo_arrays`` returns them (C order; ``noise_variance`` as a
float64).
"""
import hashlib
import json
from pathlib import Path

import h5py
import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "statismo"


def digest(value) -> dict:
    """sha256, dtype and shape of one of ``read_statismo_arrays``' values."""
    a = np.array(value, dtype=np.float64 if isinstance(value, float) else None, order="C")
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "dtype": a.dtype.str,
            "shape": list(a.shape)}


def statismo_arrays(gpmm) -> dict:
    """The statismo datasets of a JAX ``Gpmm``, as JAX's writer stores them."""
    points = np.asarray(gpmm.ref_points, dtype=np.float32)
    v, _, r = gpmm.basis.shape
    return {
        "representer/points": points.T,
        "representer/cells": np.asarray(gpmm.cells, dtype=np.int32).T,
        "model/mean": (points + np.asarray(gpmm.mean_disp, np.float32)).reshape(-1),
        "model/pcaBasis": np.asarray(gpmm.basis, dtype=np.float32).reshape(3 * v, r),
        "model/pcaVariance": np.asarray(gpmm.variance, dtype=np.float32),
        "model/noiseVariance": np.asarray([gpmm.noise_variance], dtype=np.float32),
    }


def write(path, arrays, file_kw, dataset_kw, extra=None):
    """The statismo datasets (``dataset_kw``: name → ``create_dataset``
    arguments, "*" for every other one) plus the version datasets and
    ``extra`` (name → array)."""
    with h5py.File(path, "w", **file_kw) as f:
        for name, value in arrays.items():
            kw = dict(dataset_kw.get(name, dataset_kw.get("*", {})))
            dtype = kw.pop("dtype", None)
            f.create_dataset(name, data=value if dtype is None else value.astype(dtype),
                             **kw)
        f["representer"].attrs["datasetType"] = np.bytes_("POLYGON_MESH")
        f.create_dataset("version/majorVersion", data=np.int32(0))
        f.create_dataset("version/minorVersion", data=np.int32(9))
        for name, value in (extra or {}).items():
            f.create_dataset(name, data=value)


def fixtures():
    """name → (JAX Gpmm builder, file arguments, dataset arguments, extra
    datasets)."""
    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm

    def femur():
        mp, mc = read_stl(REPO / "artifacts" / "posterior" / "mean.stl")
        return build_femur_gpmm(mp, mc, 50)

    def sphere():
        return make_synthetic_gpmm(*make_icosphere(subdivisions=1, radius=10.0), rank=4)

    filters = {"chunks": True, "shuffle": True, "compression": "gzip", "fletcher32": True}
    # five build records beside the four model datasets: nine links in model/
    builds = {f"model/buildRecord-{i}": np.arange(3, dtype=np.int32) + i for i in range(5)}
    return {
        "femur_gp_model_50-components.h5": (
            femur, {"libver": "latest"}, {"*": filters}, builds),
        "icosphere_btree1.h5": (
            sphere, {"libver": "earliest"},
            {"model/pcaBasis": {"chunks": (4, 1), "shuffle": True, "compression": "gzip"},
             "representer/points": {"chunks": (1, 4)}}, None),
        "icosphere_earray_btree2.h5": (
            sphere, {"libver": "latest"},
            {"model/pcaBasis": {"chunks": (2, 1), "maxshape": (None, 4), "fletcher32": True},
             "representer/cells": {"chunks": (3, 8), "maxshape": (3, None),
                                   "compression": "gzip"},
             "representer/points": {"chunks": (2, 5), "maxshape": (None, None)},
             "model/mean": {"chunks": (16,), "maxshape": (None,), "compression": "gzip",
                            "shuffle": True}}, None),
        "icosphere_bigendian.h5": (
            sphere, {},
            {"representer/points": {"dtype": ">f8"}, "representer/cells": {"dtype": ">i4"},
             "model/pcaBasis": {"dtype": ">f4", "chunks": (21, 2), "compression": "gzip"},
             "*": {"dtype": ">f4"}}, None),
        "icosphere_userblock.h5": (
            sphere, {"userblock_size": 512, "libver": "v108"}, {}, None),
    }


def main():
    from icp_proposal_tpu.io.statismo import read_statismo_arrays

    OUT.mkdir(parents=True, exist_ok=True)
    manifest = {"h5py": h5py.__version__, "hdf5": h5py.version.hdf5_version, "files": {}}
    for name, (build, file_kw, dataset_kw, extra) in fixtures().items():
        path = OUT / name
        write(path, statismo_arrays(build()), file_kw, dataset_kw, extra)
        arrays = read_statismo_arrays(path)
        manifest["files"][name] = {
            "file": file_kw, "datasets": {k: {a: list(b) if isinstance(b, tuple) else b
                                              for a, b in v.items()}
                                          for k, v in dataset_kw.items()},
            "extra": sorted(extra or {}), "bytes": path.stat().st_size,
            "arrays": {k: digest(v) for k, v in arrays.items()}}
        print(f"{name}: {path.stat().st_size} bytes")
    (OUT / "MANIFEST.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()
