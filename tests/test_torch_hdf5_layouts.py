"""The port's numpy HDF5 reader against ``h5py`` and the JAX package.

The JAX package reads statismo models with ``h5py``, which loads any HDF5
layout; the port reads them with ``icp_proposal_tpu_torch/io/hdf5.py``,
since the GPU host has no ``h5py``.  Each case writes a seeded small
statismo model with ``h5py`` in ``tmp_path`` in one layout (library
version bounds, storage layouts, chunk indices, filters, byte orders,
group storage, links, user blocks) and holds the port's
``read_statismo_arrays`` bitwise to JAX's, and ``read_datasets(path)`` to
every dataset an ``h5py`` visit of the file finds.  The formats still out
of scope raise ``ValueError`` naming the filter, type or link kind, and a
corrupted fletcher32 chunk never returns data.  The committed fixtures
(``tests/data/statismo``, written by ``tests/make_statismo_fixtures.py``)
read alike through ``h5py``, JAX and the port, and hash to their
``MANIFEST.json``.
"""
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import h5py
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu.io import statismo as jst
from icp_proposal_tpu_torch.io import hdf5
from icp_proposal_tpu_torch.io import statismo as pst

FIXTURES = Path(__file__).resolve().parent / "data" / "statismo"
MODEL = ("representer/points", "representer/cells", "model/mean", "model/pcaBasis",
         "model/pcaVariance", "model/noiseVariance")


def _model():
    """A seeded statismo model on the subdivision-2 icosphere (162 vertices,
    320 faces), rank 4, as JAX's writer stores it."""
    from icp_proposal_tpu.models.synthetic import make_icosphere

    points, cells = make_icosphere(subdivisions=2, radius=10.0)
    rng = np.random.RandomState(5)
    return {
        "representer/points": points.T.copy(),
        "representer/cells": cells.T.copy(),
        "model/mean": (points + rng.randn(*points.shape).astype(np.float32)).reshape(-1),
        "model/pcaBasis": rng.randn(3 * len(points), 4).astype(np.float32),
        "model/pcaVariance": np.float32([4.0, 2.5, 1.0, 0.5]),
        "model/noiseVariance": np.float32([0.25]),
    }


def _lowlevel(f, name, data, layout=None, chunks=None, early=False):
    """A dataset made through ``h5py.h5p``: compact, or chunked with its
    space allocated early (an implicit chunk index under libver latest)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout == "compact":
        dcpl.set_layout(h5py.h5d.COMPACT)
    if chunks is not None:
        dcpl.set_chunk(chunks)
    if early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    group = f.require_group(name.rsplit("/", 1)[0])
    ds = h5py.h5d.create(group.id, name.rsplit("/", 1)[1].encode(),
                         h5py.h5t.py_create(data.dtype), h5py.h5s.create_simple(data.shape),
                         dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


# case → (File arguments, {dataset: create_dataset arguments, "*": the rest},
# a function that adds to the open file, or None)
_FILTERS = {"shuffle": True, "compression": "gzip", "fletcher32": True}
CASES = {
    "earliest": ({"libver": "earliest"}, {}, None),
    "v108": ({"libver": "v108"}, {}, None),
    "latest": ({"libver": "latest"}, {}, None),
    "compact": ({}, {"lowlevel": "compact"}, None),
    "compact-latest": ({"libver": "latest"}, {"lowlevel": "compact"}, None),
    # 122 x 4 chunks: more than a v1 B-tree leaf holds, so internal nodes
    "btree1-internal-nodes": ({}, {"*": {"chunks": (4, 1)}}, None),
    "fixed-array": ({"libver": "latest"}, {"*": {"chunks": (8, 2)}}, None),
    # 486 x 4 chunks of one element: the fixed array's data block is paged
    "fixed-array-paged": ({"libver": "latest"}, {"model/pcaBasis": {"chunks": (1, 1)}},
                          None),
    "extensible-array-dim0": ({"libver": "latest"}, {"*": {"chunks": (1, 1),
                                                           "maxshape": None}}, None),
    "extensible-array-dim1": ({"libver": "latest"}, {
        "model/pcaBasis": {"chunks": (1, 1), "maxshape": (486, None)},
        "representer/cells": {"chunks": (1, 2), "maxshape": (3, None),
                              "compression": "gzip"}}, None),
    "btree2": ({"libver": "latest"}, {"*": {"chunks": (1, 1), "maxshape": "all"}}, None),
    "btree2-filtered": ({"libver": "latest"}, {"*": {"chunks": (2, 1), "maxshape": "all",
                                                     **_FILTERS}}, None),
    "single-chunk": ({"libver": "latest"}, {"*": {"chunks": "whole"}}, None),
    "single-chunk-filtered": ({"libver": "latest"}, {"*": {"chunks": "whole", **_FILTERS}},
                              None),
    "implicit": ({"libver": "latest"}, {"lowlevel": "implicit"}, None),
    "chunked-auto": ({}, {"*": {"chunks": True}}, None),
    "gzip": ({}, {"*": {"compression": "gzip"}}, None),
    "shuffle-gzip": ({}, {"*": {"shuffle": True, "compression": "gzip"}}, None),
    "fletcher32": ({}, {"*": {"fletcher32": True}}, None),
    "all-filters": ({}, {"*": {"chunks": (5, 3), **_FILTERS}}, None),
    "all-filters-latest": ({"libver": "latest"}, {"*": {"chunks": (5, 3), **_FILTERS}}, None),
    "all-filters-extensible": ({"libver": "latest"}, {"*": {
        "chunks": (3, 1), "maxshape": None, **_FILTERS}}, None),
    "partial-edge-chunks": ({}, {"*": {"chunks": (5, 3), "compression": "gzip"}}, None),
    "big-endian-f4-i4": ({}, {"*": {"dtype": ">f4"}, "representer/cells": {"dtype": ">i4"}},
                         None),
    "big-endian-f8-u4": ({"libver": "latest"}, {"*": {"dtype": ">f8", "chunks": (5, 3)},
                                                "representer/cells": {"dtype": ">u4"}},
                         None),
    "track-order": ({"track_order": True}, {}, None),
    "track-order-latest": ({"track_order": True, "libver": "latest"}, {}, None),
    "user-block": ({"userblock_size": 512}, {}, None),
    "user-block-latest": ({"userblock_size": 512, "libver": "latest"}, {}, None),
    "scalar-noise-variance": ({}, {"model/noiseVariance": {"scalar": True}}, None),
}


def _dense_group(f):
    """2,000 links in the root group: a dense group whose fractal heap has
    an indirect root block."""
    for i in range(1997):
        f[f"alias{i:04d}"] = h5py.SoftLink(f"/model/mean#{i}")


def _deep_heap(f):
    """Soft links with long targets ahead of the model's own links: the
    heap's root indirect block has indirect children."""
    for i in range(2400):
        f[f"model/alias{i:04d}"] = h5py.SoftLink("/" + "x" * 200 + str(i))


def _soft_link_path(f):
    """The model under ``data/``, reached through soft links."""
    f.create_group("data")
    f.move("model", "data/statistics")
    f["model"] = h5py.SoftLink("/data/statistics")
    f.move("representer/points", "representer/points-data")
    f["representer/points"] = h5py.SoftLink("points-data")


def _fill_values(f):
    """Beside the model: chunks never written read as the fill value, and
    a contiguous dataset never written as 0."""
    d = f.create_dataset("modelinfo/scores", shape=(13, 7), dtype="f8", chunks=(4, 3),
                         fillvalue=-2.5, maxshape=(40, 7))
    d[3:9, 1:5] = 1.5
    e = f.create_dataset("modelinfo/counts", shape=(9, 4), dtype="<u2", chunks=(2, 2),
                         fillvalue=9, maxshape=(None, 4))
    e[:3] = 1
    f.create_dataset("modelinfo/empty", shape=(5,), dtype="i4")


def _committed_type(f):
    """``model/mean`` of a committed (shared) datatype."""
    mean = f["model/mean"][()]
    del f["model/mean"]
    f["model/meanType"] = np.dtype("<f4")
    f.create_dataset("model/mean", data=mean, dtype=f["model/meanType"])


for _libver in ("earliest", "latest"):
    CASES[f"dense-2000-links-{_libver}"] = (
        {"libver": _libver} if _libver == "latest" else {"track_order": True}, {},
        _dense_group)
    CASES[f"soft-links-{_libver}"] = ({"libver": _libver}, {}, _soft_link_path)
    CASES[f"fill-values-{_libver}"] = ({"libver": _libver}, {}, _fill_values)
    CASES[f"committed-type-{_libver}"] = ({"libver": _libver}, {}, _committed_type)
CASES["dense-indirect-children"] = ({"libver": "latest"}, {}, _deep_heap)


def _write(path, case):
    file_kw, dataset_kw, extra = CASES[case]
    arrays = _model()
    low = dataset_kw.get("lowlevel")
    with h5py.File(path, "w", **file_kw) as f:
        for name, value in arrays.items():
            kw = dict(dataset_kw.get(name, dataset_kw.get("*", {})))
            value = value.astype(kw.pop("dtype", value.dtype))
            if kw.pop("scalar", False):
                value = value.reshape(())
            if kw.get("chunks") == "whole":
                kw["chunks"] = value.shape
            elif isinstance(kw.get("chunks"), tuple):
                kw["chunks"] = tuple(min(c, n) for c, n in zip(kw["chunks"], value.shape))
            if "maxshape" in kw:
                mx = kw["maxshape"]
                kw["maxshape"] = ((None,) * value.ndim if mx == "all" else
                                  (None,) + value.shape[1:] if mx is None else mx)
            if low == "compact":
                _lowlevel(f, name, value, layout="compact")
            elif low == "implicit":
                _lowlevel(f, name, value, chunks=tuple(max(n // 3, 1) for n in value.shape),
                          early=True)
            else:
                f.create_dataset(name, data=value, **kw)
        f["representer"].attrs["datasetType"] = np.bytes_("POLYGON_MESH")
        f.create_dataset("version/majorVersion", data=np.int32(0))
        f.create_dataset("version/minorVersion", data=np.int32(9))
        if extra is not None:
            extra(f)


def _h5py_datasets(path):
    """Every dataset an ``h5py`` visit of the file finds."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype.newbyteorder("="), k
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _assert_statismo_equal(path):
    """The port's ``read_statismo_arrays`` bitwise JAX's (the same keys,
    dtypes and shapes), and JAX's equal to the arrays ``h5py`` reads."""
    got, want = pst.read_statismo_arrays(path), jst.read_statismo_arrays(path)
    assert list(got) == list(want)
    for k, v in want.items():
        assert type(got[k]) is type(v), k
        if isinstance(v, float):
            assert got[k] == v
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_reads_as_h5py_and_jax(tmp_path, case):
    """One layout: the port's statismo arrays bitwise JAX's, the model's
    datasets equal to the seeded model's, and ``read_datasets(path)`` equal
    to an ``h5py`` visit of the file (values, shapes, dtypes up to byte
    order)."""
    path = tmp_path / f"{case}.h5"
    _write(path, case)
    got = _assert_statismo_equal(path)
    model = _model()
    np.testing.assert_array_equal(got["basis"].reshape(-1, 4), model["model/pcaBasis"])
    np.testing.assert_array_equal(got["points"], model["representer/points"].T)
    _assert_same(hdf5.read_datasets(path), _h5py_datasets(path))
    named = hdf5.read_datasets(path, MODEL)
    with h5py.File(path, "r") as f:
        for name in MODEL:
            np.testing.assert_array_equal(named[name], f[name][()], err_msg=name)


def test_layout_cases_reach_each_structure(tmp_path, monkeypatch):
    """The cases above reach what their names say: the chunk index types
    (v1 B-tree with internal nodes, single chunk, implicit, fixed array
    with paged data blocks, extensible array with super blocks, v2 B-tree
    of both record types), every superblock version h5py writes, a dense
    group whose fractal heap has indirect children, and version 2 object
    headers with creation-order fields."""
    seen = set()
    layout, fixed, ext, btree2 = (hdf5._File.layout, hdf5._File.fixed_array,
                                  hdf5._File.extensible_array, hdf5._btree2_records)
    heap_init, header = hdf5._FractalHeap.__init__, hdf5._File.header

    def spy_header(self, addr):
        if self.data[addr:addr + 4] == b"OHDR" and self.data[addr + 5] & 0x04:
            seen.add(("creation-order fields", True))
        return header(self, addr)

    def spy_layout(self, lay, *a):
        if lay[0] == 4 and lay[1] == 2:
            seen.add(("index", lay[5 + lay[4] * lay[3]]))
        if lay[0] == 3 and lay[1] == 2:
            root = self.addr_of(hdf5._u(lay, 3, 8))
            if root is not None and self.data[root + 5] > 0:
                seen.add(("btree1 level", 1))
        return layout(self, lay, *a)

    def spy_fixed(self, addr, grid, nbytes):
        seen.add(("fixed paged", hdf5._u(self.data, addr + 8, 8) > 1 << self.data[addr + 7]))
        return fixed(self, addr, grid, nbytes)

    def spy_ext(self, addr, grid, nbytes):
        seen.add(("ext super blocks", hdf5._u(self.data, addr + 12, 8) > 0))
        return ext(self, addr, grid, nbytes)

    def spy_btree2(f, addr, kinds=(5,)):
        seen.add(("btree2 type", f.data[addr + 5]))
        return btree2(f, addr, kinds)

    def spy_heap(self, f, addr):
        heap_init(self, f, addr)
        seen.add(("heap indirect children", f.u(addr + 140, 2) > hdf5._log2(
            f.u(addr + 120, 8)) - hdf5._log2(f.u(addr + 112, 8)) + 2))

    monkeypatch.setattr(hdf5._File, "layout", spy_layout)
    monkeypatch.setattr(hdf5._File, "fixed_array", spy_fixed)
    monkeypatch.setattr(hdf5._File, "extensible_array", spy_ext)
    monkeypatch.setattr(hdf5, "_btree2_records", spy_btree2)
    monkeypatch.setattr(hdf5._FractalHeap, "__init__", spy_heap)
    monkeypatch.setattr(hdf5._File, "header", spy_header)
    superblocks = set()
    for case in ("btree1-internal-nodes", "fixed-array-paged", "extensible-array-dim0",
                 "btree2", "btree2-filtered", "single-chunk", "implicit",
                 "dense-indirect-children", "v108", "earliest", "track-order-latest"):
        path = tmp_path / f"{case}.h5"
        _write(path, case)
        hdf5.read_datasets(path)
        superblocks.add(path.read_bytes()[8])
    assert {("index", 1), ("index", 2), ("index", 3), ("index", 4), ("index", 5),
            ("btree1 level", 1), ("fixed paged", True), ("ext super blocks", True),
            ("btree2 type", 5), ("btree2 type", 10), ("btree2 type", 11),
            ("heap indirect children", True), ("creation-order fields", True)} <= seen
    assert superblocks >= {0, 2, 3}


def test_extensible_array_paged_data_blocks(tmp_path):
    """Past 131,000 chunks an extensible array's data blocks are split into
    pages, each marked written or not in its super block's bitmap: a
    dataset written only here and there reads as ``h5py`` reads it, the
    chunks never written as the fill value."""
    path = tmp_path / "paged.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=(140_000,), dtype="u1", chunks=(1,),
                             maxshape=(None,), fillvalue=7)
        for i in np.r_[0:200, 131_000:133_100:3, 137_000:139_000:997]:
            d[i] = i % 251
    _assert_same(hdf5.read_datasets(path), _h5py_datasets(path))


def _array_type(f):
    tid = h5py.h5t.array_create(h5py.h5t.NATIVE_FLOAT, (2,))
    h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((3,)))


def _nbit(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((4,))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    ds = h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_INT32, h5py.h5s.create_simple((8,)),
                         dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(8, dtype=np.int32))


OUT_OF_SCOPE = {
    "lzf": (lambda f: f.create_dataset("x", data=np.arange(64.0), compression="lzf"),
            r"filter 32000 \(lzf\)"),
    "scale-offset": (lambda f: f.create_dataset("x", data=np.arange(64), scaleoffset=0),
                     r"filter 6 \(scale-offset\)"),
    "nbit": (_nbit, r"filter 5 \(nbit\)"),
    "variable-length-string": (lambda f: f.create_dataset(
        "x", data="2017-01-01", dtype=h5py.string_dtype()), "variable-length string"),
    "compound": (lambda f: f.create_dataset("x", data=np.zeros(3, "i4,f4")), "compound"),
    "enum": (lambda f: f.create_dataset("x", data=np.zeros(3, "i1"), dtype=h5py.enum_dtype(
        {"a": 0, "b": 1}, basetype="i1")), "enum"),
    "array": (_array_type, "array"),
    "opaque": (lambda f: f.create_dataset("x", data=np.void(b"abcd")), "opaque"),
    "reference": (lambda f: f.create_dataset("x", data=[f.ref], dtype=h5py.ref_dtype),
                  "reference"),
    "external-link": (lambda f: f.__setitem__("x", h5py.ExternalLink("other.h5", "/x")),
                      "external link"),
}


@pytest.mark.parametrize("kind", sorted(OUT_OF_SCOPE))
def test_out_of_scope_formats_raise(tmp_path, kind):
    """A wanted dataset behind a format still out of scope raises
    ``ValueError`` naming its filter, type or link kind; the same object
    beside the model does not stop the model's read."""
    make, reason = OUT_OF_SCOPE[kind]
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        make(f)
    with pytest.raises(ValueError, match=reason):
        hdf5.read_datasets(path, ["x"])
    _write(path, "earliest")
    with h5py.File(path, "a") as f:
        g = f.create_group("modelinfo")
        make(g)
    want = jst.read_statismo_arrays(path)
    got = pst.read_statismo_arrays(path)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_offsets_of_other_sizes_raise(tmp_path):
    """Only 8-byte offsets and lengths are read (what h5py writes)."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    path = tmp_path / "small_offsets.h5"
    with h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)) as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(ValueError, match="offsets and lengths of 4/4"):
        hdf5.read_datasets(path)


@pytest.mark.parametrize("where", ["data", "checksum"])
def test_corrupt_fletcher32_chunk_raises(tmp_path, where):
    """One byte flipped in a fletcher32-protected chunk (its offset from the
    reader's chunk index): ``ValueError``, never data.  The same chunk
    intact reads back."""
    path = tmp_path / "model.h5"
    _write(path, "all-filters")
    chunks = hdf5.dataset_chunks(path, "model/pcaBasis")
    assert len(chunks) == 98 * 2 and all(mask == 0 for *_, mask in chunks)
    start, addr, size, _ = max(chunks, key=lambda c: c[0])
    raw = bytearray(path.read_bytes())
    raw[addr + (size // 2 if where == "data" else size - 2)] ^= 0x5A
    bad = tmp_path / "bad.h5"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fletcher32"):
        hdf5.read_datasets(bad, ["model/pcaBasis"])
    with pytest.raises(ValueError, match="fletcher32"):
        pst.read_statismo_arrays(bad)
    np.testing.assert_array_equal(hdf5.read_datasets(bad, ["model/mean"])["model/mean"],
                                  _model()["model/mean"])


def _digest(value):
    a = np.array(value, dtype=np.float64 if isinstance(value, float) else None, order="C")
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "dtype": a.dtype.str,
            "shape": list(a.shape)}


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.h5")))
def test_committed_fixture(name):
    """A committed fixture: the port, JAX and ``h5py`` read it alike, and
    its six arrays hash to ``MANIFEST.json``."""
    path = FIXTURES / name
    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())["files"][name]
    got = _assert_statismo_equal(path)
    assert {k: _digest(v) for k, v in got.items()} == manifest["arrays"]
    _assert_same(hdf5.read_datasets(path), _h5py_datasets(path))


def test_committed_fixtures_are_whole():
    """Every file of the manifest is there, and together they stay small."""
    manifest = json.loads((FIXTURES / "MANIFEST.json").read_text())
    files = sorted(p.name for p in FIXTURES.glob("*.h5"))
    assert files == sorted(manifest["files"])
    assert sum((FIXTURES / n).stat().st_size for n in files) <= 1_500_000
    width = pst.read_statismo_arrays(FIXTURES / "femur_gp_model_50-components.h5")
    assert width["basis"].shape == (1622, 3, 51) and width["cells"].shape == (3240, 3)


def _time_bfm_size_read(reads=3):
    """Print the seconds the port's reader and ``h5py`` take for a basis of
    BFM-2017 size (159,000 × 199 float32, 127 MB) written by ``h5py`` in
    three layouts in a temporary directory, in turns."""
    basis = (np.random.RandomState(0).randn(159_000, 199) * 0.1).astype(np.float32)
    layouts = {
        "contiguous": ({}, {}),
        "chunked + gzip": ({}, {"chunks": True, "compression": "gzip"}),
        "chunked + shuffle + gzip + fletcher32, libver latest": (
            {"libver": "latest"}, {"chunks": True, **_FILTERS}),
    }
    print(f"python {sys.version.split()[0]}, numpy {np.__version__}, h5py "
          f"{h5py.__version__} (HDF5 {h5py.version.hdf5_version}); on this host's CPU")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bfm_size.h5"
        for label, (file_kw, kw) in layouts.items():
            with h5py.File(path, "w", **file_kw) as f:
                f.create_dataset("model/pcaBasis", data=basis, **kw)
            secs = {"port": [], "h5py": []}
            for _ in range(reads):
                t = time.perf_counter()
                got = hdf5.read_datasets(path, ["model/pcaBasis"])["model/pcaBasis"]
                secs["port"].append(time.perf_counter() - t)
                t = time.perf_counter()
                with h5py.File(path, "r") as f:
                    f["model/pcaBasis"][()]
                secs["h5py"].append(time.perf_counter() - t)
                assert np.array_equal(got, basis)
            chunks = len(hdf5.dataset_chunks(path, "model/pcaBasis")) if kw else 0
            print(f"{label} ({path.stat().st_size} bytes, {chunks} chunks): port " +
                  ", ".join(f"{s:.3f}" for s in secs["port"]) + " s; h5py " +
                  ", ".join(f"{s:.3f}" for s in secs["h5py"]) + " s")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hdf5_layouts.py --bfm-size
    if "--bfm-size" in sys.argv:
        _time_bfm_size_read()
