"""The port's real-femur loader chain against the JAX package's.

Landmark JSON, statismo HDF5 and STL files written by the JAX package's
writers in a temporary directory (the real assets are not in the
repository), read back by the port; the port's numpy HDF5 against
``h5py``; rigid landmark alignment; and
``load_femur_data(data_dir=...)`` in both packages on the same files: the
model's arrays bitwise, the aligned target within 1e-5.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STANDIN = REPO / "artifacts" / "posterior"
GPMM_FIELDS = ("ref_points", "cells", "mean_disp", "basis", "variance", "noise_variance",
               "sbasis", "coeff_chol")


def _rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


@pytest.fixture(scope="module")
def femur_dir(tmp_path_factory):
    """A femur asset directory in the reference's layout, written by the JAX
    package: the stand-in GPMM-50 as ``femur_gp_model_50-components.h5``,
    six landmarks on the model's reference mesh, and the target (the MAP
    mesh moved by a rigid transform) with its landmarks moved alike, plus
    measurement noise of 0.05 mm, in the other order and with one name the
    model lacks."""
    from icp_proposal_tpu.io.landmarks import write_landmarks
    from icp_proposal_tpu.io.statismo import write_statismo_gpmm
    from icp_proposal_tpu.io.stl import read_stl, write_stl
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm

    out = tmp_path_factory.mktemp("femur")
    rng = np.random.RandomState(0)
    mp, mc = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    write_statismo_gpmm(out / "femur_gp_model_50-components.h5",
                        build_femur_gpmm(mp, mc, 50))
    rot, shift = _rotation(rng), rng.randn(3) * 20.0
    lm_ids = rng.choice(len(mp), 6, replace=False)
    write_landmarks(out / "femur_reference.json",
                    {f"L{i}": mp[v] for i, v in enumerate(lm_ids)})
    moved = (tp.astype(np.float64) @ rot.T + shift).astype(np.float32)
    write_stl(out / "femur_target.stl", moved, tc)
    write_landmarks(out / "femur_target.json",
                    {f"L{i}": mp[v].astype(np.float64) @ rot.T + shift + rng.randn(3) * 0.05
                     for i, v in reversed(list(enumerate(lm_ids)))}
                    | {"extra": np.zeros(3)})
    return out


def test_landmarks_round_trip(tmp_path, femur_dir):
    """The JAX-written landmark files read the same in both packages; the
    port's writer is read back by JAX unchanged; ``common_landmarks`` keeps
    the first set's order and drops the names the other lacks."""
    from icp_proposal_tpu.io import landmarks as jlm
    from icp_proposal_tpu_torch.io import landmarks as plm

    for name in ("femur_reference.json", "femur_target.json"):
        got, want = plm.read_landmarks(femur_dir / name), jlm.read_landmarks(femur_dir / name)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        plm.write_landmarks(tmp_path / name, got)
        back = jlm.read_landmarks(tmp_path / name)
        for k in want:
            np.testing.assert_array_equal(back[k], want[k])
    a = plm.read_landmarks(femur_dir / "femur_target.json")
    b = plm.read_landmarks(femur_dir / "femur_reference.json")
    pa, pb, names = plm.common_landmarks(a, b)
    ja, jb, jnames = jlm.common_landmarks(a, b)
    assert names == jnames and "extra" not in names and len(names) == 6
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)


def test_statismo_round_trip(tmp_path, femur_dir):
    """The JAX-written model: ``read_statismo_arrays`` bitwise JAX's, the
    port's ``Gpmm`` field by field bitwise JAX's; the port's writer read
    back by JAX's reader bitwise."""
    from icp_proposal_tpu.io import statismo as jst
    from icp_proposal_tpu_torch.io import statismo as pst

    path = femur_dir / "femur_gp_model_50-components.h5"
    got, want = pst.read_statismo_arrays(path), jst.read_statismo_arrays(path)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pm, jm = pst.read_statismo_gpmm(path, device="cpu"), jst.read_statismo_gpmm(path)
    assert pm.rank == 51
    for k in GPMM_FIELDS:
        np.testing.assert_array_equal(getattr(pm, k).numpy(), np.asarray(getattr(jm, k)),
                                      err_msg=k)
    pst.write_statismo_gpmm(tmp_path / "port.h5", pm)
    back = jst.read_statismo_arrays(tmp_path / "port.h5")
    np.testing.assert_array_equal(back["basis"], want["basis"])
    np.testing.assert_array_equal(back["points"], want["points"])
    np.testing.assert_array_equal(back["variance"], want["variance"])
    # the port writes the model's own (Morton-ordered) faces, which JAX's
    # reader orders again the same way
    back_cells = jst.read_statismo_gpmm(tmp_path / "port.h5").cells
    np.testing.assert_array_equal(np.asarray(back_cells), np.asarray(jm.cells))


def test_hdf5_interoperates_with_h5py(tmp_path):
    """``io/hdf5.py`` (the port's numpy HDF5, since the H100 host has no
    ``h5py``): what it writes, ``h5py`` reads back with the same values,
    dtypes, shapes and the group attribute; what ``h5py`` writes by default
    it reads back alike (float32/64, signed and unsigned integers, scalars,
    fixed-length strings, nested groups, a group of 200 members that spans
    many symbol-table nodes); the statismo files of both writers hold the
    same arrays; ``libver="latest"`` and chunked files read as ``h5py``
    reads them; a format it does not cover (the lzf filter) raises
    ``ValueError``."""
    import h5py

    from icp_proposal_tpu.io import statismo as jst
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.io import hdf5
    from icp_proposal_tpu_torch.io import statismo as pst

    rng = np.random.RandomState(1)
    data = {"a/f32": rng.randn(3, 50).astype(np.float32), "a/i32": rng.randint(
        -9, 9, (3, 7)).astype(np.int32), "a/b/c/f64": rng.randn(4, 2),
        "u8": np.arange(5, dtype=np.uint8), "s": np.asarray([b"ab", b"cde"]),
        "v/scalar": np.int32(7), **{f"many/d{i:03d}": np.full(2, i) for i in range(200)}}
    hdf5.write_datasets(tmp_path / "port.h5", data, {"a": {"kind": np.bytes_("MESH")}})
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert f["a"].attrs["kind"] == b"MESH"
        read = {k: f[k][()] for k in data}
    for got in (read, hdf5.read_datasets(tmp_path / "h5py.h5"),
                hdf5.read_datasets(tmp_path / "port.h5")):
        assert sorted(got) == sorted(data)
        for k, v in data.items():
            g = np.asarray(got[k])
            assert g.dtype == v.dtype and g.shape == np.shape(v), k
            np.testing.assert_array_equal(g, v, err_msg=k)

    points, cells = make_icosphere(subdivisions=1, radius=10.0)
    jm = make_synthetic_gpmm(points, cells, rank=3)
    jst.write_statismo_gpmm(tmp_path / "jax_model.h5", jm)
    pst.write_statismo_gpmm(tmp_path / "port_model.h5", convert.gpmm_from_arrays(
        **{k: np.asarray(v) for k, v in jm._asdict().items()}, device="cpu"))
    with h5py.File(tmp_path / "jax_model.h5", "r") as f, \
            h5py.File(tmp_path / "port_model.h5", "r") as g:
        names = []
        f.visit(names.append)
        for name in names:
            if isinstance(f[name], h5py.Dataset):
                np.testing.assert_array_equal(g[name][()], f[name][()], err_msg=name)
                assert g[name].dtype == f[name].dtype, name
        assert g["representer"].attrs["datasetType"] == f["representer"].attrs["datasetType"]

    with h5py.File(tmp_path / "latest.h5", "w", libver="latest") as f:
        f.create_dataset("x", data=rng.randn(3))
    with h5py.File(tmp_path / "chunked.h5", "w") as f:
        f.create_dataset("x", data=rng.randn(8, 8), chunks=(4, 4))
    for name in ("latest.h5", "chunked.h5"):
        with h5py.File(tmp_path / name, "r") as f:
            want = f["x"][()]
        got = hdf5.read_datasets(tmp_path / name)
        assert list(got) == ["x"] and got["x"].dtype == want.dtype
        np.testing.assert_array_equal(got["x"], want)
    with h5py.File(tmp_path / "lzf.h5", "w") as f:
        f.create_dataset("x", data=np.zeros((8, 8)), chunks=(4, 4), compression="lzf")
    with pytest.raises(ValueError, match="HDF5"):
        hdf5.read_datasets(tmp_path / "lzf.h5")


def test_statismo_read_skips_unrelated_datasets(tmp_path):
    """A statismo file written by the JAX package (``h5py``) and then given
    objects beside the model (a chunked, gzip-compressed dataset and a
    variable-length string under ``modelinfo/``, a group stored as link
    messages, an external link) reads back as before: the reader opens only
    the six statismo datasets.  Listing every dataset gives what ``h5py``
    gives, less the variable-length string (a type the reader does not
    decode).  Asking for a missing dataset raises ``KeyError``, one behind
    the external link ``ValueError``; a model dataset that is itself
    chunked reads as ``h5py`` reads it."""
    import h5py

    from icp_proposal_tpu.io import statismo as jst
    from icp_proposal_tpu.models.synthetic import make_icosphere, make_synthetic_gpmm
    from icp_proposal_tpu_torch.io import hdf5
    from icp_proposal_tpu_torch.io import statismo as pst

    points, cells = make_icosphere(subdivisions=1, radius=10.0)
    path = tmp_path / "model.h5"
    jst.write_statismo_gpmm(path, make_synthetic_gpmm(points, cells, rank=3))
    want = pst.read_statismo_arrays(path)
    with h5py.File(path, "a") as f:
        f.create_dataset("modelinfo/scores", data=np.zeros((16, 16)), chunks=(4, 4),
                         compression="gzip")
        f.create_dataset("modelinfo/build-time", data="2017-01-01",
                         dtype=h5py.string_dtype())
        f.create_group("modelinfo/tracked", track_order=True).create_dataset(
            "x", data=np.zeros(2))
        f["modelinfo/elsewhere"] = h5py.ExternalLink("other.h5", "/model")
    back = pst.read_statismo_arrays(path)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    listed = hdf5.read_datasets(path)
    with h5py.File(path, "r") as f:
        names = []
        f.visit(lambda n: names.append(n) if isinstance(f[n], h5py.Dataset) else None)
        assert sorted(listed) == sorted(set(names) - {"modelinfo/build-time"})
        for name in listed:
            np.testing.assert_array_equal(listed[name], f[name][()], err_msg=name)
    with pytest.raises(KeyError, match="model/absent"):
        hdf5.read_datasets(path, ["model/mean", "model/absent"])
    with pytest.raises(ValueError, match="external link"):
        hdf5.read_datasets(path, ["modelinfo/elsewhere/mean"])

    with h5py.File(path, "a") as f:
        basis = f["model/pcaBasis"][()]
        del f["model/pcaBasis"]
        f.create_dataset("model/pcaBasis", data=basis, chunks=True)
    chunked = pst.read_statismo_arrays(path)
    for k, v in jst.read_statismo_arrays(path).items():
        np.testing.assert_array_equal(chunked[k], v, err_msg=k)
    np.testing.assert_array_equal(chunked["basis"], want["basis"])


def test_rigid_alignment_matches_jax():
    """Kabsch on noisy landmarks, rotating about the origin and about a
    given center: the port's transform bitwise JAX's (both host float64,
    stored float32); ``apply`` and ``inverse_apply`` on numpy arrays
    bitwise JAX's, on tensors within 1e-5, and they invert each other."""
    from icp_proposal_tpu.ops.rigid import rigid_landmark_alignment as jalign
    from icp_proposal_tpu_torch.ops.rigid import rigid_landmark_alignment as palign

    rng = np.random.RandomState(3)
    src = rng.randn(8, 3) * 30
    dst = src @ _rotation(rng).T + rng.randn(3) * 5 + rng.randn(8, 3) * 0.01
    pts = (rng.randn(100, 3) * 40).astype(np.float32)
    for center in (None, np.array([1.0, -2.0, 3.0])):
        got, want = palign(src, dst, center), jalign(src, dst, center)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(got.apply(pts), np.asarray(want.apply(pts)))
        np.testing.assert_array_equal(got.inverse_apply(pts),
                                      np.asarray(want.inverse_apply(pts)))
        t = got.apply(torch.as_tensor(pts))
        assert isinstance(t, torch.Tensor)
        np.testing.assert_allclose(t.numpy(), got.apply(pts), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.inverse_apply(t).numpy(), pts, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.apply(src.astype(np.float32)), dst, atol=0.05)


def test_load_femur_data_matches_jax(femur_dir):
    """``load_femur_data(data_dir=...)`` on the JAX-written files in both
    packages: the model's arrays bitwise, the landmark-aligned target within
    1e-5 (and back on the MAP mesh within 0.2 mm), the cells, both boundary
    masks and the landmarks equal; ``convert.femur_data_from_arrays`` of
    JAX's data gives the port's."""
    from icp_proposal_tpu.apps.femur import load_femur_data as jload
    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu_torch import convert
    from icp_proposal_tpu_torch.apps.femur import load_femur_data

    got = load_femur_data(50, str(femur_dir), device="cpu")
    want = jload(50, str(femur_dir))
    for k in GPMM_FIELDS:
        np.testing.assert_array_equal(getattr(got.model, k).numpy(),
                                      np.asarray(getattr(want.model, k)), err_msg=k)
    np.testing.assert_allclose(got.target.points, np.asarray(want.target.points), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.target.cells, np.asarray(want.target.cells))
    np.testing.assert_array_equal(got.target_boundary_mask, want.target_boundary_mask)
    np.testing.assert_array_equal(got.model_boundary_mask, want.model_boundary_mask)
    assert list(got.target_landmarks) == list(want.target_landmarks)
    for k, v in want.target_landmarks.items():
        np.testing.assert_allclose(got.target_landmarks[k], v, rtol=0, atol=1e-5)
    for k, v in want.model_landmarks.items():
        np.testing.assert_array_equal(got.model_landmarks[k], v)
    tp, _ = read_stl(STANDIN / "map.stl")
    assert np.abs(got.target.points - tp).max() < 0.2
    # the JAX workload carried across by the converter is the port's own
    conv = convert.femur_data_from_arrays(
        {k: np.asarray(v) for k, v in want.model._asdict().items()},
        np.asarray(want.target.points), np.asarray(want.target.cells),
        want.target_boundary_mask, want.model_boundary_mask, want.model_landmarks,
        want.target_landmarks, device="cpu")
    for k in GPMM_FIELDS:
        assert torch.equal(getattr(conv.model, k), getattr(got.model, k)), k
    np.testing.assert_array_equal(conv.target.cells, got.target.cells)
    np.testing.assert_array_equal(conv.model_boundary_mask, got.model_boundary_mask)
    assert list(conv.target_landmarks) == list(got.target_landmarks)


def test_load_femur_data_raises_without_assets(tmp_path, femur_dir):
    """Missing files raise and name what is missing; nothing falls back to
    the stand-in.  Other component counts read their own file."""
    from icp_proposal_tpu_torch.apps.femur import load_femur_data

    with pytest.raises(FileNotFoundError, match="femur_gp_model_50-components.h5"):
        load_femur_data(50, str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="femur_gp_model_100-components.h5"):
        load_femur_data(100, str(femur_dir), device="cpu")
