"""The port's data preparation and model building against the JAX package's.

Every module here is host numpy, so the files written and the arrays
returned must be bitwise the JAX package's on the same inputs: the aligned
meshes and landmarks of ``align_shapes`` (inputs of JAX's
``test_align_shapes_tool``), the BFM dataset of ``prepare_bfm_dataset`` and
what ``load_bfm_data`` reads back (inputs of JAX's
``test_bfm_dataset_prep_and_load``), ``build_face_gpmm`` at a small size,
and the statismo files of the ``create_gp_model`` CLI, read back by JAX's
reader.  The port's entry points run with ``device="cpu"``.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu.io.landmarks import write_landmarks
from icp_proposal_tpu.io.stl import write_stl
from icp_proposal_tpu.models.synthetic import (
    make_icosphere,
    make_open_patch,
    make_synthetic_gpmm,
)

STANDIN = Path(__file__).resolve().parents[1] / "artifacts" / "posterior"


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_align_shapes_files_identical(tmp_path):
    """``align_shapes`` on the inputs of JAX's ``test_align_shapes_tool``
    (a rotated and moved icosphere and its landmarks, plus a mesh without
    landmarks, which both skip): the same files, byte for byte; the aligned
    mesh lies on the original (JAX's own check)."""
    from icp_proposal_tpu.apps.align_shapes import align_shapes as jalign
    from icp_proposal_tpu_torch.apps.align_shapes import align_shapes as palign
    from icp_proposal_tpu_torch.io.stl import read_stl

    points, cells = make_icosphere(subdivisions=1, radius=10.0)
    lms = {"a": points[0].astype(np.float64), "b": points[10].astype(np.float64),
           "c": points[20].astype(np.float64), "d": points[30].astype(np.float64)}
    theta = 0.5
    r = np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                  [0, 0, 1]])
    moved = points @ r.T + np.array([5.0, -2.0, 1.0], np.float32)
    moved_lms = {k: v @ r.T + np.array([5.0, -2.0, 1.0]) for k, v in lms.items()}
    mesh_dir, lm_dir = tmp_path / "meshes", tmp_path / "landmarks"
    os.makedirs(mesh_dir)
    os.makedirs(lm_dir)
    write_stl(mesh_dir / "scan0.stl", moved, cells)
    write_stl(mesh_dir / "nolms.stl", moved, cells)
    write_landmarks(lm_dir / "scan0.json", moved_lms)
    write_landmarks(tmp_path / "ref.json", lms)

    args = (str(mesh_dir), str(lm_dir), str(tmp_path / "ref.json"))
    assert jalign(*args, str(tmp_path / "jax"), verbose=False) == 1
    assert palign(*args, str(tmp_path / "port"), verbose=False) == 1
    want = _tree(tmp_path / "jax")
    assert sorted(want) == ["landmarks/scan0.json", "meshes/scan0.stl"]
    assert _tree(tmp_path / "port") == want
    aligned, _ = read_stl(tmp_path / "port" / "meshes" / "scan0.stl")
    np.testing.assert_allclose(np.sort(aligned.ravel()), np.sort(points.ravel()), atol=1e-3)

    # the CLI writes the same tree, with a scale
    from icp_proposal_tpu_torch.apps import align_shapes as pmod

    pmod.main([*args, str(tmp_path / "cli"), "--scale", "2.0"])
    jalign(*args, str(tmp_path / "jax2"), scale=2.0, verbose=False)
    assert _tree(tmp_path / "cli") == _tree(tmp_path / "jax2")


@pytest.fixture(scope="module")
def bfm_dirs(tmp_path_factory):
    """The inputs of JAX's ``test_bfm_dataset_prep_and_load`` (open patch,
    rank-6 GPMM in statismo form, model landmarks with the nose tip, one
    scan in millimetres with a rigid offset, as binary PLY here) and each
    package's ``prepare_bfm_dataset`` output → (JAX dir, port dir, patch)."""
    from icp_proposal_tpu.apps.bfm import prepare_bfm_dataset as jprep
    from icp_proposal_tpu.io.statismo import write_statismo_gpmm
    from icp_proposal_tpu_torch.apps.bfm import prepare_bfm_dataset as pprep

    tmp = tmp_path_factory.mktemp("bfm")
    points, cells = make_open_patch(subdivisions=2, radius=0.1, z_cut=0.6)
    model = make_synthetic_gpmm(points, cells, rank=6)
    model_lms = {
        "a": np.asarray(points[0], np.float64), "b": np.asarray(points[5], np.float64),
        "c": np.asarray(points[11], np.float64), "d": np.asarray(points[17], np.float64),
        "center.nose.tip": np.asarray(points[int(np.argmax(points[:, 2]))], np.float64),
    }
    scans, lms_dir = tmp / "scans", tmp / "lms"
    os.makedirs(scans)
    os.makedirs(lms_dir)
    offset = np.array([7.0, -3.0, 2.0])
    scan_pts = ((np.asarray(points, np.float64) + offset) * 1000.0).astype(np.float32)
    from test_torch_host import _binary_ply

    _binary_ply(scans / "subject0.ply", scan_pts, cells)
    write_stl(scans / "subject1.stl", scan_pts[:, [1, 0, 2]], cells)
    write_landmarks(lms_dir / "subject0.json",
                    {k: (v + offset) * 1000.0 for k, v in model_lms.items()})
    write_landmarks(lms_dir / "subject1.json",  # no nose tip: no partial variant
                    {k: ((v + offset) * 1000.0)[[1, 0, 2]] for k, v in model_lms.items()
                     if k != "center.nose.tip"})
    out = {}
    for name, prep in (("jax", jprep), ("port", pprep)):
        out[name] = tmp / name
        os.makedirs(out[name])
        write_statismo_gpmm(out[name] / "faceGPmodel_200c.h5", model)
        write_landmarks(out[name] / "bfm.json", model_lms)
        n = prep(str(scans), str(lms_dir), str(out[name] / "bfm.json"), str(out[name]),
                 n_nose_cut=len(points) // 8, mouth_mask_ids=(3, 4, 10 ** 6),
                 verbose=False)
        assert n == 2
    return out["jax"], out["port"], (points, cells)


def test_prepare_bfm_dataset_files_identical(bfm_dirs):
    """``prepare_bfm_dataset``: the aligned and partial trees, byte for byte
    (a binary PLY scan with the nose tip, an STL scan without it), and
    ``align_scan`` alone bitwise."""
    from icp_proposal_tpu.apps.bfm import align_scan as jalign_scan
    from icp_proposal_tpu_torch.apps.bfm import align_scan as palign_scan

    jdir, pdir, (points, _) = bfm_dirs
    want = _tree(jdir)
    assert "partial/meshes/subject0.stl" in want
    assert "partial/meshes/subject1.stl" not in want
    assert _tree(pdir) == want

    rng = np.random.RandomState(5)
    scan = (points + rng.randn(3).astype(np.float32)) * 1000.0
    lms = {f"p{i}": scan[i].astype(np.float64) for i in (0, 4, 9, 13)}
    model_lms = {f"p{i}": points[i].astype(np.float64) for i in (13, 9, 4, 0)}
    got, jgot = palign_scan(scan, lms, model_lms), jalign_scan(scan, lms, model_lms)
    np.testing.assert_array_equal(got[0], jgot[0])
    assert list(got[1]) == list(jgot[1])
    for k in got[1]:
        np.testing.assert_array_equal(got[1][k], jgot[1][k])


@pytest.mark.parametrize("target_index", [0, 1])
def test_load_bfm_data_identical(bfm_dirs, target_index):
    """``load_bfm_data`` reads the JAX-prepared directory as JAX does: the
    model's arrays, the complete and partial targets (the complete one where
    no partial variant exists) and the three boundary masks, bitwise; the
    aligned target lies on the model's surface (JAX's own check)."""
    from icp_proposal_tpu.apps.bfm import load_bfm_data as jload
    from icp_proposal_tpu_torch.apps.bfm import load_bfm_data as pload

    jdir, _, (points, _) = bfm_dirs
    got, want = pload(str(jdir), target_index, device="cpu"), jload(str(jdir), target_index)
    assert got.model.rank == 6 and got.model.device.type == "cpu"
    for name, w in want.model._asdict().items():
        np.testing.assert_array_equal(getattr(got.model, name).numpy(), np.asarray(w),
                                      err_msg=name)
    for name in ("target", "target_partial"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    for name in ("model_boundary_mask", "target_boundary_mask", "partial_boundary_mask"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)),
                                      err_msg=name)
    if target_index == 0:
        assert len(got.target_partial.points) < len(got.target.points)
        np.testing.assert_allclose(np.sort(got.target.points.ravel()),
                                   np.sort(points.ravel()), atol=1e-3)
    else:
        np.testing.assert_array_equal(got.target_partial.points, got.target.points)


def test_load_bfm_data_raises_without_assets(tmp_path):
    """Without the model file the loader raises, naming the directory; the
    default directory is the reference's relative ``data/bfm``."""
    from icp_proposal_tpu_torch.apps import bfm as pbfm

    assert pbfm.BFM_DATA_DIR == Path("data") / "bfm"
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        pbfm.load_bfm_data(str(tmp_path), device="cpu")


def test_build_face_gpmm_identical():
    """``build_face_gpmm`` on the subdivision-3 open patch (497 vertices,
    decimated to 200; 48 Nyström points, rank 12): every array of the model
    bitwise JAX's; and without decimation (``decimate_to=None``)."""
    from icp_proposal_tpu.models.build_face import build_face_gpmm as jbuild
    from icp_proposal_tpu_torch.models.build_face import build_face_gpmm as pbuild

    points, cells = make_open_patch(subdivisions=3, radius=0.1, z_cut=0.55)
    assert len(points) == 497
    for kw in (dict(decimate_to=200), dict(decimate_to=None)):
        kw.update(num_components=12, num_sample_points=48)
        got, want = pbuild(points, cells, device="cpu", **kw), jbuild(points, cells, **kw)
        assert got.num_points == (200 if kw["decimate_to"] else 497) and got.rank == 12
        for name, w in want._asdict().items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("cmd", ["femur", "face"])
def test_create_gp_model_cli_identical(tmp_path, monkeypatch, cmd):
    """Each package's ``create_gp_model`` CLI, run through ``main()`` with
    ``sys.argv`` patched (the port's with ``--device cpu``): the port's
    statismo files, read back by JAX's ``read_statismo_gpmm``, equal JAX's
    own files field by field.  femur: the stand-in's mean mesh, 5 and 10
    components; face: the subdivision-3 open patch decimated to 200
    vertices, 48 sample points, rank 12."""
    from icp_proposal_tpu.apps import create_gp_model as jcli
    from icp_proposal_tpu.io.statismo import read_statismo_gpmm
    from icp_proposal_tpu_torch.apps import create_gp_model as pcli

    if cmd == "femur":
        ref = STANDIN / "mean.stl"
        files = ["femur_gp_model_5-components.h5", "femur_gp_model_10-components.h5"]
    else:
        ref = tmp_path / "face_ref.stl"
        write_stl(ref, *make_open_patch(subdivisions=3, radius=0.1, z_cut=0.55))
        files = ["face.h5"]
    for name, cli, extra in (("jax", jcli, []), ("port", pcli, ["--device", "cpu"])):
        out = tmp_path / name
        if cmd == "femur":
            argv = [cmd, "--reference", str(ref), "--components", "5", "10",
                    "--out-dir", str(out)]
        else:
            os.makedirs(out)
            argv = [cmd, "--reference", str(ref), "--components", "12", "--decimate-to",
                    "200", "--sample-points", "48", "--out", str(out / "face.h5")]
        monkeypatch.setattr(sys, "argv", ["create_gp_model", *argv, *extra])
        cli.main()
    for f in files:
        got, want = (read_statismo_gpmm(tmp_path / d / f) for d in ("port", "jax"))
        for name, w in want._asdict().items():
            np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(w),
                                          err_msg=f"{f}: {name}")
    assert torch.get_num_threads() == 1
