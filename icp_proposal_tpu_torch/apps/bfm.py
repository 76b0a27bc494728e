"""BFM face workload: data preparation, the real-asset loader, the
synthetic face stand-in and the fitting setups.

Counterpart of ``icp_proposal_tpu/apps/bfm.py`` (reference ``apps/bfm``:
``AlignShapes.scala``, ``LoadTestData.scala``, ``BfmFittingComplete.scala``,
``BfmFittingPartial.scala``).  ``prepare_bfm_dataset`` scales and aligns
the scans and synthesizes their partial variants; ``load_bfm_data`` reads
the model and the prepared targets from a directory the caller names.  The
BFM-2017 model and scans are license-gated and not in the repository;
``load_synthetic_face_data`` builds the reference's stand-in instead, which
runs the same code path: an open icosphere patch with a FaceKernel GPMM, a
target drawn from the model and a partial target with a synthesized
occlusion.  ``run_bfm_fitting`` is the end-to-end entry point.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask, make_mesh
from icp_proposal_tpu_torch.models.gpmm import Gpmm

# the reference's data directory (``apps/bfm/Paths.scala``), relative to the
# working directory; ``load_bfm_data(data_dir=...)`` names another
BFM_DATA_DIR = Path("data") / "bfm"


def synthesize_partial_target(points: np.ndarray, cells: np.ndarray,
                              cut_center: np.ndarray, n_cut: int = 1000,
                              extra_cut_ids=()):
    """Partial-target synthesis (reference ``bfm/AlignShapes.scala:88-94``):
    remove the n_cut vertices nearest ``cut_center`` (the nose tip) plus an
    explicit id mask (the mouth), then drop dangling faces.

    → (partial_points, partial_cells, kept_ids)."""
    points = np.asarray(points)
    cells = np.asarray(cells)
    d2 = np.sum((points - np.asarray(cut_center)[None, :]) ** 2, axis=1)
    cut = np.zeros(len(points), bool)
    cut[np.argsort(d2)[: min(n_cut, len(points))]] = True
    extra = np.asarray(extra_cut_ids, np.int64)
    cut[extra[extra < len(points)]] = True
    keep_face = (~cut)[cells].all(axis=1)
    new_cells_full = cells[keep_face]
    used = np.unique(new_cells_full)
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return points[used], remap[new_cells_full].astype(np.int32), used


def align_scan(scan_points, scan_landmarks: Dict[str, np.ndarray],
               model_landmarks: Dict[str, np.ndarray], scale: float = 1e-3):
    """Scale a scan and its landmarks (the reference scales BFM scans by
    1/1000, ``AlignShapes.scala:66``), then rigidly align them to the model
    landmarks by the common names, rotating about the origin → (aligned
    points [V, 3] float32, aligned landmarks)."""
    from icp_proposal_tpu_torch.io.landmarks import common_landmarks
    from icp_proposal_tpu_torch.ops.rigid import rigid_landmark_alignment

    pts = np.asarray(scan_points, np.float64) * scale
    lms = {k: np.asarray(v, np.float64) * scale for k, v in scan_landmarks.items()}
    src, dst, _ = common_landmarks(lms, model_landmarks)
    t = rigid_landmark_alignment(src, dst, center=np.zeros(3))
    aligned = t.apply(pts.astype(np.float32))
    aligned_lms = {k: t.apply(v[None, :].astype(np.float32))[0] for k, v in lms.items()}
    return aligned, aligned_lms


def prepare_bfm_dataset(
    scans_dir: str,
    landmarks_dir: str,
    model_landmarks_path: str,
    out_dir: str,
    nose_landmark: str = "center.nose.tip",
    n_nose_cut: int = 1000,
    mouth_mask_ids=(),
    verbose: bool = True,
) -> int:
    """The BFM data preparation (reference ``bfm/AlignShapes.scala:55-101``):
    every ``.ply`` or ``.stl`` scan in ``scans_dir`` with landmarks of the
    same basename in ``landmarks_dir`` is scaled by 1/1000 and rigidly
    aligned to the model landmarks (``align_scan``), written to
    ``out_dir/aligned/{meshes,landmarks}``; where its landmarks name
    ``nose_landmark``, the partial variant (the ``n_nose_cut`` vertices
    nearest the nose tip and ``mouth_mask_ids`` cut away, the nose landmark
    dropped) goes to ``out_dir/partial/{meshes,landmarks}``.  Returns the
    number of scans prepared."""
    from icp_proposal_tpu_torch.io.landmarks import read_landmarks, write_landmarks
    from icp_proposal_tpu_torch.io.ply import read_ply
    from icp_proposal_tpu_torch.io.stl import read_stl, write_stl

    model_lms = read_landmarks(model_landmarks_path)
    for sub in ("aligned/meshes", "aligned/landmarks", "partial/meshes",
                "partial/landmarks"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    count = 0
    for fname in sorted(os.listdir(scans_dir)):
        base, ext = os.path.splitext(fname)
        if ext.lower() not in (".ply", ".stl"):
            continue
        lm_path = os.path.join(landmarks_dir, base + ".json")
        if not os.path.exists(lm_path):
            if verbose:
                print(f"skipping {fname}: no landmarks")
            continue
        reader = read_ply if ext.lower() == ".ply" else read_stl
        points, cells = reader(os.path.join(scans_dir, fname))
        lms = read_landmarks(lm_path)
        aligned, aligned_lms = align_scan(points, lms, model_lms, scale=1e-3)
        write_stl(os.path.join(out_dir, "aligned/meshes", base + ".stl"), aligned, cells)
        write_landmarks(os.path.join(out_dir, "aligned/landmarks", base + ".json"),
                        aligned_lms)

        if nose_landmark in aligned_lms:
            p_pts, p_cells, _ = synthesize_partial_target(
                aligned, cells, aligned_lms[nose_landmark],
                n_cut=n_nose_cut, extra_cut_ids=mouth_mask_ids,
            )
            partial_lms = {k: v for k, v in aligned_lms.items() if k != nose_landmark}
            write_stl(os.path.join(out_dir, "partial/meshes", base + ".stl"),
                      p_pts, p_cells)
            write_landmarks(os.path.join(out_dir, "partial/landmarks", base + ".json"),
                            partial_lms)
        count += 1
        if verbose:
            print(f"prepared {fname}")
    return count


def load_bfm_data(data_dir: str = None, target_index: int = 0,
                  model_file: str = "faceGPmodel_200c.h5",
                  device=DEFAULT_DEVICE) -> "BfmData":
    """The real BFM workload from ``data_dir`` (default ``BFM_DATA_DIR``;
    reference ``bfm/LoadTestData``): the statismo face GPMM ``model_file``
    on ``device`` (the card unless ``device="cpu"``) and the prepared target
    ``aligned/meshes/*.stl`` number ``target_index`` (sorted by name) with
    its partial variant from ``partial/meshes`` (the complete target where
    there is none).  Raises FileNotFoundError when the model or the aligned
    meshes are missing; it never substitutes the stand-in
    (``load_synthetic_face_data``)."""
    from icp_proposal_tpu_torch.io.statismo import read_statismo_gpmm
    from icp_proposal_tpu_torch.io.stl import read_stl

    device = resolve_device(device)
    data_dir = str(data_dir or BFM_DATA_DIR)
    model_path = os.path.join(data_dir, model_file)
    aligned_dir = os.path.join(data_dir, "aligned", "meshes")
    partial_dir = os.path.join(data_dir, "partial", "meshes")
    if not (os.path.exists(model_path) and os.path.isdir(aligned_dir)):
        raise FileNotFoundError(
            f"BFM assets not found under {data_dir} (license-gated download; "
            "see reference README.md:57-72). Use load_synthetic_face_data().")
    model = read_statismo_gpmm(model_path, device=device)
    targets = sorted(f for f in os.listdir(aligned_dir) if f.endswith(".stl"))
    tname = targets[target_index]
    t_pts, t_cells = read_stl(os.path.join(aligned_dir, tname))
    p_path = os.path.join(partial_dir, tname)
    if os.path.exists(p_path):
        p_pts, p_cells = read_stl(p_path)
    else:
        p_pts, p_cells = t_pts, t_cells
    return BfmData(
        model=model,
        target=make_mesh(t_pts, t_cells),
        target_partial=make_mesh(p_pts, p_cells),
        model_boundary_mask=boundary_vertex_mask(model.cells.cpu().numpy(),
                                                 model.num_points),
        target_boundary_mask=boundary_vertex_mask(t_cells, len(t_pts)),
        partial_boundary_mask=boundary_vertex_mask(p_cells, len(p_pts)),
    )


@dataclass
class BfmData:
    model: Gpmm
    target: TriangleMesh  # complete target
    target_partial: TriangleMesh
    model_boundary_mask: np.ndarray
    target_boundary_mask: np.ndarray
    partial_boundary_mask: np.ndarray


def load_synthetic_face_data(rank: int = 24, subdiv: int = 3, seed: int = 0,
                             target_coeffs=None, device=DEFAULT_DEVICE) -> BfmData:
    """The face stand-in: open-patch reference mesh (icosphere of
    ``subdiv`` subdivisions, radius 0.1, cut at z = 0.055), a FaceKernel
    GPMM of ``rank`` components from Nyström over min(4·rank, V)
    area-weighted points, a target drawn from the model, and a partial
    target without the V // 6 vertices nearest the target's highest point
    (the "nose").  The model goes to ``device`` (the card unless
    ``device="cpu"``); meshes and masks stay on the host.

    The target coefficients are ``target_coeffs`` when given, else 0.8 times
    standard normals from ``numpy.random.RandomState(seed)``.  The JAX
    package draws them with ``jax.random.normal(PRNGKey(seed))``, which this
    package cannot reproduce; pass its draw to build the same data.  At
    rank 200 and subdiv 4 this is the width of the reference's decimated
    face model: 1,977 vertices, 3,872 faces, 800 Nyström points."""
    from icp_proposal_tpu_torch.models.build_face import FaceKernel, FaceMask
    from icp_proposal_tpu_torch.models.gpmm import make_gpmm
    from icp_proposal_tpu_torch.models.nystrom import nystrom_lowrank
    from icp_proposal_tpu_torch.models.synthetic import make_open_patch
    from icp_proposal_tpu_torch.ops.surface_sampling import area_weighted_vertex_subset

    device = resolve_device(device)  # before the host build, not after
    points, cells = make_open_patch(subdivisions=subdiv, radius=0.1, z_cut=0.55)
    kernel = FaceKernel(FaceMask.trivial(len(points)), points)
    n_sample = min(4 * rank, len(points))
    sample_ids = area_weighted_vertex_subset(points, cells, n_sample, seed=seed + 1)
    points64 = np.asarray(points, np.float64)
    basis, variance = nystrom_lowrank(kernel, points64[sample_ids], points64,
                                      num_basis=rank)
    model = make_gpmm(ref_points=points, cells=cells, mean_disp=np.zeros_like(points),
                      basis=basis, variance=variance, device=device)

    if target_coeffs is None:
        target_coeffs = np.random.RandomState(seed).randn(rank) * 0.8
    alpha = np.asarray(target_coeffs, np.float32)
    sbasis = model.sbasis.cpu().numpy().reshape(3 * len(points), rank)
    mean = model.mean_disp.cpu().numpy()
    target_points = points + (mean + (sbasis @ alpha).reshape(-1, 3))

    # occlude around the "nose": the vertex with the largest z
    nose = target_points[np.argmax(target_points[:, 2])]
    p_pts, p_cells, _ = synthesize_partial_target(target_points, cells, nose,
                                                  n_cut=len(points) // 6)
    mask = boundary_vertex_mask(cells, len(points))
    return BfmData(
        model=model,
        target=make_mesh(target_points, cells),
        target_partial=make_mesh(p_pts, p_cells),
        model_boundary_mask=mask,
        target_boundary_mask=mask.copy(),
        partial_boundary_mask=boundary_vertex_mask(p_cells, len(p_pts)),
    )


def make_bfm_fitting_setup(data: BfmData, partial: bool, parity: bool = False):
    """The two BFM fitting configurations (reference
    ``BfmFittingComplete.scala:62-76`` / ``BfmFittingPartial.scala:65-83``),
    exact densities:

      proposal  = 0.4·pose mixture + 0.55·ICP(model direction, tangential 6,
                  normal 3, step 0.1, 2·rank points) + 0.05·random shape
      evaluator = complete: Euclidean model→target, σ = 3, 4·rank points
                  partial:  collective avg/max boundary-aware, symmetric,
                            σ_avg = 0.3, max rate 1.0, mean 0.1, 4·rank points

    parity=True evaluates the ICP component with the reference's own
    transition density (no ½·log det M, no relaxation Jacobian).
    → (ctx, mixture, evaluator) on the model's device."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import (
        proximity_and_collective_hausdorff_boundary_aware,
        proximity_and_independent,
    )
    from icp_proposal_tpu_torch.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_pose_proposal,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    target = data.target_partial if partial else data.target
    tmask = data.partial_boundary_mask if partial else data.target_boundary_mask
    ctx = build_target_context(target, tmask, device=model.device)
    n_icp = 2 * model.rank
    n_eval = 2 * n_icp
    mixture = MixtureProgram(
        nest(
            (0.4, mixed_random_pose_proposal()),
            (0.55, mixed_proposal_icp(
                n_points=n_icp, projection_direction="model",
                tangential_noise=6.0, noise_along_normal=3.0, step_length=0.1,
            )),
            (0.05, mixed_random_shape_proposal()),
        ),
        model, ctx, data.model_boundary_mask, parity=parity,
    )
    if partial:
        evaluator = proximity_and_collective_hausdorff_boundary_aware(
            model, ctx, mode="symmetric", sigma_avg=0.3, rate_max=1.0, mean=0.1,
            n_points=n_eval)
    else:
        evaluator = proximity_and_independent(
            model, ctx, mode="model_to_target", sigma=3.0, n_points=n_eval)
    return ctx, mixture, evaluator


def run_bfm_fitting(data: BfmData | None = None, partial: bool = False,
                    num_samples: int = 10000, n_chains: int = 1, json_path=None,
                    seed: int = 1024, verbose: bool = True, device=DEFAULT_DEVICE):
    """End-to-end BFM fitting, complete or partial (reference
    ``BfmFittingComplete`` / ``BfmFittingPartial``), through
    ``SamplingRegistration.runfitting`` → (FittingResult, data).  data: None
    builds the face stand-in (``load_synthetic_face_data()``) on ``device``
    (the card unless ``device="cpu"``); given data keeps its model's
    device."""
    from icp_proposal_tpu_torch.registration.sampling_registration import (
        SamplingRegistration,
    )

    if data is None:
        data = load_synthetic_face_data(device=device)
    target = data.target_partial if partial else data.target
    _, mixture, evaluator = make_bfm_fitting_setup(data, partial)
    reg = SamplingRegistration(data.model, target, mixture, evaluator, verbose=verbose)
    return reg.runfitting(num_samples, seed=seed, n_chains=n_chains,
                          json_path=json_path), data
