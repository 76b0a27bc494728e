"""Chain replay and posterior re-analysis from JSON logs.

Counterpart of ``icp_proposal_tpu/analysis/replay.py``: headless
equivalents of the reference's ``apps/femur/ReplayFittingFromLog.scala`` and
``apps/femur/PosteriorVariabilityToMeshColor.scala`` (and the BFM
variants), with the UI rendering replaced by exported artifacts (mesh
snapshots and per-vertex scalar fields).  The replayed states are decoded
as one batch [S] on the model's device, in one ``transformed_points`` call;
the JAX package decodes them one by one, so the points may differ from its
in summation order only.
"""
from __future__ import annotations

import os
from typing import List, Optional

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE
from icp_proposal_tpu_torch.sampling import loggers
from icp_proposal_tpu_torch.sampling.mh import stack_states
from icp_proposal_tpu_torch.sampling.state import transformed_points


def replay_states(json_records: List[dict], stride: int = 10,
                  device=DEFAULT_DEVICE) -> List:
    """Walk the log with the given stride, backing up to the nearest
    accepted record, and rebuild each chain state (reference
    ``ReplayFittingFromLog.scala:54-66``) → one-chain ``FitState``s (B = 1)
    on ``device`` (the card unless ``device="cpu"``)."""
    states = []
    for i in range(0, len(json_records), stride):
        j = i
        while j > 0 and not json_records[j]["status"]:
            j -= 1
        if json_records[j]["status"]:
            states.append(loggers.sample_to_state(json_records[j], device=device))
    return states


def _decode(gpmm, states):
    """One-chain states → their posed meshes' points [S, V, 3], decoded as
    one batch on the model's device."""
    return transformed_points(gpmm, stack_states(states))


def replay_meshes(gpmm, json_records: List[dict], stride: int = 10):
    """The posed mesh snapshots along the chain, host arrays [V, 3]."""
    states = replay_states(json_records, stride, device=gpmm.device)
    if not states:
        return []
    return list(_decode(gpmm, states).cpu().numpy())


def posterior_analysis(
    gpmm,
    json_records: List[dict],
    burn_in: int = 200,
    take_every_n: int = 50,
    out_dir: Optional[str] = None,
):
    """The posterior-variability pipeline (reference
    ``PosteriorVariabilityToMeshColor.scala:30-65``): thin the log, decode
    the sample meshes on the model's device, compute the MAP mesh, the mean
    mesh and the total and normal variability maps → dict of host arrays;
    with ``out_dir``, write ``map.stl``, ``mean.stl``,
    ``variability_total.ply`` and ``variability_normal.ply`` there."""
    from icp_proposal_tpu_torch.analysis.posterior_variability import (
        variability_map_normal,
        variability_map_total,
    )

    thinned = loggers.samples_from_log(json_records, take_every_n=take_every_n,
                                       burn_in=burn_in)
    if not thinned:
        raise ValueError("no accepted samples after burn-in/thinning")
    dev = gpmm.device
    sample_points = _decode(gpmm, [loggers.sample_to_state(r, device=dev) for r in thinned])
    map_state = loggers.sample_to_state(loggers.best_fitting_record(json_records),
                                        device=dev)
    map_points = transformed_points(gpmm, map_state)[0]

    result = {
        "num_samples": len(thinned),
        "map_points": map_points.cpu().numpy(),
        "mean_points": sample_points.mean(dim=0).cpu().numpy(),
        "variability_total": variability_map_total(sample_points).cpu().numpy(),
        "variability_normal": variability_map_normal(sample_points,
                                                     gpmm.cells).cpu().numpy(),
    }
    if out_dir is not None:
        from icp_proposal_tpu_torch.io.scalar_field import write_scalar_field_ply
        from icp_proposal_tpu_torch.io.stl import write_stl

        os.makedirs(out_dir, exist_ok=True)
        cells = gpmm.cells.cpu().numpy()
        write_stl(os.path.join(out_dir, "map.stl"), result["map_points"], cells)
        write_stl(os.path.join(out_dir, "mean.stl"), result["mean_points"], cells)
        for name in ("variability_total", "variability_normal"):
            write_scalar_field_ply(os.path.join(out_dir, f"{name}.ply"),
                                   result["mean_points"], cells, result[name])
    return result
