"""The posterior-evidence tools: the counterparts of the repository's
``tools/`` scripts that show, at femur scale, that the sampler is right.

One module a tool, under the JAX tool's file name, each run as

    python3 -m icp_proposal_tpu_torch.tools.<name> [--device cpu] [--out PATH]

``validate_index`` (the shortlist index against the dense kernel),
``mixing_sweep`` (acceptance and ESS over proposal configurations),
``posterior_parity`` (long runs of the exact and parity samplers),
``quality_run`` and ``quality_bfm`` (10k-sample fitting rows),
``converged_run`` (rounds until split-R̂ falls below a target),
``reference_baseline_port`` (the numpy sampler and CPU baseline) and
``crossimpl_parity`` (that sampler against the port's chains).

They run on the card unless given ``--device cpu`` (``device="cpu"``).  The
femur tools take the stand-in femur (``apps/femur.load_standin_femur_data``)
unless ``--data-dir`` names the real assets.  Every output goes under
``build/evidence/`` of the checkout by default, never under ``artifacts/``:
the stand-in's source meshes live there.  The JSON keys are those of the
JAX tools' artifacts.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE

EVIDENCE_DIR = Path(__file__).resolve().parents[2] / "build" / "evidence"


def add_common_args(ap, out: str):
    """The arguments every femur tool shares: ``--components`` (default 50,
    the JAX tools' width), ``--data-dir``, ``--device`` and ``--out``, by
    default the file ``out`` under ``EVIDENCE_DIR``."""
    ap.add_argument("--components", type=int, default=50)
    ap.add_argument("--data-dir", default=None,
                    help="directory of the real femur assets; without it the "
                         "stand-in femur is used")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (the card) or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--out", default=str(EVIDENCE_DIR / out))


def femur_data(components: int, data_dir=None, device=DEFAULT_DEVICE):
    """The real femur from ``data_dir``, else the stand-in GPMM of
    ``components`` components."""
    from icp_proposal_tpu_torch.apps.femur import load_femur_data, load_standin_femur_data

    if data_dir:
        return load_femur_data(components, data_dir, device=device)
    return load_standin_femur_data(device=device, model_components=components)


def write_json(path, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def warm_up(step, carry) -> None:
    """One untimed step from ``carry`` with a throwaway generator, result
    dropped and waited for: the first launches build and load the kernels."""
    dev = carry.log_post.device
    step(carry, generator=torch.Generator(device=dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def surface_avg_dist(model, ctx, state) -> np.ndarray:
    """Mean point→target-surface distance of each chain's mesh [B] (the
    dense kernel K5 over the context's surface), on the host."""
    from icp_proposal_tpu_torch.ops.closest_point import surface_distances_auto
    from icp_proposal_tpu_torch.sampling.state import transformed_points

    pts = transformed_points(model, state).contiguous()
    d2, _ = surface_distances_auto(pts, ctx.points, ctx.cells.to(torch.int32))
    return torch.sqrt(d2).mean(dim=1).cpu().numpy()
