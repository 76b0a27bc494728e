"""Chain trace logging in the reference's JSON record schema.

Counterpart of ``icp_proposal_tpu/sampling/loggers.py`` (numpy and json;
the reference's ``JSONAcceptRejectLogger.scala:35,93-106``): each record
carries index, proposal name, all named evaluator values, accept status,
the 9 rigid parameters and the shape coefficients for accepted samples
(rejected records carry empty arrays) and a timestamp.  The log is the
resume format: ``state_from_log`` rebuilds a ``FitState`` from it.
"""
from __future__ import annotations

import json
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.sampling.state import FitState


def records_to_json_list(records, named_keys: Sequence[str],
                         proposal_names: Sequence[str], start_index: int = 0) -> List[dict]:
    """One chain's records, stacked over steps (leading axis = steps, host
    arrays), → the reference's record list.  Accepted records carry
    rigid = [t(3), rot(3), center(3)] and coeff; rejected ones empty arrays."""
    acc = np.asarray(records.accepted)
    idx = np.asarray(records.proposal_idx)
    named = np.asarray(records.named, dtype=np.float64)
    coeffs = None if records.coeffs is None else np.asarray(records.coeffs, np.float64)
    pose = None if records.pose is None else np.asarray(records.pose, np.float64)
    now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    out = []
    for t in range(acc.shape[0]):
        accepted = bool(acc[t])
        out.append({
            "index": start_index + t,
            "name": proposal_names[int(idx[t])],
            "logvalue": {k: float(named[t, j]) for j, k in enumerate(named_keys)},
            "status": accepted,
            "rigid": [float(x) for x in pose[t]] if accepted and pose is not None else [],
            "coeff": ([float(x) for x in coeffs[t]]
                      if accepted and coeffs is not None else []),
            "datetime": now,
        })
    return out


def write_log(path, json_records: List[dict]) -> None:
    with open(path, "w") as f:
        json.dump(json_records, f, indent=2)


def load_log(path) -> List[dict]:
    with open(path) as f:
        return json.load(f)


def sample_to_state(record: dict, center_default=None, device=DEFAULT_DEVICE) -> FitState:
    """An accepted record → a one-chain ``FitState`` (B = 1) on ``device``
    (the card unless ``device="cpu"``), scale 1 (reference
    ``sampleToModelParameters``).  The record carries the rotation center;
    ``center_default`` is accepted for the reference's signature and, as
    there, never read."""
    device = resolve_device(device)
    r = np.asarray(record["rigid"], np.float32)

    def row(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)[None]

    return FitState(scale=torch.ones(1, device=device), rot=row(r[3:6]),
                    trans=row(r[0:3]), center=row(r[6:9]), coeffs=row(record["coeff"]))


def best_fitting_record(json_records: List[dict]) -> dict:
    """Argmax of logvalue["product"] over accepted records (reference
    ``getBestFittingParsFromJSON``)."""
    accepted = [r for r in json_records if r["status"]]
    if not accepted:
        raise ValueError("no accepted samples in log")
    return max(accepted, key=lambda r: r["logvalue"]["product"])


def state_from_log(json_records: List[dict], mode: str = "best",
                   device=DEFAULT_DEVICE) -> FitState:
    """A resume state (B = 1) from a chain log: mode "best" takes the
    MAP-under-product accepted record, "last" the last accepted record,
    which is the chain's state at the end of the log."""
    if mode == "best":
        return sample_to_state(best_fitting_record(json_records), device=device)
    if mode == "last":
        accepted = [r for r in json_records if r["status"]]
        if not accepted:
            raise ValueError("no accepted samples in log")
        return sample_to_state(accepted[-1], device=device)
    raise ValueError(f"unknown resume mode {mode!r} (want 'best' or 'last')")


def samples_from_log(json_records: List[dict], take_every_n: int = 50,
                     total: Optional[int] = None, burn_in: int = 100) -> List[dict]:
    """Thinning for posterior analysis: stride backwards to the nearest
    accepted record (reference ``LogHelper.samplesFromLog``)."""
    total = total if total is not None else len(json_records)
    picked = []
    for i in range(burn_in, min(total, len(json_records)), take_every_n):
        j = i
        while j > 0 and not json_records[j]["status"]:
            j -= 1
        if json_records[j]["status"]:
            picked.append(json_records[j])
    return picked


def acceptance_summary(records, proposal_names: Sequence[str],
                       window: int = 100) -> Dict[str, float]:
    """Acceptance rates of one chain's stacked records (host arrays):
    overall, per proposal, and over the trailing window (reference
    ``printAcceptInfo``)."""
    acc = np.asarray(records.accepted, dtype=np.float64)
    idx = np.asarray(records.proposal_idx)
    out = {"overall": float(acc.mean())}
    for i, name in enumerate(proposal_names):
        sel = idx == i
        out[name] = float(acc[sel].mean()) if sel.any() else float("nan")
    tail_acc = acc[-window:]
    tail_idx = idx[-window:]
    out[f"last{window}"] = float(tail_acc.mean())
    for i, name in enumerate(proposal_names):
        sel = tail_idx == i
        if sel.any():
            out[f"last{window}/{name}"] = float(tail_acc[sel].mean())
    return out
