"""The probabilistic-registration chain runner.

Counterpart of ``icp_proposal_tpu/registration/sampling_registration.py``
(reference ``SamplingRegistration.scala:37-94``, ``runfitting``): runs the
MH chains in segments, drains each segment's records to the host for the
JSON log and the acceptance report, and returns the best (MAP under the
product evaluator) sample over all chains.

Each segment's records are stacked on the device and copied to pinned host
memory without blocking; the host goes on queuing the next segment and
reads a segment back only once two newer ones are queued, so the device
never holds more than two segments of records.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask
from icp_proposal_tpu_torch.registration.comparison import (
    evaluate_reconstruction_boundary_aware,
)
from icp_proposal_tpu_torch.sampling import loggers, mh
from icp_proposal_tpu_torch.sampling.evaluators import EvaluatorProgram
from icp_proposal_tpu_torch.sampling.proposals import MixtureProgram
from icp_proposal_tpu_torch.sampling.state import FitState, init_state, transformed_mesh


@dataclass
class FittingResult:
    best_state: FitState  # one chain (B = 1)
    best_log_value: float
    final_states: FitState  # [n_chains]
    json_records: list  # chain 0's records in the reference schema
    acceptance: dict  # over all chains and steps
    samples_per_sec: float
    initial_state: Optional[FitState] = None  # [n_chains], where the chains started
    records: object = field(default=None, repr=False)  # ChainRecord of [C, T, ...] arrays


def _expand(x, n: int):
    """Every tensor of a (nested) tuple of one chain, repeated for n chains."""
    if isinstance(x, torch.Tensor):
        return x.expand((n,) + tuple(x.shape[1:])).contiguous()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_expand(v, n) for v in x))
    if isinstance(x, tuple):
        return tuple(_expand(v, n) for v in x)
    return x


def _to_host(records: mh.ChainRecord):
    """Start copying a stacked segment to the host → (fields, event); the
    fields are ready once ``event`` has completed (None on the CPU)."""
    dev = records.accepted.device
    if dev.type != "cuda":
        return records, None
    fields = []
    for x in records:
        if x is None:
            fields.append(None)
            continue
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        fields.append(host)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return mh.ChainRecord(*fields), event


def _numpy(records: mh.ChainRecord) -> mh.ChainRecord:
    return mh.ChainRecord(*(None if x is None else x.numpy() for x in records))


def extract_best(records, device):
    """The best accepted sample over all chains of host records [C, T, ...]
    → (one-chain ``FitState`` on ``device`` with scale 1, its log value,
    (chain, step)); raises when no chain accepted anything."""
    acc = np.asarray(records.accepted)
    if not acc.any():
        raise ValueError("no accepted sample in any chain — cannot extract a best "
                         "(MAP) state; run longer or loosen the evaluator")
    logv = np.where(acc, np.asarray(records.log_product), -np.inf)
    c, t = np.unravel_index(np.argmax(logv), logv.shape)
    pose = np.asarray(records.pose[c, t], np.float32)

    def row(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)[None]

    state = FitState(scale=torch.ones(1, device=device), rot=row(pose[3:6]),
                     trans=row(pose[0:3]), center=row(pose[6:9]),
                     coeffs=row(records.coeffs[c, t]))
    return state, float(logv[c, t]), (int(c), int(t))


class SamplingRegistration:
    """Drives MH fitting for one model/target configuration."""

    def __init__(self, gpmm, target: TriangleMesh, mixture: MixtureProgram,
                 evaluator: EvaluatorProgram, accept_info_interval: int = 1000,
                 verbose: bool = True):
        self.gpmm = gpmm
        self.target = target
        self.mixture = mixture
        self.evaluator = evaluator
        self.accept_info_interval = accept_info_interval
        self.verbose = verbose
        self._step = mh.make_mh_step(gpmm, mixture, evaluator, store_params=True)

    def runfitting(self, num_samples: int, seed: int = 1024,
                   initial_state: Optional[FitState] = None, n_chains: int = 1,
                   json_path: Optional[str] = None, resume_log: Optional[str] = None,
                   resume_mode: str = "best") -> FittingResult:
        """Run ``num_samples`` MH steps of every chain in segments of
        min(num_samples, accept_info_interval) steps, drawing all randomness
        from a ``torch.Generator`` seeded with ``seed`` on the model's
        device.

        initial_state: one state (B = 1), whose carry is computed once and
        repeated for ``n_chains`` chains, or a state per chain (then
        ``n_chains`` is its batch).  Default: the model's initial state.
        resume_log/resume_mode: start from a previous run's JSON log, "best"
        at its MAP record, "last" at its last accepted record; an explicit
        ``initial_state`` wins over the log.  json_path: write chain 0's
        records there in the reference schema."""
        dev = self.gpmm.device
        if initial_state is None and resume_log is not None:
            initial_state = loggers.state_from_log(loggers.load_log(resume_log),
                                                   resume_mode, device=dev)
            if self.verbose:
                print(f"[resume] starting from {resume_mode} record of {resume_log}")
        state0 = initial_state if initial_state is not None else init_state(self.gpmm, 1)
        carry = mh.init_carry(self.gpmm, self.evaluator, state0, self.mixture)
        if state0.coeffs.shape[0] == 1:
            carry = _expand(carry, n_chains)
        else:
            n_chains = state0.coeffs.shape[0]
        start_state = carry.state
        segment = min(num_samples, self.accept_info_interval)
        gen = torch.Generator(device=dev).manual_seed(seed)

        host_records, json_records = [], []
        pending: deque = deque()
        done = reported = 0
        t_start = time.time()

        def pop_one():
            nonlocal reported
            recs, event, start_index = pending.popleft()
            if event is not None:
                event.synchronize()
            recs = _numpy(recs)
            host_records.append(recs)
            chain0 = mh.ChainRecord(*(None if x is None else x[0] for x in recs))
            json_records.extend(loggers.records_to_json_list(
                chain0, self.evaluator.named_keys, self.mixture.names, start_index))
            reported += recs.accepted.shape[1]
            if self.verbose:
                acc = loggers.acceptance_summary(chain0, self.mixture.names)
                rate = reported * n_chains / max(time.time() - t_start, 1e-9)
                print(f"[{reported}/{num_samples}] chains={n_chains} "
                      f"accept={acc['overall']:.3f} samples/s={rate:.1f}")

        while done < num_samples:
            n = min(segment, num_samples - done)
            carry, recs = mh.run_chains(self._step, carry, n, gen)
            pending.append((*_to_host(mh.stack_records(recs)), done))
            del recs
            done += n
            while len(pending) > 2:  # at most two segments of records in flight
                pop_one()
        while pending:
            pop_one()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.time() - t_start

        records = mh.ChainRecord(*(None if xs[0] is None else np.concatenate(xs, axis=1)
                                   for xs in zip(*host_records)))
        if json_path is not None:
            loggers.write_log(json_path, json_records)
        best_state, best_val, _ = extract_best(records, dev)
        acceptance = loggers.acceptance_summary(
            mh.ChainRecord(accepted=records.accepted.reshape(-1), named=None,
                           proposal_idx=records.proposal_idx.reshape(-1),
                           log_product=None),
            self.mixture.names)
        if self.verbose:
            gt_mask = boundary_vertex_mask(np.asarray(self.target.cells),
                                           len(self.target.points))
            evaluate_reconstruction_boundary_aware(
                "Sampling", transformed_mesh(self.gpmm, best_state), self.target, gt_mask)
        return FittingResult(
            best_state=best_state, best_log_value=best_val, final_states=carry.state,
            json_records=json_records, acceptance=acceptance,
            samples_per_sec=done * n_chains / max(elapsed, 1e-9),
            initial_state=start_state, records=records)
