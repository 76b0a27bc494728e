"""Coarse timing: the reference's wall-clock prints.

Counterpart of ``wall_timer`` in ``icp_proposal_tpu/utils/profiling.py``
(reference ``IcpProposalRegistration.scala:41-46``).
Per-kernel device time comes from ``icp_proposal_tpu_torch.profile_step``.
"""
from __future__ import annotations

import contextlib
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def wall_timer(tag: str = "ICP", verbose: bool = True, device=None):
    """Time the block and print the reference's ``{tag}-Timing: N sec``;
    the seconds go into the yielded dict as ``"seconds"``.  With a CUDA
    ``device`` the card is synchronized before each clock reading, so the
    time covers the block's device work, not only its launches."""
    _sync(device)
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        _sync(device)
        holder["seconds"] = time.perf_counter() - t0
        if verbose:
            print(f"{tag}-Timing: {holder['seconds']} sec")

