"""Process-group initialisation and chain partitioning.

Counterpart of ``icp_proposal_tpu/parallel/distributed.py``.  The port runs
one process per card under ``torch.distributed``: NCCL between cards, gloo
between CPU processes.  A "host" of the JAX package is one process here,
and one card.  Chains never communicate while they step, so the only
traffic is the pooled diagnostics of ``runner.py``.
"""
from __future__ import annotations

import os
import subprocess
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device

# A rank that dies leaves the others waiting in a collective: they fail
# after this long instead of hanging.
COLLECTIVE_TIMEOUT = timedelta(seconds=300)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> torch.device:
    """Join the process group named by the arguments or by torchrun's
    variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) → this rank's device.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``).  With neither it nor ``MASTER_ADDR`` set, no group is
    created, as JAX's is a no-op without ``JAX_COORDINATOR``.  ``device``
    picks the backend: NCCL for ``"cuda"`` (the rank takes the card
    ``LOCAL_RANK``, default 0), gloo for ``"cpu"``."""
    device = resolve_device(device)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "env://"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if coordinator_address is None:
        return device
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=coordinator_address,
        world_size=(num_processes if num_processes is not None
                    else int(os.environ.get("WORLD_SIZE", "1"))),
        rank=process_id if process_id is not None else int(os.environ.get("RANK", "0")),
        timeout=COLLECTIVE_TIMEOUT,
    )
    return device


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def chain_share(total_chains: int, rank: int, world_size: int) -> tuple[int, int]:
    """(offset of the first chain, number of chains) of ``rank`` when
    ``total_chains`` are split as evenly as they go, the first ranks taking
    one more."""
    base, extra = divmod(total_chains, world_size)
    return rank * base + min(rank, extra), base + (rank < extra)


def global_chain_mesh(axis_name: str = "chains"):
    """The chain mesh over every rank of the process group."""
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh

    return make_chain_mesh(axis_name=axis_name)


def chains_for_host(total_chains: int) -> int:
    """Chains this process (one card) should initialise: the global batch is
    split evenly over the ranks of the default process group."""
    return chain_share(total_chains, *_rank_and_world())[1]


def run_ranks(commands, timeout: float, log_dir, cwd=None, envs=None) -> list[str]:
    """Start one process per command (rank i runs ``commands[i]`` with
    environment ``envs[i]``, default this one's), its output to
    ``log_dir/rank{i}.log``, and wait for all of them within ``timeout``
    seconds in all → their outputs.  When one exits non-zero or the time
    runs out, every rank still running is killed and this raises with the
    output of a failed rank."""
    logs = [Path(log_dir) / f"rank{i}.log" for i in range(len(commands))]
    procs = []
    try:
        for i, cmd in enumerate(commands):
            with open(logs[i], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, cwd=cwd, env=None if envs is None else envs[i],
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                i = failed[0]
                raise RuntimeError(f"rank {i} exited with {codes[i]}:\n"
                                   + logs[i].read_text()[-4000:])
            if all(c == 0 for c in codes):
                return [log.read_text() for log in logs]
            if time.monotonic() > deadline:
                late = [i for i, c in enumerate(codes) if c is None]
                raise RuntimeError(f"ranks {late} did not finish within {timeout} s:\n"
                                   + logs[late[0]].read_text()[-4000:])
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
