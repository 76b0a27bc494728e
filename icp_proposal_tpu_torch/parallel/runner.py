"""Chains sharded over the ranks of a process group.

Counterpart of ``icp_proposal_tpu/parallel/runner.py``.  The reference's
only parallelism is independent chains on JVM threads
(``RunMHRandomInitComparison.scala:66-86``; SURVEY §5.8).  Here:

    chains       → the batch dimension of one step on a card, split over
                   one process per card (``torch.distributed``)
    collectives  → only the pooled diagnostics: acceptance, coefficient
                   moments, R̂/ESS moment sums, one ``all_reduce`` each

The model and target are built on every rank; each rank steps its own
chains.  Every rank draws the noise of the whole batch each step from one
generator seeded alike and keeps its own rows, so a chain takes the same
steps however the batch is sharded: the sharded run equals ``mh.run_chains``
over the whole batch with the same seed, chain for chain.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.parallel.distributed import chain_share
from icp_proposal_tpu_torch.sampling import mh
from icp_proposal_tpu_torch.sampling.diagnostics import (
    _all_reduce,
    pooled_ess,
    pooled_split_rhat,
)


class PooledStats(NamedTuple):
    """Cross-chain pooled diagnostics, the same on every rank."""

    acceptance: torch.Tensor  # [] pooled mean acceptance after burn-in
    coeff_mean: torch.Tensor  # [r] pooled mean of the final coefficients
    coeff_var: torch.Tensor  # [r] pooled variance (between + within chains)
    log_post_mean: torch.Tensor  # []
    # over the post-burn-in coefficient traces (only when the step records
    # coefficients, store_params=True)
    rhat: Optional[torch.Tensor] = None  # [k] split-R̂ of the first k coefficients
    ess: Optional[torch.Tensor] = None  # [] ESS of coefficient 0


class ChainMesh(NamedTuple):
    """The ranks that share a batch of chains: the process group (None for
    one process with no group: no collective runs), this rank, their
    number and this rank's device."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device

    def chain_rows(self, total_chains: int) -> slice:
        """This rank's chains in the global batch of ``total_chains``: from
        the offset of its first chain, ``distributed.chains_for_host``'s
        split."""
        offset, n = chain_share(total_chains, self.rank, self.world_size)
        return slice(offset, offset + n)


def make_chain_mesh(devices=None, axis_name: str = "chains") -> ChainMesh:
    """The chain mesh over the default process group, or over this process
    alone when none is initialised.  ``devices``: one device per rank (rank
    i takes ``devices[i]``), default the current card.  ``axis_name`` is
    kept for the reference's signature: the collectives run over the
    group."""
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    if devices is None:
        resolve_device(DEFAULT_DEVICE)  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = resolve_device(devices[rank])
    return ChainMesh(group, rank, world, device)


def pooled_stats(final: mh.MhCarry, records: mh.ChainRecord, burn_in: int = 0,
                 diag_coeffs: int = 8, diag_max_lag: int = 100, group=None) -> PooledStats:
    """Pool this rank's final carry and records [C_local, T, ...] with every
    rank's of ``group`` (None: the default group when one is initialised,
    else no collective): acceptance over the steps after ``burn_in``, mean
    and variance (E[x²] − E[x]²) of the final coefficients, mean final log
    posterior, all from sums and counts that one all_reduce adds; split-R̂
    of the first ``diag_coeffs`` coefficients and ESS of coefficient 0 over
    ``records.coeffs[:, burn_in:]`` when the records hold coefficients."""
    acc = records.accepted[:, burn_in:].to(torch.float32)
    coeffs = final.state.coeffs
    r = coeffs.shape[1]
    sums = torch.cat([
        torch.stack([acc.sum(), acc.new_tensor(acc.numel()),
                     final.log_post.sum(), acc.new_tensor(coeffs.shape[0])]),
        coeffs.sum(dim=0), (coeffs * coeffs).sum(dim=0)])
    _all_reduce(sums, group)
    n = sums[3]
    mean = sums[4:4 + r] / n
    var = sums[4 + r:] / n - mean * mean
    rhat = ess = None
    if records.coeffs is not None:
        tail = records.coeffs[:, burn_in:, :diag_coeffs]
        rhat = pooled_split_rhat(tail, group)
        ess = pooled_ess(tail[..., 0], group, max_lag=diag_max_lag)
    return PooledStats(sums[0] / sums[1], mean, var, sums[2] / n, rhat, ess)


def _rows(noise: mh.StepNoise, start: int, n: int) -> mh.StepNoise:
    return mh.StepNoise(*(x[start:start + n] for x in noise))


def run_sharded_chains(step, carries: mh.MhCarry, keys, n_steps: int, mesh: ChainMesh,
                       axis_name: str = "chains", burn_in: int = 0,
                       diag_coeffs: int = 8, segment_steps: int | None = None,
                       diag_max_lag: int = 100):
    """Run this rank's chains ``carries`` for ``n_steps`` → (final carry,
    records [C_local, T, ...] as one ``ChainRecord``, ``PooledStats`` over
    every rank's chains).

    ``step`` comes from ``mh.make_mh_step``; ``keys`` is the run's seed (an
    int, or a ``torch.Generator`` on ``mesh.device``).  Each step draws the
    global batch's ``StepNoise`` and takes this rank's rows; the ranks hold
    consecutive blocks of chains in rank order (``chains_for_host``'s
    split).  ``records.coeffs`` is the post-step chain state, so R̂ and ESS
    are diagnostics of the held Markov chain.  ``segment_steps`` bounds how
    many steps of per-step records are held before they are stacked; the
    results do not depend on it.  With no process group (one process) no
    collective runs; ``axis_name`` is kept for the reference's signature."""
    n_local = carries.log_post.shape[0]
    counts = torch.tensor([n_local], device=mesh.device)
    if mesh.group is not None:
        dist.all_reduce(counts, group=mesh.group)
    total = int(counts[0])
    offset, share = chain_share(total, mesh.rank, mesh.world_size)
    if share != n_local:
        raise ValueError(f"rank {mesh.rank} holds {n_local} chains; the split of "
                         f"{total} over {mesh.world_size} ranks gives it {share}")
    gen = keys
    if not isinstance(keys, torch.Generator):
        gen = torch.Generator(device=mesh.device).manual_seed(int(keys))

    carry, segments, pending = carries, [], []
    for i in range(n_steps):
        noise = mh.draw_noise(step.mixture, total, gen)
        carry, rec = step(carry, _rows(noise, offset, n_local))
        pending.append(rec)
        if len(pending) == (segment_steps or n_steps) or i == n_steps - 1:
            segments.append(mh.stack_records(pending))
            pending = []
    records = mh.ChainRecord(*(None if parts[0] is None else torch.cat(parts, dim=1)
                               for parts in zip(*segments)))
    stats = pooled_stats(carry, records, burn_in, diag_coeffs, diag_max_lag, mesh.group)
    return carry, records, stats
