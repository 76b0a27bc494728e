"""Convergence diagnostics: split R-hat and effective sample size.

Counterpart of ``icp_proposal_tpu/sampling/diagnostics.py``: torch
reductions over chains [C, T, ...] on whatever device the chains lie on.
The pooled variants (``pooled_split_rhat``, ``pooled_ess``) compute the same
quantities over the chains of every rank of a process group from per-rank
moment sums and one ``all_reduce``; the traces never leave their rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def split_rhat(chains: torch.Tensor) -> torch.Tensor:
    """Split-R̂ (Gelman et al.): chains [C, T, ...] → R̂ [...].  Each chain is
    split in half, giving 2C sequences; R̂ = sqrt(V̂ / W)."""
    t2 = chains.shape[1] // 2
    halves = torch.cat([chains[:, :t2], chains[:, t2:2 * t2]], dim=0)
    n = t2
    chain_means = torch.mean(halves, dim=1)  # [2C, ...]
    chain_vars = torch.var(halves, dim=1, correction=1)
    w = torch.mean(chain_vars, dim=0)
    b = n * torch.var(chain_means, dim=0, correction=1)
    var_hat = (n - 1) / n * w + b / n
    return torch.sqrt(var_hat / torch.clamp_min(w, 1e-20))


def ess(chains: torch.Tensor, max_lag: int = 100) -> torch.Tensor:
    """Effective sample size by Geyer's initial positive sequence of
    autocorrelations, truncated at the first negative one: chains
    [C, T, ...] → ESS [...]."""
    c, t = chains.shape[0], chains.shape[1]
    x = chains - torch.mean(chains, dim=1, keepdim=True)
    var = torch.mean(torch.var(chains, dim=1, correction=1), dim=0)
    rhos = torch.stack([
        torch.mean(torch.mean(x[:, :t - lag] * x[:, lag:], dim=1), dim=0)
        / torch.clamp_min(var, 1e-20)
        for lag in range(1, min(max_lag, t - 1) + 1)])  # [L, ...]
    positive = torch.cumprod((rhos > 0).to(rhos.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(rhos * positive, dim=0)
    return c * t / torch.clamp_min(tau, 1.0)


def pooled_acceptance(accepted: torch.Tensor) -> torch.Tensor:
    """Mean acceptance over all chains and steps."""
    return torch.mean(accepted.to(torch.float32))


# ---------------------------------------------------------------------------
# Pooled over a process group: each rank sums its chains' moments, one
# all_reduce adds the sums (JAX: ``psum`` over a mesh axis).  ``group=None``
# is the default group when one is initialised; with no process group there
# is no collective and the functions equal ``split_rhat`` / ``ess``.
# ---------------------------------------------------------------------------


def _all_reduce(sums: torch.Tensor, group) -> torch.Tensor:
    if group is not None or (dist.is_available() and dist.is_initialized()):
        dist.all_reduce(sums, group=group)
    return sums


def pooled_split_rhat(chains: torch.Tensor, group=None) -> torch.Tensor:
    """Split-R̂ over the chains of every rank: chains [C_local, T, ...] →
    R̂ [...], equal to ``split_rhat`` of the gathered chains.  One
    all_reduce of the half-chain count, the sums of the half-chain means and
    of their squares, and the sum of the within-half variances."""
    t2 = chains.shape[1] // 2
    halves = torch.cat([chains[:, :t2], chains[:, t2:2 * t2]], dim=0)
    n = t2
    chain_means = torch.mean(halves, dim=1)  # [2C_local, ...]
    chain_vars = torch.var(halves, dim=1, correction=1)
    rest = chain_means.shape[1:]
    sums = _all_reduce(torch.cat([
        chain_means.new_tensor([halves.shape[0]]),
        torch.sum(chain_means, dim=0).flatten(),
        torch.sum(chain_means * chain_means, dim=0).flatten(),
        torch.sum(chain_vars, dim=0).flatten()]), group)
    m = sums[0]
    s1, s2, var_sum = sums[1:].reshape(3, *rest)
    w = var_sum / m
    gmean = s1 / m
    b = n * (s2 - m * gmean * gmean) / (m - 1.0)
    var_hat = (n - 1) / n * w + b / n
    return torch.sqrt(var_hat / torch.clamp_min(w, 1e-20))


def pooled_ess(chains: torch.Tensor, group=None, max_lag: int = 100) -> torch.Tensor:
    """Geyer initial-positive-sequence ESS over the chains of every rank:
    chains [C_local, T, ...] → ESS [...], equal to ``ess`` of the gathered
    chains.  One all_reduce of the chain count, the sum of the within-chain
    variances and the [L, ...] sums of the lag autocovariances."""
    c_local, t = chains.shape[0], chains.shape[1]
    x = chains - torch.mean(chains, dim=1, keepdim=True)
    rest = chains.shape[2:]
    lags = range(1, min(max_lag, t - 1) + 1)
    rho_sums = torch.stack([torch.sum(torch.mean(x[:, :t - lag] * x[:, lag:], dim=1), dim=0)
                            for lag in lags])  # [L, ...]
    var_sum = torch.sum(torch.var(chains, dim=1, correction=1), dim=0)
    sums = _all_reduce(torch.cat([
        chains.new_tensor([c_local]), var_sum.flatten(), rho_sums.flatten()]), group)
    c_total = sums[0]
    var = sums[1:1 + var_sum.numel()].reshape(rest) / c_total
    rhos = (sums[1 + var_sum.numel():].reshape(len(lags), *rest) / c_total
            / torch.clamp_min(var, 1e-20))
    positive = torch.cumprod((rhos > 0).to(rhos.dtype), dim=0)
    tau = 1.0 + 2.0 * torch.sum(rhos * positive, dim=0)
    return c_total * t / torch.clamp_min(tau, 1.0)
