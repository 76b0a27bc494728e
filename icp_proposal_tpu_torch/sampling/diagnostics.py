"""Convergence diagnostics: split R-hat and effective sample size.

Counterpart of ``icp_proposal_tpu/sampling/diagnostics.py``: torch
reductions over chains [C, T, ...] on whatever device the chains lie on.
The collective-pooled variants (``pooled_split_rhat``, ``pooled_ess``) come
with the multi-GPU slice.
"""
from __future__ import annotations

import torch


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
