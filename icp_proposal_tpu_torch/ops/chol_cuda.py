"""K1 ``chol_solve`` and K2 ``tri_solve_lt``: wrappers and plain twins.

Counterpart of ``icp_proposal_tpu/ops/chol_pallas.py``.  The kernels are in
``csrc/chol.cu``, whose header says what bounds each on the H100 and how its
layout answers that.  Chains are the leading dimension of every argument.

Dispatch: a tensor on the CPU takes the plain PyTorch twin; a tensor on a
CUDA device launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches (the plain twin does not count).
"""
from __future__ import annotations

import torch

from icp_proposal_tpu_torch._build import check_tensor, kernel_device, launch

MAX_SMEM_BYTES = 227 * 1024  # a block's shared-memory ceiling on sm_90


def _chol_smem_bytes(r: int) -> int:
    """Shared memory K1 needs: the matrix at row stride r|1, plus two vectors
    (as chol_smem_bytes in csrc/chol.cu)."""
    return (r * (r | 1) + 2 * r) * 4


def chol_solve_plain(m: torch.Tensor, rhs: torch.Tensor):
    """(L, M⁻¹·rhs, log det M) per chain; a chain whose M is not SPD gets NaN
    in all three, as the reference's ``jnp.linalg.cholesky`` path does."""
    chol, info = torch.linalg.cholesky_ex(m)
    x = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    bad = info != 0
    nan = torch.full((), float("nan"), dtype=m.dtype, device=m.device)
    return (torch.where(bad[:, None, None], nan, chol).contiguous(),
            torch.where(bad[:, None], nan, x),
            torch.where(bad, nan, logdet))


def chol_solve(m: torch.Tensor, rhs: torch.Tensor):
    """Per chain, for SPD M [B, r, r] and rhs [B, r] (float32, contiguous):
    → (L [B, r, r] lower with zeros above the diagonal, x = M⁻¹·rhs [B, r],
    log det M [B]).  On CUDA a pivot ≤ 0 makes that chain's factor NaN from
    the pivot's column on (and x, log det NaN).

    Kernel K1 (``csrc/chol.cu``) replaces ``_chol_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by latency and
    block-wide barriers (r dependent pivot steps), not bytes; one block per
    chain keeps the matrix in shared memory so each step is two barriers
    and no device-memory traffic."""
    check_tensor(m, "m", torch.float32, (None, None, None))
    bsz, r = m.shape[0], m.shape[1]
    check_tensor(m, "m", torch.float32, (bsz, r, r))
    check_tensor(rhs, "rhs", torch.float32, (bsz, r))
    dev = kernel_device(m, rhs)
    if dev.type == "cpu":
        return chol_solve_plain(m, rhs)
    if _chol_smem_bytes(r) > MAX_SMEM_BYTES:
        raise ValueError(
            f"chol_solve needs {_chol_smem_bytes(r)} B of shared memory at r={r}, "
            f"over the {MAX_SMEM_BYTES} B a block holds (r ≤ 239)")
    l = torch.empty_like(m)
    x = torch.empty_like(rhs)
    logdet = torch.empty(bsz, dtype=torch.float32, device=dev)
    launch("icp_chol_solve", dev, m.data_ptr(), rhs.data_ptr(), l.data_ptr(),
           x.data_ptr(), logdet.data_ptr(), bsz, r)
    chol_solve.launches += 1
    return l, x, logdet


chol_solve.launches = 0


def tri_solve_lt_plain(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x with Lᵀx = z per chain, dividing by max(Lⱼⱼ, 1e-30)."""
    guarded = chol.clone()
    diag = guarded.diagonal(dim1=-2, dim2=-1)
    diag.copy_(torch.clamp_min(diag, 1e-30))
    return torch.linalg.solve_triangular(
        guarded.transpose(-1, -2), z[..., None], upper=True)[..., 0]


def tri_solve_lt(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀx = z for lower L [B, r, r] and z [B, r] (float32,
    contiguous) → x [B, r]: the posterior draw α* = α̂ + L⁻ᵀz.

    Kernel K2 (``csrc/chol.cu``) replaces ``_tri_lt_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by the latency of r
    dependent row reads; one warp per chain walks the rows of L with
    coalesced loads and no block barrier."""
    check_tensor(chol, "chol", torch.float32, (None, None, None))
    bsz, r = chol.shape[0], chol.shape[1]
    check_tensor(chol, "chol", torch.float32, (bsz, r, r))
    check_tensor(z, "z", torch.float32, (bsz, r))
    dev = kernel_device(chol, z)
    if dev.type == "cpu":
        return tri_solve_lt_plain(chol, z)
    x = torch.empty_like(z)
    launch("icp_tri_solve_lt", dev, chol.data_ptr(), z.data_ptr(), x.data_ptr(),
           bsz, r)
    tri_solve_lt.launches += 1
    return x


tri_solve_lt.launches = 0
