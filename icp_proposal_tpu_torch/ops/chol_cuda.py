"""K1 ``chol_solve``, K2 ``tri_solve_lt`` and their blocked forms K6
``chol_solve_blocked`` and K7 ``tri_solve_lt_blocked``: wrappers and plain
twins.

Counterpart of ``icp_proposal_tpu/ops/chol_pallas.py``.  The kernels are in
``csrc/chol.cu``, whose header says what bounds each on the H100 and how its
layout answers that.  Chains are the leading dimension of every argument.

Dispatch: a tensor on the CPU takes the plain PyTorch twin; a tensor on a
CUDA device launches a kernel or raises.  On the card ``chol_solve`` and
``tri_solve_lt`` route by the reference's own rule (``uses_blocked``): the
monolithic K1/K2 up to rank 104, the blocked K6/K7 from rank 105 on.
``<wrapper>.launches`` counts that wrapper's kernel launches (the plain
twin does not count).
"""
from __future__ import annotations

import torch

from icp_proposal_tpu_torch._build import check_tensor, kernel_device, launch

MAX_SMEM_BYTES = 227 * 1024  # a block's shared-memory ceiling on sm_90


def _pick_bl(r: int) -> int | None:
    """Copy of the reference's lanes-per-program rule for its monolithic
    kernels (``chol_pallas._pick_bl``): None when even 128 chains of
    [r, r] float32 overflow its VMEM budget."""
    budget = 11 * 2 ** 20 / (2 * 4 * r * r)
    bl = 128 * int(budget // 128)
    if bl < 128:
        return None
    return int(min(512, bl))


def uses_blocked(r: int) -> bool:
    """The reference's routing: blocked kernels where ``_pick_bl`` of r
    rounded up to 8 is None, i.e. from rank 105 on (rank 101 → monolithic,
    rank 200 → blocked)."""
    return _pick_bl(-(-r // 8) * 8) is None


def _chol_args(m: torch.Tensor, rhs: torch.Tensor):
    check_tensor(m, "m", torch.float32, (None, None, None))
    bsz, r = m.shape[0], m.shape[1]
    check_tensor(m, "m", torch.float32, (bsz, r, r))
    check_tensor(rhs, "rhs", torch.float32, (bsz, r))
    return bsz, r, kernel_device(m, rhs)


def _tri_args(chol: torch.Tensor, z: torch.Tensor):
    check_tensor(chol, "chol", torch.float32, (None, None, None))
    bsz, r = chol.shape[0], chol.shape[1]
    check_tensor(chol, "chol", torch.float32, (bsz, r, r))
    check_tensor(z, "z", torch.float32, (bsz, r))
    return bsz, r, kernel_device(chol, z)


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


def chol_solve(m: torch.Tensor, rhs: torch.Tensor, blocked: bool | None = None):
    """Per chain, for SPD M [B, r, r] and rhs [B, r] (float32, contiguous):
    → (L [B, r, r] lower with zeros above the diagonal, x = M⁻¹·rhs [B, r],
    log det M [B]).  On CUDA a pivot ≤ 0 makes that chain's factor NaN from
    the pivot's column on (and x, log det NaN).  ``blocked`` None routes by
    ``uses_blocked(r)``; True or False forces K6 or K1 (K1 takes r ≤ 239).

    Kernel K1 (``csrc/chol.cu``) replaces ``_chol_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by latency and
    block-wide barriers (r dependent pivot steps), not bytes; one block per
    chain keeps the matrix in shared memory so each step is two barriers
    and no device-memory traffic."""
    bsz, r, dev = _chol_args(m, rhs)
    if dev.type == "cpu":
        return chol_solve_plain(m, rhs)
    if uses_blocked(r) if blocked is None else blocked:
        return chol_solve_blocked(m, rhs)
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


def _blocked_smem_bytes(r: int) -> int:
    """Shared memory K6 needs: a [r, 33] panel, the [32, r|1] row block of L
    and two vectors (as chol_blocked_smem_bytes in csrc/chol.cu)."""
    return (r * 33 + 32 * (r | 1) + 2 * r) * 4


def chol_solve_blocked(m: torch.Tensor, rhs: torch.Tensor):
    """``chol_solve`` through the blocked kernel, same contract.

    Kernel K6 (``csrc/chol.cu``) replaces ``_chol_blocked_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by the r dependent pivot
    steps, as K1; one block per chain holds one 32-column panel (54 KB at
    r = 200 against K1's 161 KB), so four chains per SM are in flight."""
    bsz, r, dev = _chol_args(m, rhs)
    if dev.type == "cpu":
        return chol_solve_plain(m, rhs)
    if _blocked_smem_bytes(r) > MAX_SMEM_BYTES:
        raise ValueError(f"chol_solve_blocked needs {_blocked_smem_bytes(r)} B of "
                         f"shared memory at r={r}, over {MAX_SMEM_BYTES} B")
    l = torch.empty_like(m)
    x = torch.empty_like(rhs)
    logdet = torch.empty(bsz, dtype=torch.float32, device=dev)
    launch("icp_chol_solve_blocked", dev, m.data_ptr(), rhs.data_ptr(), l.data_ptr(),
           x.data_ptr(), logdet.data_ptr(), bsz, r)
    chol_solve_blocked.launches += 1
    return l, x, logdet


chol_solve_blocked.launches = 0


def tri_solve_lt_plain(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x with Lᵀx = z per chain, dividing by max(Lⱼⱼ, 1e-30)."""
    guarded = chol.clone()
    diag = guarded.diagonal(dim1=-2, dim2=-1)
    diag.copy_(torch.clamp_min(diag, 1e-30))
    return torch.linalg.solve_triangular(
        guarded.transpose(-1, -2), z[..., None], upper=True)[..., 0]


def tri_solve_lt(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀx = z for lower L [B, r, r] and z [B, r] (float32,
    contiguous) → x [B, r]: the posterior draw α* = α̂ + L⁻ᵀz.  Ranks
    ``uses_blocked`` picks go to K7.

    Kernel K2 (``csrc/chol.cu``) replaces ``_tri_lt_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by the latency of r
    dependent row reads; one warp per chain walks the rows of L with
    coalesced loads and no block barrier."""
    bsz, r, dev = _tri_args(chol, z)
    if dev.type == "cpu":
        return tri_solve_lt_plain(chol, z)
    if uses_blocked(r):
        return tri_solve_lt_blocked(chol, z)
    x = torch.empty_like(z)
    launch("icp_tri_solve_lt", dev, chol.data_ptr(), z.data_ptr(), x.data_ptr(),
           bsz, r)
    tri_solve_lt.launches += 1
    return x


tri_solve_lt.launches = 0


def tri_solve_lt_blocked(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``tri_solve_lt`` through the blocked kernel, same contract; r ≤ 512.

    Kernel K7 (``csrc/chol.cu``) replaces ``_tri_lt_blocked_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by the r dependent
    steps (at 2,048 chains also by the bytes of the lower triangle).  One
    warp per chain in the axpy form: each lane keeps its residual entries
    in registers, the owner of xⱼ divides and one shuffle broadcasts it,
    and the rows of L stream into registers four steps ahead of their use,
    so a step waits on one division, one shuffle and one multiply-subtract.
    No shared memory."""
    bsz, r, dev = _tri_args(chol, z)
    if dev.type == "cpu":
        return tri_solve_lt_plain(chol, z)
    if r > 512:  # 16 residual entries per lane at most
        raise ValueError(f"tri_solve_lt_blocked takes r ≤ 512, got r={r}")
    x = torch.empty_like(z)
    launch("icp_tri_solve_lt_blocked", dev, chol.data_ptr(), z.data_ptr(), x.data_ptr(),
           bsz, r)
    tri_solve_lt_blocked.launches += 1
    return x


tri_solve_lt_blocked.launches = 0
