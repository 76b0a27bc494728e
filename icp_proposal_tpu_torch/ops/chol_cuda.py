"""K1 ``chol_solve``, K2 ``tri_solve_lt`` and their blocked forms K6
``chol_solve_blocked`` and K7 ``tri_solve_lt_blocked``: wrappers and plain
twins.

Counterpart of ``icp_proposal_tpu/ops/chol_pallas.py``.  The kernels are in
``csrc/chol.cu``, whose header says what bounds each on the H100 and how its
layout answers that.  Chains are the leading dimension of every argument.

Dispatch: a tensor on the CPU takes the plain PyTorch twin; a tensor on a
CUDA device launches a kernel or raises.  On the card ``chol_solve`` and
``tri_solve_lt`` route by the reference's own rule (``uses_blocked``): the
monolithic K1/K2 up to rank 104, the blocked K6/K7 from rank 105 on.  K1
and K6 launch one tiled kernel, K2 and K7 one row-streaming kernel; the
routing keeps each entry point's launch count.  Past what those hold, K6
goes to the streamed factor (``chol_solve_streamed``, r > 320) and K7 to
the streamed solve (``tri_solve_lt_streamed``, r > 512), each with its own
launch count, up to ``STREAM_MAX_RANK``; the reference serves those ranks
with its blocked kernels up to 1,224 and with XLA above.
``<wrapper>.launches`` counts that wrapper's kernel launches (the plain
twin does not count).
"""
from __future__ import annotations

import torch

from icp_proposal_tpu_torch._build import check_tensor, kernel_device, launch, load_library

MAX_SMEM_BYTES = 227 * 1024  # a block's shared-memory ceiling on sm_90
TILE = 16  # K1/K6 tile edge (kTile in csrc/chol.cu)
MAX_RANK = 320  # K1/K6: the largest r whose packed lower tiles fit a block (kMaxRank)
K1_WARPS, K6_WARPS = 4, 8  # warps per chain of K1 and K6 (kK1Warps, kK6Warps)
ROWS_MAX_RANK = 512  # K2/K7 row kernel: 16 residual entries a lane (kRowsMaxRank)
# K6/K7 streamed: the vector of r floats they keep in shared memory (kStreamMaxRank)
STREAM_MAX_RANK = 16384
PANEL = 64  # K6 streamed: columns a panel (kPanel)
STREAM_SLICE = 16  # K6 streamed: finished columns a stage of the update (kSlice)
STREAM_TILE_ROWS = 64  # K6 streamed: rows of the largest row tile (kTileRows)


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


def tiled_smem_bytes(r: int, warps: int) -> int:
    """Shared memory a chain of K1/K6 takes at rank r, as the kernel's launch
    sizes it: the packed lower 16×16 tiles of M padded to 16⌈r/16⌉, one
    scratch tile per warp, and 1/√dⱼ and log dⱼ per pivot."""
    n = load_library().icp_chol_tiled_smem_bytes(r, warps)
    if n < 0:
        raise ValueError(f"r={r} is over the limit r ≤ {MAX_RANK}")
    return n


def tiled_ctas_per_sm(r: int, warps: int) -> int:
    """Blocks (chains) of the K1/K6 kernel with ``warps`` warps that one SM
    of the current card holds at rank r, from CUDA's occupancy calculator."""
    n = load_library().icp_chol_tiled_ctas_per_sm(r, warps)
    if n < 0:
        raise RuntimeError(f"no occupancy for r={r}, warps={warps}")
    return n


def streamed_row_tiles(n: int) -> list[tuple[int, int]]:
    """The streamed K6's row tiles of a panel of n rows (the right-hand
    side's included), as the kernel's ``tile_rows`` cuts them: (first row
    in the panel, rows) — 64 while more than 48 remain, then 32 while more
    than 16 remain, then 16; the first tile takes 64 from 33 rows on, so
    that it holds all of the diagonal block's rows."""
    t = STREAM_TILE_ROWS
    tiles, p0 = [], 0
    while p0 < n:
        rem = n - p0
        h = t if rem > (t // 2 if p0 == 0 else 3 * t // 4) else t // 2 if rem > t // 4 else t // 4
        tiles.append((p0, h))
        p0 += h
    return tiles


def streamed_smem_bytes(r: int) -> int:
    """Shared memory a chain of the streamed K6 takes at rank r, as its
    launch sizes it: the cp.async ring, the 64×64 diagonal block and its
    scratch, or the vector of the back substitution, whichever is larger."""
    n = load_library().icp_chol_streamed_smem_bytes(r)
    if n < 0:
        raise ValueError(f"r={r} is over the limit r ≤ {STREAM_MAX_RANK}")
    return n


def streamed_ctas_per_sm(r: int) -> int:
    """Blocks (chains) of the streamed K6 that one SM of the current card
    holds at rank r, from CUDA's occupancy calculator."""
    n = load_library().icp_chol_streamed_ctas_per_sm(r)
    if n < 0:
        raise RuntimeError(f"no occupancy for the streamed K6 at r={r}")
    return n


def _check_rank(name: str, r: int, limit: int, why: str) -> None:
    if r > limit:
        raise ValueError(f"{name} takes r ≤ {limit} ({why}), got r={r}")


def _launch_factor(name: str, m: torch.Tensor, rhs: torch.Tensor, bsz: int, r: int, dev,
                   *scratch: torch.Tensor):
    l = torch.empty_like(m)
    x = torch.empty_like(rhs)
    logdet = torch.empty(bsz, dtype=torch.float32, device=dev)
    launch(f"icp_{name}", dev, m.data_ptr(), rhs.data_ptr(), l.data_ptr(), x.data_ptr(),
           logdet.data_ptr(), *(t.data_ptr() for t in scratch), bsz, r)
    return l, x, logdet


_STREAM_LIMIT = "the vector of r floats the kernel keeps in shared memory"


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
    log det M [B]).  Only M's lower triangle is read.  On CUDA a pivot ≤ 0
    makes that chain's factor NaN from the pivot's column on (and x, log det
    NaN).  ``blocked`` None routes by ``uses_blocked(r)``; True or False
    forces K6 or K1.  On CUDA K1 takes r ≤ ``MAX_RANK``, K6
    r ≤ ``STREAM_MAX_RANK``.

    Kernel K1 (``csrc/chol.cu``) replaces ``_chol_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by latency (r dependent
    pivot steps), not bytes.  One block of 4 warps per chain runs the tiled
    right-looking factor that K6 runs with 8: the lower triangle as packed
    16×16 tiles in shared memory, two block barriers per 16 pivots, then
    both substitutions from shared memory in one warp."""
    bsz, r, dev = _chol_args(m, rhs)
    if dev.type == "cpu":
        return chol_solve_plain(m, rhs)
    if uses_blocked(r) if blocked is None else blocked:
        return chol_solve_blocked(m, rhs)
    _check_rank("chol_solve", r, MAX_RANK, f"the packed lower tiles of a larger M overflow "
                f"the {MAX_SMEM_BYTES} B of shared memory a block holds")
    out = _launch_factor("chol_solve", m, rhs, bsz, r, dev)
    chol_solve.launches += 1
    return out


chol_solve.launches = 0


def chol_solve_blocked(m: torch.Tensor, rhs: torch.Tensor):
    """``chol_solve`` through the blocked kernel, same contract.

    Kernel K6 (``csrc/chol.cu``) replaces ``_chol_blocked_kernel`` in
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by the r dependent pivot
    steps, as K1, whose tiled kernel it launches with 8 warps per chain (93 KB
    of tiles at r = 200: two chains per SM), up to r = ``MAX_RANK``; larger
    r goes to ``chol_solve_streamed``, which counts its own launches."""
    bsz, r, dev = _chol_args(m, rhs)
    if dev.type == "cpu":
        return chol_solve_plain(m, rhs)
    if r > MAX_RANK:
        return chol_solve_streamed(m, rhs)
    out = _launch_factor("chol_solve_blocked", m, rhs, bsz, r, dev)
    chol_solve_blocked.launches += 1
    return out


chol_solve_blocked.launches = 0


def chol_solve_streamed(m: torch.Tensor, rhs: torch.Tensor):
    """``chol_solve`` with M and L in device memory, same contract; K6 for
    r > ``MAX_RANK``.  On CUDA r ≤ ``STREAM_MAX_RANK``.

    Kernel K6 streamed (``csrc/chol.cu``) replaces ``_chol_blocked_kernel``
    in ``icp_proposal_tpu/ops/chol_pallas.py`` where the tiled kernel's
    packed M no longer fits a block (and, past 1,224, XLA's cholesky and
    cho_solve, which the reference takes there).  Bound by its r³/3 FP32
    flops, held back by its phases' latency.  One block of 4 warps per chain,
    four chains an SM, left-looking by panels of 64 columns: row tiles of
    64 (the tail 32, 16) rows, each thread 8×4 outputs updated from a
    three-stage cp.async ring of 16 finished columns read from a workspace
    of the finished panels' rows (16-byte aligned whatever r is); the 64×64
    diagonal block factored by every warp in 16×16 tiles, the rows below
    solved against it by shuffles; the right-hand side rides along as the
    matrix's row r, then Lᵀx = y from device memory in the blocked dot
    form."""
    bsz, r, dev = _chol_args(m, rhs)
    if dev.type == "cpu":
        return chol_solve_plain(m, rhs)
    _check_rank("chol_solve_streamed", r, STREAM_MAX_RANK, _STREAM_LIMIT)
    # the finished panels' rows, 16-byte aligned, which the update reads again
    ws = torch.empty(bsz * load_library().icp_chol_streamed_ws_floats(r), device=dev)
    out = _launch_factor("chol_solve_streamed", m, rhs, bsz, r, dev, ws)
    chol_solve_streamed.launches += 1
    return out


chol_solve_streamed.launches = 0


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
    ``icp_proposal_tpu/ops/chol_pallas.py``.  Bound by the r dependent
    steps (at 2,048 chains also by the bytes of L's lower triangle).  It
    launches K7's row-streaming kernel (see ``tri_solve_lt_blocked``) with
    4 residual entries a lane, so a step waits on one division, one shuffle
    and one multiply-subtract, never on a row of L; the entry point and its
    launch count stay K2's."""
    bsz, r, dev = _tri_args(chol, z)
    if dev.type == "cpu":
        return tri_solve_lt_plain(chol, z)
    if uses_blocked(r):
        return tri_solve_lt_blocked(chol, z)
    x = torch.empty_like(z)
    launch("icp_tri_solve_lt_rows", dev, chol.data_ptr(), z.data_ptr(), x.data_ptr(),
           bsz, r)
    tri_solve_lt.launches += 1
    return x


tri_solve_lt.launches = 0


def tri_solve_lt_blocked(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``tri_solve_lt`` through the blocked kernel, same contract; r > 512
    goes to ``tri_solve_lt_streamed``, which counts its own launches.

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
    if r > ROWS_MAX_RANK:
        return tri_solve_lt_streamed(chol, z)
    x = torch.empty_like(z)
    launch("icp_tri_solve_lt_rows", dev, chol.data_ptr(), z.data_ptr(), x.data_ptr(),
           bsz, r)
    tri_solve_lt_blocked.launches += 1
    return x


tri_solve_lt_blocked.launches = 0


def tri_solve_lt_streamed(chol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``tri_solve_lt`` with the vector in shared memory, same contract; K7
    for r > ``ROWS_MAX_RANK``.  On CUDA r ≤ ``STREAM_MAX_RANK``.

    Kernel K7 streamed (``csrc/chol.cu``) replaces ``_tri_lt_blocked_kernel``
    in ``icp_proposal_tpu/ops/chol_pallas.py`` past the row kernel's 16
    residual entries a lane (and, past 1,224, XLA's solve_triangular).
    Bound by the bytes of L's lower triangle at the main paths' chains.  One
    block of 4 warps per chain in the blocked dot form: for each 32 columns,
    from the last up, every lane sums L[j, c]·xⱼ over its warp's rows below
    (coalesced rows, no step waiting on another), then warp 0 solves the
    32×32 triangle by shuffles."""
    bsz, r, dev = _tri_args(chol, z)
    if dev.type == "cpu":
        return tri_solve_lt_plain(chol, z)
    _check_rank("tri_solve_lt_streamed", r, STREAM_MAX_RANK, _STREAM_LIMIT)
    x = torch.empty_like(z)
    launch("icp_tri_solve_lt_streamed", dev, chol.data_ptr(), z.data_ptr(), x.data_ptr(),
           bsz, r)
    tri_solve_lt_streamed.launches += 1
    return x


tri_solve_lt_streamed.launches = 0
