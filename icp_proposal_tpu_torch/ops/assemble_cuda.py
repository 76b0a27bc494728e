"""The ICP target direction's posterior system, M's lower triangle and its
right-hand side, in one kernel (``target_assembly``), with its plain twin
and the set-up tables it reads.

Per chain, over the m observations i (the candidate mesh's vertex idᵢ
nearest the sampled target point tᵢ, pose-inverted), with the candidate's
unit normal nᵢ at idᵢ, the weight wᵢ (0 on a model-boundary id when the
component is boundary-aware, else 1), a = 1/σₙ² and c = 1/σₜ²:

    M   = I + Σᵢ wᵢ · Qᵢᵀ (c·I + (a−c)·nᵢnᵢᵀ) Qᵢ
    rhs =     Σᵢ wᵢ · Qᵢᵀ (c·I + (a−c)·nᵢnᵢᵀ) ((tᵢ − refᵢ) − μᵢ)

``models.gpmm.posterior_factors_anisotropic`` calls it at every anchor of
the target direction and factors what it returns; the tables are built
once at set-up (``target_tables``, which ``models.gpmm`` exports).
Dispatch: tensors on the CPU take the plain twin, the system's one plain
form; tensors on a CUDA device launch the kernel or raise.
``target_assembly.launches`` counts the kernel's launches (the plain twin
does not count).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from icp_proposal_tpu_torch._build import check_tensor, kernel_device, launch, load_library


class TargetTables(NamedTuple):
    """What the assembly reads of the model, built once at set-up."""

    q: torch.Tensor  # [V, 3, rp] the scaled basis, rows padded with zeros to rp = 4⌈r/4⌉
    vtab: torch.Tensor  # [V, 8] per vertex: ref (3), w, mean displacement (3), 0
    rank: int


def target_tables(gpmm, boundary: Optional[torch.Tensor]) -> TargetTables:
    """The tables of ``gpmm``; ``boundary`` [V] bool flags the vertices whose
    observations get weight 0, None for none."""
    v, _, r = gpmm.sbasis.shape
    rp = -(-r // 4) * 4
    q = gpmm.sbasis.new_zeros((v, 3, rp))
    q[..., :r] = gpmm.sbasis
    ref = gpmm.ref_points
    w = ref.new_ones(v) if boundary is None else (~boundary).to(ref.dtype)
    vtab = torch.cat([ref, w[:, None], gpmm.mean_disp, ref.new_zeros((v, 1))], dim=1)
    return TargetTables(q=q, vtab=vtab, rank=r)


def _check(tables: TargetTables, ids, target_points, normals):
    v, rp = tables.q.shape[0], tables.q.shape[2]
    check_tensor(tables.q, "q", torch.float32, (v, 3, rp))
    if rp != -(-tables.rank // 4) * 4:
        raise ValueError(f"q has {rp} columns a row, rank {tables.rank} needs "
                         f"{-(-tables.rank // 4) * 4}")
    check_tensor(tables.vtab, "vtab", torch.float32, (v, 8))
    check_tensor(ids, "ids", torch.int32, (None, None))
    bsz, m = ids.shape
    check_tensor(target_points, "target_points", torch.float32, (bsz, m, 3))
    check_tensor(normals, "normals", torch.float32, (bsz, v, 3))
    return bsz, m


def target_assembly_plain(tables: TargetTables, ids: torch.Tensor,
                          target_points: torch.Tensor, normals: torch.Tensor,
                          noise_along_normal: float, tangential_noise: float):
    """(M [B, r, r], rhs [B, r]) from the gathered [B, m, 3, r] rows,
    precision-scaled and contracted; M is whole, in the tables' dtype."""
    r = tables.rank
    idx = ids.long()
    q_o = tables.q[:, :, :r][idx]  # [B, m, 3, r]
    vt = tables.vtab[idx]  # [B, m, 8]
    resid = (target_points - vt[..., 0:3]) - vt[..., 4:7]  # [B, m, 3]
    nrm = normals[torch.arange(ids.shape[0], device=ids.device)[:, None], idx]
    a = 1.0 / (noise_along_normal * noise_along_normal)
    c = 1.0 / (tangential_noise * tangential_noise)
    ntq = torch.einsum("bmi,bmir->bmr", nrm, q_o)  # [B, m, r]
    pq = c * q_o + (a - c) * nrm[..., None] * ntq[:, :, None, :]
    pq = pq * vt[..., 3, None, None]
    bsz, m = ids.shape
    eye = torch.eye(r, dtype=q_o.dtype, device=q_o.device)
    m_mat = eye + q_o.reshape(bsz, 3 * m, r).transpose(1, 2) @ pq.reshape(bsz, 3 * m, r)
    rhs = torch.einsum("bmir,bmi->br", pq, resid)
    return m_mat, rhs


def target_assembly(tables: TargetTables, ids: torch.Tensor, target_points: torch.Tensor,
                    normals: torch.Tensor, noise_along_normal: float,
                    tangential_noise: float):
    """M [B, r, r] and rhs [B, r] of the target direction's posterior from
    the tables, the observations' vertex ids [B, m] int32 (each in [0, V)),
    the pose-inverted target points [B, m, 3] and the candidate's vertex
    normals [B, V, 3] (float32, contiguous).  On CUDA only M's lower
    triangle is written (``chol_cuda.chol_solve`` reads nothing else); the
    plain twin returns M whole.

    Kernel ``target_assembly_kernel`` (``csrc/assemble.cu``) replaces no
    Pallas kernel: the JAX package leaves this assembly to XLA
    (``icp_proposal_tpu/models/gpmm.py``, ``posterior_factors_anisotropic``).
    Bound by its FP32 operations, B·3m·r(r+1)/2 multiply-adds (11.9 ms at
    r = 401, m = 802, 2,048 chains).  A block owns a 128 × 128 tile of a
    chain's lower triangle (a diagonal tile with a thin last band's rows),
    a thread an 8 × 8 tile of it in registers over the whole depth, the
    right-hand side as row r; the basis rows at the observations' ids are
    gathered from L2 into a cp.async ring and precision-scaled in shared
    memory, so no [B, m, 3, r] tensor exists."""
    dev = kernel_device(tables.q, tables.vtab, ids, target_points, normals)
    if dev.type == "cpu":
        return target_assembly_plain(tables, ids, target_points, normals,
                                     noise_along_normal, tangential_noise)
    bsz, m = _check(tables, ids, target_points, normals)
    r = tables.rank
    a = 1.0 / (noise_along_normal * noise_along_normal)
    c = 1.0 / (tangential_noise * tangential_noise)
    m_mat = torch.empty((bsz, r, r), dtype=torch.float32, device=dev)
    rhs = torch.empty((bsz, r), dtype=torch.float32, device=dev)
    launch("icp_target_assembly", dev, tables.q.data_ptr(), tables.vtab.data_ptr(),
           ids.data_ptr(), target_points.data_ptr(), normals.data_ptr(), m_mat.data_ptr(),
           rhs.data_ptr(), bsz, m, r, tables.q.shape[2], tables.q.shape[0], c, a - c)
    target_assembly.launches += 1
    return m_mat, rhs


target_assembly.launches = 0


def target_assembly_config(r: int, m: int) -> dict:
    """The kernel's launch on the current card at rank r with m observations:
    bands of 16 micro rows (8 × 8 outputs each), tiles (blocks) a chain,
    threads a block, observations a stage, dynamic shared bytes a block,
    blocks an SM."""
    out = (ctypes.c_int * 6)()
    err = load_library().icp_target_assembly_config(r, m, out)
    if err != 0:
        raise ValueError(f"no target assembly launch at r={r}, m={m}: CUDA error {err} "
                         f"({load_library().icp_error_string(err).decode()})")
    return dict(zip(("bands", "tiles", "threads", "obs", "smem_bytes", "ctas_per_sm"), out))
