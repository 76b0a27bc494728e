"""Low-rank Gaussian-Process Morphable Models, batched over chains.

Counterpart of ``icp_proposal_tpu/models/gpmm.py``; the math is the same:

    instance(α)   x = ref + μ + Q α,   Q = Φ·diag(√λ)
    prior         N(0, I_r)
    posterior     α | y ~ N(α̂, M⁻¹),  M = I + Σᵢ QᵢᵀPᵢQᵢ,  α̂ = M⁻¹ Σᵢ QᵢᵀPᵢỹᵢ

with the anisotropic observation precision P = (1/σ_t²) I + (1/σ_n² − 1/σ_t²) nnᵀ.
Every function takes chains as the leading dimension B.  The r×r factor and
solve go through the K1 kernel (``ops/chol_cuda.chol_solve``), the posterior
draw through K2 (``ops/chol_cuda.tri_solve_lt``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from icp_proposal_tpu_torch.mesh import TriangleMesh
from icp_proposal_tpu_torch.ops.chol_cuda import chol_solve, tri_solve_lt
from icp_proposal_tpu_torch.utils.profiling import span

_LOG_2PI = math.log(2.0 * math.pi)
_PROJECTION_SIGMA2 = 1e-5  # scalismo StatisticalMeshModel.coefficients regularizer


@dataclass(frozen=True)
class Gpmm:
    """A discrete low-rank GPMM as tensors on one device."""

    ref_points: torch.Tensor  # [V, 3]
    cells: torch.Tensor  # [F, 3] int64
    mean_disp: torch.Tensor  # [V, 3]
    basis: torch.Tensor  # [V, 3, r]
    variance: torch.Tensor  # [r]
    noise_variance: torch.Tensor  # []
    sbasis: torch.Tensor  # [V, 3, r]   Q = Φ·diag(√λ)
    coeff_chol: torch.Tensor  # [r, r]  chol(σ²I + QᵀQ), lower

    @property
    def rank(self) -> int:
        return self.basis.shape[-1]

    @property
    def num_points(self) -> int:
        return self.ref_points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ref_points.device

    def reference_mesh(self) -> TriangleMesh:
        return TriangleMesh(points=self.ref_points, cells=self.cells)

    def mean_mesh(self) -> TriangleMesh:
        return TriangleMesh(points=self.ref_points + self.mean_disp, cells=self.cells)


def make_gpmm(ref_points, cells, mean_disp, basis, variance, noise_variance=0.0,
              device=DEFAULT_DEVICE) -> Gpmm:
    """Build a Gpmm from host arrays: faces in Morton order, the scaled basis
    and the projection factor computed in float64 on the host and stored
    float32, exactly as ``icp_proposal_tpu.models.gpmm.make_gpmm`` does; the
    tensors go to ``device`` (the card unless ``device="cpu"``)."""
    with span("setup.model"):
        from icp_proposal_tpu_torch.convert import gpmm_from_arrays
        from icp_proposal_tpu_torch.ops.morton import morton_sort_faces

        device = resolve_device(device)
        cells = np.asarray(cells)[morton_sort_faces(ref_points, cells)]
        basis64 = np.asarray(basis, dtype=np.float64)
        var64 = np.asarray(variance, dtype=np.float64)
        v, _, r = basis64.shape
        q = (basis64 * np.sqrt(var64)[None, None, :]).reshape(3 * v, r)
        gram = q.T @ q + _PROJECTION_SIGMA2 * np.eye(r)
        chol = np.linalg.cholesky(gram)
        return gpmm_from_arrays(
            ref_points=ref_points, cells=cells, mean_disp=mean_disp, basis=basis,
            variance=variance, noise_variance=noise_variance,
            sbasis=q.reshape(v, 3, r), coeff_chol=chol, device=device,
        )


# ---------------------------------------------------------------------------
# decode / prior
# ---------------------------------------------------------------------------

def instance_displacement(gpmm: Gpmm, coeffs: torch.Tensor) -> torch.Tensor:
    """u(α) = μ + Q α: coeffs [..., r] → [..., V, 3], one [3V, r] product."""
    v = gpmm.num_points
    flat = coeffs @ gpmm.sbasis.reshape(3 * v, gpmm.rank).T  # [..., 3V]
    return gpmm.mean_disp + flat.reshape(coeffs.shape[:-1] + (v, 3))


def instance_points(gpmm: Gpmm, coeffs: torch.Tensor) -> torch.Tensor:
    """x(α) = ref + u(α) (reference ``StatisticalMeshModel.instance``)."""
    return gpmm.ref_points + instance_displacement(gpmm, coeffs)


def instance_mesh(gpmm: Gpmm, coeffs: torch.Tensor) -> TriangleMesh:
    """The instance at coeffs [r] as a mesh of tensors on the model's device."""
    return TriangleMesh(points=instance_points(gpmm, coeffs), cells=gpmm.cells)


def coefficients(gpmm: Gpmm, points: torch.Tensor) -> torch.Tensor:
    """Project a shape back to coefficients, points [..., V, 3] → [..., r]:
    α = (σ²I + QᵀQ)⁻¹ Qᵀ(x − ref − μ), σ² = 1e-5 (scalismo
    ``StatisticalMeshModel.coefficients``), through the stored factor."""
    v = gpmm.num_points
    resid = (points - gpmm.ref_points - gpmm.mean_disp).reshape(
        points.shape[:-2] + (3 * v,))
    rhs = resid @ gpmm.sbasis.reshape(3 * v, gpmm.rank)  # Qᵀ resid
    return torch.cholesky_solve(rhs[..., None], gpmm.coeff_chol)[..., 0]


def prior_logpdf(coeffs: torch.Tensor) -> torch.Tensor:
    """N(0, I_r) over shape coefficients: [..., r] → [...]."""
    r = coeffs.shape[-1]
    return -0.5 * torch.sum(coeffs * coeffs, dim=-1) - 0.5 * r * _LOG_2PI


# ---------------------------------------------------------------------------
# analytic GP posterior in coefficient space
# ---------------------------------------------------------------------------

class PosteriorFactors(NamedTuple):
    """Factors of the coefficient-space GP posterior N(α̂, M⁻¹), per chain."""

    alpha_hat: torch.Tensor  # [B, r]
    chol_m: torch.Tensor  # [B, r, r] lower, M = L Lᵀ
    logdet_m: torch.Tensor  # [B]


def _factor(m_mat: torch.Tensor, rhs: torch.Tensor) -> PosteriorFactors:
    """Symmetrize M against round-off, then factor and solve (K1)."""
    with span("chol.factor"):
        m_mat = 0.5 * (m_mat + m_mat.transpose(-1, -2))
        chol, alpha_hat, logdet = chol_solve(m_mat.contiguous(), rhs.contiguous())
    return PosteriorFactors(alpha_hat=alpha_hat, chol_m=chol, logdet_m=logdet)


def posterior_factors_anisotropic(
    gpmm: Gpmm,
    ids: torch.Tensor,  # [B, m] vertex ids of the observations
    obs_disp: torch.Tensor,  # [B, m, 3] observed displacement from ref points
    normals: torch.Tensor,  # [B, m, 3] unit normals defining the noise frame
    noise_along_normal: float,
    tangential_noise: float,
    mask: torch.Tensor,  # [B, m] float; 0 ⇒ observation excluded
) -> PosteriorFactors:
    """Posterior factors for per-chain observation ids (the ICP target
    direction): gather Qᵢ, precision-scale, contract to M = I + QᵀPQ."""
    with span("gpmm.assemble"):
        ids = ids.long()
        q_o = gpmm.sbasis[ids]  # [B, m, 3, r]
        resid = obs_disp - gpmm.mean_disp[ids]  # [B, m, 3]
        a = 1.0 / (noise_along_normal * noise_along_normal)
        b = 1.0 / (tangential_noise * tangential_noise)
        ntq = torch.einsum("bmi,bmir->bmr", normals, q_o)  # [B, m, r]
        pq = b * q_o + (a - b) * normals[..., None] * ntq[:, :, None, :]
        pq = pq * mask[..., None, None]
        bsz, m, _, r = q_o.shape
        qf = q_o.reshape(bsz, 3 * m, r)
        pqf = pq.reshape(bsz, 3 * m, r)
        eye = torch.eye(r, dtype=q_o.dtype, device=q_o.device)
        m_mat = eye + qf.transpose(1, 2) @ pqf
        rhs = torch.einsum("bmir,bmi->br", pq, resid)
    return _factor(m_mat, rhs)


def posterior_factors_anisotropic_static(
    gpmm: Gpmm,
    q_static: torch.Tensor,  # [m, 3, r] sbasis rows at the static ids
    gram_static: torch.Tensor,  # [m, r, r] per-observation Gram QᵢᵀQᵢ
    mean_static: torch.Tensor,  # [m, 3] mean_disp at the static ids
    obs_disp: torch.Tensor,  # [B, m, 3]
    normals: torch.Tensor,  # [B, m, 3]
    noise_along_normal: float,
    tangential_noise: float,
    mask: torch.Tensor,  # [B, m]
) -> PosteriorFactors:
    """The same posterior for STATIC observation ids (the ICP model
    direction), assembled against precomputed per-id tables:

        M = I + b·Σᵢ wᵢ QᵢᵀQᵢ + (a−b)·Σᵢ wᵢ gᵢgᵢᵀ,   gᵢ = Qᵢᵀnᵢ

    so no [B, m, 3, r] tensor is ever built."""
    with span("gpmm.assemble"):
        a = 1.0 / (noise_along_normal * noise_along_normal)
        b = 1.0 / (tangential_noise * tangential_noise)
        w = mask.to(torch.float32)  # [B, m]
        resid = obs_disp - mean_static  # [B, m, 3]
        ntq = torch.einsum("bmi,mir->bmr", normals, q_static)  # [B, m, r]
        bsz, m, r = ntq.shape
        eye = torch.eye(r, dtype=torch.float32, device=ntq.device)
        gram_sum = (w @ gram_static.reshape(m, r * r)).reshape(bsz, r, r)
        outer = (ntq * w[..., None]).transpose(1, 2) @ ntq  # Σᵢ wᵢ gᵢgᵢᵀ
        m_mat = eye + b * gram_sum + (a - b) * outer
        n_dot_y = torch.sum(normals * resid, dim=-1)  # [B, m]
        rhs = b * ((w[..., None] * resid).reshape(bsz, 3 * m)
                   @ q_static.reshape(3 * m, r)) + (a - b) * torch.einsum(
            "bmr,bm->br", ntq, w * n_dot_y)
    return _factor(m_mat, rhs)


def isotropic_system(gpmm: Gpmm, ids: torch.Tensor, obs_disp: torch.Tensor,
                     weight: Optional[torch.Tensor] = None):
    """Σᵢ wᵢQᵢᵀQᵢ [B, r, r] and Σᵢ wᵢQᵢᵀỹᵢ [B, r] over the observations
    ids [B, m] with displacements obs_disp [B, m, 3] from the reference
    points; ``weight`` [B, m] is wᵢ, None for all ones (then no weighted
    copy of the gathered Q [B, m, 3, r] is made)."""
    ids = ids.long()
    q_o = gpmm.sbasis[ids]  # [B, m, 3, r]
    resid = obs_disp - gpmm.mean_disp[ids]  # [B, m, 3]
    bsz, m, _, r = q_o.shape
    qf = q_o.reshape(bsz, 3 * m, r)
    pqf = qf if weight is None else (q_o * weight[..., None, None]).reshape(bsz, 3 * m, r)
    return qf.transpose(1, 2) @ pqf, (resid.reshape(bsz, 1, 3 * m) @ pqf)[:, 0]


def posterior_factors_isotropic(
    gpmm: Gpmm,
    ids: torch.Tensor,  # [B, m] vertex ids of the observations
    obs_disp: torch.Tensor,  # [B, m, 3] observed displacement from ref points
    sigma2,  # isotropic noise variance σ² (a float, or [B] per chain)
    mask: torch.Tensor,  # [B, m] float; 0 ⇒ observation excluded
) -> PosteriorFactors:
    """Posterior factors for isotropic observation noise σ²I, the
    deterministic ICP's regression (reference
    ``IcpBasedSurfaceFitting.scala:81``): M = I + QᵀQ/σ² over the masked
    rows, rhs = (Q/σ²)ᵀỹ, factored and solved by K1 (r ≤ 104) or K6.  The
    deterministic ICP solves the same system scaled by σ²
    (``registration.icp_fitting._regression_mean``)."""
    with span("gpmm.assemble"):
        sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=mask.device)
        if sigma2.dim() == 1:
            sigma2 = sigma2[:, None]
        gram, rhs = isotropic_system(gpmm, ids, obs_disp, mask / sigma2)
        gram.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return _factor(gram, rhs)


def sample_posterior_coeffs(factors: PosteriorFactors,
                            z: torch.Tensor) -> torch.Tensor:
    """α* = α̂ + L⁻ᵀ z for standard normals z [B, r] (K2)."""
    return factors.alpha_hat + tri_solve_lt(factors.chol_m, z.contiguous())


def transition_logpdf(factors: PosteriorFactors, alpha_star: torch.Tensor,
                      include_logdet: bool = True) -> torch.Tensor:
    """log N(α*; α̂, M⁻¹) per chain.  include_logdet=True adds the
    ½·log det M normalizer (the exact density); False drops it, as the
    reference's own density does (parity mode)."""
    delta = alpha_star - factors.alpha_hat  # [B, r]
    lt_delta = torch.einsum("bji,bj->bi", factors.chol_m, delta)  # Lᵀδ
    quad = torch.sum(lt_delta * lt_delta, dim=-1)
    r = alpha_star.shape[-1]
    logp = -0.5 * quad - 0.5 * r * _LOG_2PI
    return logp + 0.5 * factors.logdet_m if include_logdet else logp
