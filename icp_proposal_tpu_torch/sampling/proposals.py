"""Proposal generators and their mixture, batched over chains.

Counterpart of ``icp_proposal_tpu/sampling/proposals.py`` for the ported
mixtures: the informed ICP proposal in both directions, the random-shape
walk and the single-axis random pose walks.  As in the reference, the mixture is evaluated densely: every
component proposes for every chain, one is selected per chain, and the
transition density is the logsumexp over components of log w_c + log q_c,
with −∞ where a component cannot reach the state (pose or scale changed).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np
import torch

from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.ops.closest_point import nearest_vertex_of_faces
from icp_proposal_tpu_torch.ops.closest_point_cuda import nearest_vertices
from icp_proposal_tpu_torch.ops.morton import morton_sort_ids
from icp_proposal_tpu_torch.ops.surface_index import closest_auto
from icp_proposal_tpu_torch.ops.surface_sampling import seeded_vertex_subset
from icp_proposal_tpu_torch.sampling.context import TargetContext
from icp_proposal_tpu_torch.sampling.state import FitState, pose_inverse_apply

_LOG_2PI = math.log(2.0 * math.pi)
_MODEL_SEED = 1024  # the reference's ICP model subset seed (targets: seed + 1)


@dataclass(frozen=True)
class RandomShapeSpec:
    """α' = α + ε, ε ~ N(0, σ²I) (reference ``RandomShapeUpdateProposal``)."""

    sigma: float = 0.1

    @property
    def name(self):
        return f"RandomShape-{self.sigma}"


@dataclass(frozen=True)
class RotationSpec:
    """Single-axis Euler-angle random walk (reference
    ``GaussianAxisRotationProposal``). axis: 0=Roll(φ), 1=Pitch(θ), 2=Yaw(ψ)."""

    axis: int
    sigma: float = 0.01

    @property
    def name(self):
        label = ("RotationRoll", "RotationPitch", "RotationYaw")[self.axis]
        return f"{label}-{self.sigma}"


@dataclass(frozen=True)
class TranslationSpec:
    """Single-axis translation random walk (reference
    ``GaussianAxisTranslationProposal``). axis: 0=X, 1=Y, 2=Z."""

    axis: int
    sigma: float = 0.1

    @property
    def name(self):
        return f"Translation{'XYZ'[self.axis]}-{self.sigma}"


@dataclass(frozen=True)
class IcpSpec:
    """The informed closest-point proposal (reference
    ``NonRigidIcpProposal.scala:30-154``).  direction: "model" (sample model
    vertices, project onto the target surface) or "target" (sample target
    vertices, find the nearest model vertex)."""

    direction: str = "model"
    step_length: float = 0.1
    noise_along_normal: float = 5.0
    tangential_noise: float = 10.0
    n_points: int = 100
    boundary_aware: bool = True

    @property
    def name(self):
        label = "ModelSampling" if self.direction == "model" else "TargetSampling"
        return f"IcpProposal-{label}-{self.step_length}Step"


ProposalSpec = Union[RandomShapeSpec, RotationSpec, TranslationSpec, IcpSpec]
_POSE_SPECS = (RotationSpec, TranslationSpec)


def mixed_proposal_icp(n_points: int, projection_direction: str = "model_and_target",
                       tangential_noise: float = 10.0, noise_along_normal: float = 5.0,
                       step_length: float = 0.1, boundary_aware: bool = True,
                       ) -> List[Tuple[float, ProposalSpec]]:
    """Reference ``MixedProposalDistributions.mixedProposalICP`` (:48-68)."""
    def icp(direction):
        return IcpSpec(direction=direction, step_length=step_length,
                       noise_along_normal=noise_along_normal,
                       tangential_noise=tangential_noise, n_points=n_points,
                       boundary_aware=boundary_aware)

    if projection_direction == "target":
        return [(1.0, icp("target"))]
    if projection_direction == "model":
        return [(1.0, icp("model"))]
    return [(0.5, icp("target")), (0.5, icp("model"))]


def mixed_random_pose_proposal(rot_yaw=0.01, rot_pitch=0.01, rot_roll=0.01,
                               trans_x=0.1, trans_y=0.1, trans_z=0.1,
                               ) -> List[Tuple[float, ProposalSpec]]:
    """Reference ``mixedRandomPoseProposal`` (:29-39): equal-weight 6-way."""
    w = 1.0 / 6.0
    return [
        (w, RotationSpec(axis=2, sigma=rot_yaw)),
        (w, RotationSpec(axis=1, sigma=rot_pitch)),
        (w, RotationSpec(axis=0, sigma=rot_roll)),
        (w, TranslationSpec(axis=0, sigma=trans_x)),
        (w, TranslationSpec(axis=1, sigma=trans_y)),
        (w, TranslationSpec(axis=2, sigma=trans_z)),
    ]


def mixed_random_shape_proposal(steps=(0.1,)) -> List[Tuple[float, ProposalSpec]]:
    """Reference ``mixedRandomShapeProposal`` (:41-46)."""
    w = 1.0 / len(steps)
    return [(w, RandomShapeSpec(sigma=s)) for s in steps]


def nest(*weighted_groups) -> List[Tuple[float, ProposalSpec]]:
    """Combine weighted sub-mixtures into one flat normalized mixture."""
    flat: List[Tuple[float, ProposalSpec]] = []
    total = sum(w for w, _ in weighted_groups)
    for w, group in weighted_groups:
        gtotal = sum(gw for gw, _ in group)
        for gw, spec in group:
            flat.append((w / total * gw / gtotal, spec))
    return flat


def _pose_scale_equal(a: FitState, b: FitState) -> torch.Tensor:
    """[B] bool: scale and pose agree exactly."""
    return ((a.scale == b.scale)
            & torch.all(a.rot == b.rot, dim=-1)
            & torch.all(a.trans == b.trans, dim=-1)
            & torch.all(a.center == b.center, dim=-1))


def _all_but_axis_equal(a: FitState, b: FitState, field: str, axis: int):
    """[B] bool: everything but component ``axis`` of ``field`` ("rot" or
    "trans") agrees exactly (the reference's cross-block −∞ check,
    ``_all_but_rot_axis_equal`` and ``_all_but_trans_axis_equal``)."""
    keep = torch.arange(3, device=a.rot.device) != axis
    same = {name: torch.all(getattr(a, name) == getattr(b, name), dim=-1)
            for name in ("rot", "trans", "center", "coeffs")}
    same[field] = torch.all((getattr(a, field) == getattr(b, field)) | ~keep, dim=-1)
    return (a.scale == b.scale) & same["rot"] & same["trans"] & same["center"] \
        & same["coeffs"]


def _guard(cond, logp):
    return torch.where(cond, logp, -math.inf)


def _take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [B, V, ...] rows at per-chain ids [B, m] → [B, m, ...]."""
    ids = ids.long()
    return x[torch.arange(x.shape[0], device=x.device)[:, None], ids]


class IcpComponent:
    """Concrete ICP proposal: spec + precomputed sample ids; ``factors``
    computes the coefficient-space GP-posterior factors anchored at a state
    (the reference's ``icpPosterior`` in closed form)."""

    def __init__(self, spec: IcpSpec, gpmm, ctx: TargetContext, model_boundary,
                 model_ids, target_ids):
        dev = gpmm.device
        self.spec = spec
        self.gpmm = gpmm
        self.ctx = ctx
        self.model_ids = np.asarray(model_ids)  # [m] sampled model vertex ids
        self.target_ids = np.asarray(target_ids)  # [m] sampled target vertex ids
        self._model_ids_t = torch.as_tensor(self.model_ids, dtype=torch.int64,
                                            device=dev)
        self._model_boundary = torch.as_tensor(np.asarray(model_boundary, bool),
                                               device=dev)
        self._target_points = ctx.points[
            torch.as_tensor(self.target_ids, dtype=torch.int64, device=dev)]
        if spec.direction == "model":
            # static tables for the analytic assembly (the model direction
            # observes a FIXED vertex subset), Gram matrices in float64
            q = gpmm.sbasis.cpu().numpy()[self.model_ids]  # [m, 3, r]
            q64 = q.astype(np.float64)
            self._q_static = torch.as_tensor(q, device=dev)
            self._gram_static = torch.as_tensor(
                np.einsum("mir,mis->mrs", q64, q64).astype(np.float32), device=dev)
            self._mean_static = gpmm.mean_disp[self._model_ids_t]
            self._ref_static = gpmm.ref_points[self._model_ids_t]

    def _mask(self, on_boundary: torch.Tensor) -> torch.Tensor:
        """Observation weights: boundary correspondences drop out."""
        if self.spec.boundary_aware:
            return (~on_boundary).to(torch.float32)
        return torch.ones(on_boundary.shape, device=on_boundary.device)

    def factors(self, state: FitState, cur_points, cur_normals,
                shared_cp_fidx=None) -> gp.PosteriorFactors:
        """Factors anchored at ``state``; ``shared_cp_fidx`` = (cp, fidx) for
        ``model_ids`` from a fused query pass (``mh._fusion_plan``)."""
        spec = self.spec
        if spec.direction == "model":
            # closest target-surface point per sampled model vertex; boundary
            # check on the nearest target vertex (reference :94-109)
            if shared_cp_fidx is not None:
                cp, fidx = shared_cp_fidx
            else:
                q = cur_points[:, self._model_ids_t]
                cp, _, fidx = closest_auto(q, self.ctx.points, self.ctx.cells,
                                           self.ctx.index)
            near = nearest_vertex_of_faces(self.ctx.cells, fidx, cp, self.ctx.points)
            obs_disp = pose_inverse_apply(state, cp) - self._ref_static
            return gp.posterior_factors_anisotropic_static(
                self.gpmm, self._q_static, self._gram_static, self._mean_static,
                obs_disp, cur_normals[:, self._model_ids_t],
                spec.noise_along_normal, spec.tangential_noise,
                self._mask(self.ctx.boundary[near]),
            )
        # target→model: nearest candidate-mesh vertex per sampled target
        # point (K3, one vertex set per chain); boundary check on the model
        bsz = cur_points.shape[0]
        tq = self._target_points.expand(bsz, -1, -1).contiguous()
        ids = nearest_vertices(tq, cur_points.contiguous())  # [B, m]
        obs_disp = pose_inverse_apply(state, tq) - self.gpmm.ref_points[ids.long()]
        return gp.posterior_factors_anisotropic(
            self.gpmm, ids, obs_disp, _take_rows(cur_normals, ids),
            spec.noise_along_normal, spec.tangential_noise,
            self._mask(self._model_boundary[ids.long()]),
        )

    def propose(self, state: FitState, factors: gp.PosteriorFactors,
                z: torch.Tensor) -> FitState:
        """α' = α + (α* − α)·stepLength, α* = α̂ + L⁻ᵀz (reference :53-68)."""
        alpha_star = gp.sample_posterior_coeffs(factors, z)
        new_coeffs = state.coeffs + (alpha_star - state.coeffs) * self.spec.step_length
        return state._replace(coeffs=new_coeffs)

    def log_q(self, from_state: FitState, to_state: FitState,
              factors_from: gp.PosteriorFactors, parity: bool = False):
        """q(to|from): undo the relaxation and evaluate the posterior
        coefficient density.  Exact mode (parity=False) adds the two terms
        the reference omits: ½·log det M and the −r·log(stepLength) Jacobian
        of the relaxation."""
        compensated = from_state.coeffs + (
            to_state.coeffs - from_state.coeffs) / self.spec.step_length
        logp = gp.transition_logpdf(factors_from, compensated, include_logdet=not parity)
        if not parity:
            r = from_state.coeffs.shape[-1]
            logp = logp - r * math.log(self.spec.step_length)
        return _guard(_pose_scale_equal(from_state, to_state), logp)


class MixtureProgram:
    """A flattened, normalized proposal mixture over FitState.

    ``parity=True`` evaluates the ICP components with the reference's own
    transition density (no ½·log det M, no relaxation Jacobian); False is
    the exact MH correction.  ``icp_model_ids``: the model vertices every
    ICP component observes (the flagship setup passes a subset of the
    evaluator's, so one closest-point pass serves both); None takes the
    reference's seeded, Morton-ordered subset (``seed``).  Target vertices
    are the seeded subset of ``seed + 1``."""

    def __init__(self, weighted_specs, gpmm, ctx: TargetContext, model_boundary,
                 parity: bool = False, seed: int = _MODEL_SEED, adapt=None,
                 icp_model_ids=None):
        if adapt is not None:
            raise NotImplementedError(
                "scale adaptation is not ported yet (ROADMAP queue 1, slice 7)")
        for _, s in weighted_specs:
            if not isinstance(s, (IcpSpec, RandomShapeSpec) + _POSE_SPECS):
                raise NotImplementedError(
                    f"{type(s).__name__} is not ported yet (ROADMAP queue 1: "
                    f"MALA is slice 7)")
        total = sum(w for w, _ in weighted_specs)
        self.weights = [w / total for w, _ in weighted_specs]
        self.specs = [s for _, s in weighted_specs]
        self.names = [s.name for s in self.specs]
        self.parity = parity
        self.gpmm = gpmm
        self.ctx = ctx
        self._log_weights = torch.log(torch.tensor(self.weights, dtype=torch.float32,
                                                   device=gpmm.device))
        self.icp_components = {}
        tpts = ctx.points.cpu().numpy()
        ref = gpmm.ref_points.cpu().numpy()
        for i, s in enumerate(self.specs):
            if not isinstance(s, IcpSpec):
                continue
            model_ids = (morton_sort_ids(ref, seeded_vertex_subset(
                gpmm.num_points, s.n_points, seed))
                if icp_model_ids is None else icp_model_ids)
            if len(model_ids) < s.n_points:
                raise ValueError(
                    f"icp_model_ids has {len(model_ids)} ids but {s.name} "
                    f"declares n_points={s.n_points}")
            target_ids = morton_sort_ids(
                tpts, seeded_vertex_subset(len(tpts), s.n_points, seed + 1))
            self.icp_components[i] = IcpComponent(
                s, gpmm, ctx, model_boundary, np.asarray(model_ids[: s.n_points]),
                target_ids)

    @property
    def num_components(self):
        return len(self.specs)

    def anchor_factors(self, state, cur_points, cur_normals, shared=None):
        """ICP posterior factors anchored at ``state`` → dict idx → factors;
        ``shared``: optional dict idx → (cp, fidx) from a fused query pass."""
        shared = shared or {}
        return {i: comp.factors(state, cur_points, cur_normals, shared.get(i))
                for i, comp in self.icp_components.items()}

    def propose_all(self, state: FitState, factors_cur,
                    z: torch.Tensor) -> List[FitState]:
        """One candidate per component from standard normals z [B, C, r]; a
        pose component reads its scalar draw at z[:, c, 0]."""
        candidates = []
        for i, spec in enumerate(self.specs):
            if isinstance(spec, IcpSpec):
                cand = self.icp_components[i].propose(state, factors_cur[i], z[:, i])
            elif isinstance(spec, RandomShapeSpec):
                cand = state._replace(coeffs=state.coeffs + spec.sigma * z[:, i])
            else:
                field = "rot" if isinstance(spec, RotationSpec) else "trans"
                moved = getattr(state, field).clone()
                moved[:, spec.axis] += spec.sigma * z[:, i, 0]
                cand = state._replace(**{field: moved})
            candidates.append(cand)
        return candidates

    def log_q_mixture(self, from_state: FitState, to_state: FitState,
                      factors_from) -> torch.Tensor:
        """log q_mix(to|from) = logsumexp_c [log w_c + log q_c(to|from)] → [B]."""
        comps = []
        for i, spec in enumerate(self.specs):
            if isinstance(spec, IcpSpec):
                lq = self.icp_components[i].log_q(from_state, to_state,
                                                  factors_from[i], self.parity)
            elif isinstance(spec, RandomShapeSpec):
                delta = to_state.coeffs - from_state.coeffs
                r = delta.shape[-1]
                logp = (-0.5 * torch.sum((delta / spec.sigma) ** 2, dim=-1)
                        - r * math.log(spec.sigma) - 0.5 * r * _LOG_2PI)
                lq = _guard(_pose_scale_equal(from_state, to_state), logp)
            else:
                field = "rot" if isinstance(spec, RotationSpec) else "trans"
                delta = (getattr(to_state, field)[:, spec.axis]
                         - getattr(from_state, field)[:, spec.axis])
                logp = (-0.5 * (delta / spec.sigma) ** 2 - math.log(spec.sigma)
                        - 0.5 * _LOG_2PI)
                lq = _guard(_all_but_axis_equal(from_state, to_state, field,
                                                spec.axis), logp)
            comps.append(self._log_weights[i] + lq)
        return torch.logsumexp(torch.stack(comps), dim=0)
