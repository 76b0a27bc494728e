"""Proposal generators and their mixture, batched over chains.

Counterpart of ``icp_proposal_tpu/sampling/proposals.py``: the informed
ICP proposal in both directions, the Langevin (MALA) shape proposal, the
random-shape walk and the single-axis random pose walks, with optional
Robbins–Monro scale adaptation.  As in the reference, the mixture is
evaluated densely: every component proposes for every chain, one is
selected per chain, and the transition density is the logsumexp over
components of log w_c + log q_c, with −∞ where a component cannot reach the
state (pose or scale changed).
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
from icp_proposal_tpu_torch.sampling.state import (
    FitState,
    pose_inverse_apply,
    transformed_points,
)
from icp_proposal_tpu_torch.utils.profiling import span

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


@dataclass(frozen=True)
class MalaSpec:
    """Gradient-informed shape proposal (MALA; beyond the reference):
    α' = α + (h²/2)·∇log π(α) + h·ξ, ξ ~ N(0, I), with the exact asymmetric
    Langevin correction.  log π is the product evaluator the chain samples,
    bound when the step is built (``MixtureProgram.bind_target``)."""

    step_size: float = 0.1

    @property
    def sigma(self):  # the scale adaptation reads every component's sigma
        return self.step_size

    @property
    def name(self):
        return f"MALA-{self.step_size}"


ProposalSpec = Union[RandomShapeSpec, RotationSpec, TranslationSpec, IcpSpec,
                     MalaSpec]


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


def gradient_shape_proposal(step_sizes=(0.2,)) -> List[Tuple[float, ProposalSpec]]:
    """MALA mixture over coefficient space, one component a step size."""
    w = 1.0 / len(step_sizes)
    return [(w, MalaSpec(step_size=h)) for h in step_sizes]


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


def _col(x):
    """A per-chain scale [B] as a column [B, 1]; a float stays a float."""
    return x[:, None] if isinstance(x, torch.Tensor) else x


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _gaussian_walk_logpdf(delta: torch.Tensor, sigma) -> torch.Tensor:
    """log N(delta; 0, σ²I) over the last axis of delta [B, n]; σ a float or
    a per-chain [B]."""
    n = delta.shape[-1]
    return (-0.5 * torch.sum((delta / _col(sigma)) ** 2, dim=-1)
            - n * _log(sigma) - 0.5 * n * _LOG_2PI)


class IcpComponent:
    """Concrete ICP proposal: spec + precomputed sample ids; ``factors``
    finds the correspondences at a state and has ``models/gpmm`` turn them
    into the coefficient-space GP-posterior factors (the reference's
    ``icpPosterior`` in closed form)."""

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
            # the model direction observes a FIXED vertex subset
            self._static_tables = gp.static_tables(gpmm, self.model_ids)
        if spec.direction == "target":
            # boundary-aware: observations at model-boundary vertices weigh 0
            self._target_tables = gp.target_tables(
                gpmm, self._model_boundary if spec.boundary_aware else None)

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
            with span("icp.correspond"):
                if shared_cp_fidx is not None:
                    cp, fidx = shared_cp_fidx
                else:
                    q = cur_points[:, self._model_ids_t]
                    cp, _, fidx = closest_auto(q, self.ctx.points, self.ctx.cells,
                                               self.ctx.index)
                near = nearest_vertex_of_faces(self.ctx.cells, fidx, cp, self.ctx.points)
                tables = self._static_tables
                obs_disp = pose_inverse_apply(state, cp) - tables.ref
                normals = cur_normals[:, self._model_ids_t]
                mask = self._mask(self.ctx.boundary[near])
            return gp.posterior_factors_anisotropic_static(
                self.gpmm, tables.q, tables.gram, tables.mean, obs_disp, normals,
                spec.noise_along_normal, spec.tangential_noise, mask)
        # target→model: nearest candidate-mesh vertex per sampled target
        # point (K3, one vertex set per chain); the boundary weights are the
        # tables'
        with span("icp.correspond"):
            bsz = cur_points.shape[0]
            tq = self._target_points.expand(bsz, -1, -1).contiguous()
            with span("surface.query"):
                ids = nearest_vertices(tq, cur_points.contiguous())  # [B, m]
            target_points = pose_inverse_apply(state, tq)
        return gp.posterior_factors_anisotropic(
            self._target_tables, ids, target_points, cur_normals, spec.noise_along_normal,
            spec.tangential_noise)

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


class MalaComponent:
    """Langevin shape proposal over the bound target density (MalaSpec).

    The same anchored protocol as ``IcpComponent``: the anchor (∇log π at a
    state, [B, r]) is computed once a step at the candidate and carried for
    the current state.  ``zeroed`` counts the non-finite gradient entries
    set to 0 since the component was built (a device tensor, read without
    a sync only when asked)."""

    def __init__(self, spec: MalaSpec, gpmm):
        self.spec = spec
        self.gpmm = gpmm
        self._evaluator = None  # set by bind()
        self.zeroed = torch.zeros((), dtype=torch.int64, device=gpmm.device)

    def bind(self, evaluator):
        """Bind ∇log π to the product evaluator the chain samples."""
        self._evaluator = evaluator

    def factors(self, state: FitState, cur_points=None, cur_normals=None) -> torch.Tensor:
        """∇log π at each chain's coefficients → [B, r], detached, with its
        non-finite entries set to 0 (a degenerate closest-point
        configuration; the proposal is then a random walk for that chain and
        its density stays defined).  Chains are independent, so the gradient
        of the sum over chains is each chain's own."""
        if self._evaluator is None:
            raise RuntimeError(
                "MalaComponent is unbound: MixtureProgram.bind_target(evaluator) "
                "runs in mh.make_mh_step and mh.init_carry; build the step there")
        with torch.enable_grad():
            coeffs = state.coeffs.detach().requires_grad_(True)
            st = state._replace(coeffs=coeffs)
            log_pi = self._evaluator(st, transformed_points(self.gpmm, st))[0]
            (g,) = torch.autograd.grad(log_pi.sum(), coeffs)
        finite = torch.isfinite(g)
        self.zeroed += torch.sum(~finite)
        return torch.where(finite, g, 0.0)

    def propose(self, state: FitState, g: torch.Tensor, h, z: torch.Tensor) -> FitState:
        """α' = α + (h²/2)·g + h·z, h a float or per-chain [B]."""
        h = _col(h)
        return state._replace(coeffs=state.coeffs + 0.5 * h * h * g + h * z)

    def log_q(self, from_state: FitState, to_state: FitState, g_from: torch.Tensor, h):
        h_col = _col(h)
        mean = from_state.coeffs + 0.5 * h_col * h_col * g_from
        logp = _gaussian_walk_logpdf(to_state.coeffs - mean, h)
        return _guard(_pose_scale_equal(from_state, to_state), logp)


@dataclass(frozen=True)
class AdaptConfig:
    """Diminishing Robbins–Monro scale adaptation (beyond the reference).

    The log-scale s_c of component c is updated only on steps where c was
    selected, s_c += rate / (1 + t)^decay · (min(1, e^{log α}) − target_c),
    and frozen after ``adapt_steps``; target_c is ``target`` for a walk and
    0.574 for MALA.  Diminishing adaptation keeps the chain ergodic; the
    forward and reverse densities of a step use the same scales."""

    target: float = 0.234
    rate: float = 1.0
    decay: float = 0.6
    adapt_steps: int = 10 ** 9  # adapt "forever" by default


class MixtureProgram:
    """A flattened, normalized proposal mixture over FitState.

    ``parity=True`` evaluates the ICP components with the reference's own
    transition density (no ½·log det M, no relaxation Jacobian); False is
    the exact MH correction.  ``icp_model_ids``: the model vertices every
    ICP component observes (the flagship setup passes a subset of the
    evaluator's, so one closest-point pass serves both); None takes the
    reference's seeded, Morton-ordered subset (``seed``).  Target vertices
    are the seeded subset of ``seed + 1``.  ``adapt``: an ``AdaptConfig``
    for Robbins–Monro scale adaptation of every component but ICP, whose
    step noise is the GP posterior itself; None keeps the scales fixed."""

    def __init__(self, weighted_specs, gpmm, ctx: TargetContext, model_boundary,
                 parity: bool = False, seed: int = _MODEL_SEED,
                 adapt: AdaptConfig | None = None, icp_model_ids=None):
        with span("setup.mixture"):
            for _, s in weighted_specs:
                if not isinstance(s, (IcpSpec, MalaSpec, RandomShapeSpec, RotationSpec,
                                      TranslationSpec)):
                    raise TypeError(f"unknown proposal spec {s}")
            total = sum(w for w, _ in weighted_specs)
            self.weights = [w / total for w, _ in weighted_specs]
            self.specs = [s for _, s in weighted_specs]
            self.names = [s.name for s in self.specs]
            self.parity = parity
            self.adapt = adapt
            self.gpmm = gpmm
            self.ctx = ctx
            dev = gpmm.device
            self._log_weights = torch.log(torch.tensor(self.weights, dtype=torch.float32,
                                                       device=dev))
            # components with an adaptable scalar scale, and their acceptance
            # targets: 0.574 for Langevin proposals, cfg.target (0.234) for walks
            self.adaptable = np.asarray([not isinstance(s, IcpSpec) for s in self.specs],
                                        np.float32)
            self.adapt_targets = np.asarray(
                [0.574 if isinstance(s, MalaSpec)
                 else (adapt.target if adapt is not None else 0.234) for s in self.specs],
                np.float32)
            self._adaptable_t = torch.as_tensor(self.adaptable, device=dev)
            self._adapt_targets_t = torch.as_tensor(self.adapt_targets, device=dev)
            # "anchored" components carry per-state data through the carry: ICP
            # its GP-posterior factors, MALA ∇log π (the historic name is the
            # reference's)
            self.icp_components = {}
            tpts = ctx.points.cpu().numpy()
            ref = gpmm.ref_points.cpu().numpy()
            for i, s in enumerate(self.specs):
                if isinstance(s, MalaSpec):
                    self.icp_components[i] = MalaComponent(s, gpmm)
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

    def needs_normals(self) -> bool:
        return any(isinstance(c, IcpComponent) for c in self.icp_components.values())

    def bind_target(self, evaluator):
        """Bind the gradient-informed components to the chain's target
        density (``mh.make_mh_step`` and ``mh.init_carry`` call this)."""
        for comp in self.icp_components.values():
            if isinstance(comp, MalaComponent):
                comp.bind(evaluator)

    def anchor_factors(self, state, cur_points, cur_normals, shared=None):
        """Anchors at ``state`` → dict idx → ICP posterior factors or MALA's
        gradient; ``shared``: optional dict idx → (cp, fidx) from a fused
        query pass."""
        shared = shared or {}
        return {i: (comp.factors(state, cur_points, cur_normals, shared.get(i))
                    if isinstance(comp, IcpComponent)
                    else comp.factors(state, cur_points, cur_normals))
                for i, comp in self.icp_components.items()}

    def _sigma(self, i, spec, scales):
        """Component i's scale: its sigma, times the chains' adaptive factors
        scales [B, C] when given (→ [B])."""
        if scales is None:
            return spec.sigma
        return spec.sigma * scales[:, i]

    def propose_all(self, state: FitState, factors_cur, z: torch.Tensor,
                    scales: torch.Tensor | None = None) -> List[FitState]:
        """One candidate per component from standard normals z [B, C, r]; a
        pose component reads its scalar draw at z[:, c, 0].  ``scales``
        [B, C]: the adaptive scale factors of the carry (None → 1)."""
        candidates = []
        for i, spec in enumerate(self.specs):
            if isinstance(spec, IcpSpec):
                cand = self.icp_components[i].propose(state, factors_cur[i], z[:, i])
            elif isinstance(spec, MalaSpec):
                cand = self.icp_components[i].propose(
                    state, factors_cur[i], self._sigma(i, spec, scales), z[:, i])
            elif isinstance(spec, RandomShapeSpec):
                eps = _col(self._sigma(i, spec, scales)) * z[:, i]
                cand = state._replace(coeffs=state.coeffs + eps)
            else:
                field = "rot" if isinstance(spec, RotationSpec) else "trans"
                moved = getattr(state, field).clone()
                moved[:, spec.axis] += self._sigma(i, spec, scales) * z[:, i, 0]
                cand = state._replace(**{field: moved})
            candidates.append(cand)
        return candidates

    def log_q_mixture(self, from_state: FitState, to_state: FitState, factors_from,
                      scales: torch.Tensor | None = None) -> torch.Tensor:
        """log q_mix(to|from) = logsumexp_c [log w_c + log q_c(to|from)] → [B]."""
        comps = []
        for i, spec in enumerate(self.specs):
            if isinstance(spec, IcpSpec):
                lq = self.icp_components[i].log_q(from_state, to_state,
                                                  factors_from[i], self.parity)
            elif isinstance(spec, MalaSpec):
                lq = self.icp_components[i].log_q(from_state, to_state, factors_from[i],
                                                  self._sigma(i, spec, scales))
            elif isinstance(spec, RandomShapeSpec):
                logp = _gaussian_walk_logpdf(to_state.coeffs - from_state.coeffs,
                                             self._sigma(i, spec, scales))
                lq = _guard(_pose_scale_equal(from_state, to_state), logp)
            else:
                sigma = self._sigma(i, spec, scales)
                field = "rot" if isinstance(spec, RotationSpec) else "trans"
                delta = (getattr(to_state, field)[:, spec.axis]
                         - getattr(from_state, field)[:, spec.axis])
                logp = -0.5 * (delta / sigma) ** 2 - _log(sigma) - 0.5 * _LOG_2PI
                lq = _guard(_all_but_axis_equal(from_state, to_state, field,
                                                spec.axis), logp)
            comps.append(self._log_weights[i] + lq)
        return torch.logsumexp(torch.stack(comps), dim=0)

    def update_scales(self, log_scales: torch.Tensor, step_idx: torch.Tensor,
                      selected: torch.Tensor, log_alpha: torch.Tensor) -> torch.Tensor:
        """Robbins–Monro log-scale update per chain (no-op without
        ``adapt``): log_scales [B, C], step_idx [B] float32, selected [B]
        component ids, log α [B] → [B, C]."""
        if self.adapt is None:
            return log_scales
        cfg = self.adapt
        accept_prob = torch.clamp_max(torch.exp(torch.clamp_max(log_alpha, 0.0)), 1.0)
        gamma = cfg.rate / (1.0 + step_idx) ** cfg.decay
        active = (step_idx < cfg.adapt_steps).to(torch.float32)
        onehot = (torch.nn.functional.one_hot(selected.long(), self.num_components)
                  .to(torch.float32) * self._adaptable_t)
        return log_scales + (active * gamma)[:, None] * onehot * (
            accept_prob[:, None] - self._adapt_targets_t)
