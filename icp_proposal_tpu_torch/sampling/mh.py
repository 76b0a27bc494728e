"""The Metropolis–Hastings engine, batched over chains.

Counterpart of ``icp_proposal_tpu/sampling/mh.py``: one step is a function
``(carry, noise) -> (carry, record)`` over a leading chain dimension, and a
Python loop runs the steps.  Accept iff

    log u < [log p(θ') − log p(θ)] + [log q(θ|θ') − log q(θ'|θ)]

with the mixture transition densities of ``MixtureProgram`` (forward
anchors carried for the current state, reverse anchors computed at the
candidate).  A NaN log α (a non-SPD posterior factor) is a reject.  With
scale adaptation the carry also holds each chain's log-scales and step
count, updated after the accept test.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from icp_proposal_tpu_torch.mesh import vertex_face_adjacency, vertex_normals_gather
from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.ops.surface_index import closest_auto
from icp_proposal_tpu_torch.sampling.evaluators import (
    EvaluatorProgram,
    IndependentPointsSpec,
)
from icp_proposal_tpu_torch.sampling.proposals import IcpComponent, MixtureProgram
from icp_proposal_tpu_torch.sampling.state import FitState, transformed_points


class _FusionPlan(NamedTuple):
    """Static plan for the fused target-surface query pass: when the
    model-direction ICP ids are a subset of the evaluator's ids, ONE
    ``closest_auto`` over the evaluator ids serves both (the evaluator reads
    d2 of all rows, the ICP factors read (cp, fidx) of their rows)."""

    eval_ids: torch.Tensor  # [P] model vertex ids, queried once per step
    spec_name: str  # evaluator spec consuming the d2
    icp_maps: dict  # component idx -> [m] positions into the query rows


def _fusion_plan(mixture: MixtureProgram, evaluator: EvaluatorProgram):
    """The fused-query plan, or None when the configuration doesn't allow
    sharing (different contexts, no Euclidean spec with a model→target
    term, ICP ids not a subset).  The collective evaluator of the BFM
    partial setup has no such term: that setup runs unfused, as in the
    reference."""
    if evaluator.ctx is not mixture.ctx:
        return None
    spec = next((s for s in evaluator.specs
                 if isinstance(s, IndependentPointsSpec)
                 and s.mode in ("model_to_target", "symmetric")), None)
    if spec is None:
        return None
    eval_ids = np.asarray(evaluator.model_ids(spec.name))
    pos = {int(v): i for i, v in enumerate(eval_ids)}
    dev = mixture.gpmm.device
    icp_maps = {}
    for i, comp in mixture.icp_components.items():
        if isinstance(comp, IcpComponent) and comp.spec.direction == "model":
            if all(int(v) in pos for v in comp.model_ids):
                icp_maps[i] = torch.as_tensor(
                    [pos[int(v)] for v in comp.model_ids], dtype=torch.int64,
                    device=dev)
    if not icp_maps:
        return None
    return _FusionPlan(
        eval_ids=torch.as_tensor(eval_ids, dtype=torch.int64, device=dev),
        spec_name=spec.name, icp_maps=icp_maps)


class MhCarry(NamedTuple):
    state: FitState
    log_post: torch.Tensor  # [B] cached product-evaluator value
    named: torch.Tensor  # [B, k] cached named evaluator values
    # anchors at the CURRENT state, one per anchored mixture component in
    # component order (ICP: GP-posterior factors; MALA: ∇log π [B, r]);
    # they always equal anchor_factors(state)
    icp_factors: tuple = ()
    # scale adaptation (MixtureProgram.adapt; None without it), float32 as
    # in the reference, which computes (1 + t)^decay in float32
    adapt_log_scales: Optional[torch.Tensor] = None  # [B, C]
    step_idx: Optional[torch.Tensor] = None  # [B]


class ChainRecord(NamedTuple):
    """Per-step record; ``coeffs`` and ``pose`` hold the post-step chain
    state (the candidate on accept, the previous state on reject), as in
    the reference's ``ChainRecord``.  ``stack_records`` turns a run's list
    of records into one with [B, T, ...] fields."""

    accepted: torch.Tensor  # [B] bool
    proposal_idx: torch.Tensor  # [B] int32
    log_product: torch.Tensor  # [B] candidate product value
    named: torch.Tensor  # [B, k] candidate named evaluator values
    coeffs: Optional[torch.Tensor] = None  # [B, r] (if stored)
    pose: Optional[torch.Tensor] = None  # [B, 9] trans, rot, center (if stored)
    log_alpha: Optional[torch.Tensor] = None  # [B] (if stored)


class StepNoise(NamedTuple):
    """All randomness of one step: standard normals per component (a pose
    component reads its one scalar at z[:, c, 0]), the selected component
    and log u of the accept test."""

    z: torch.Tensor  # [B, C, r]
    idx: torch.Tensor  # [B] int64
    log_u: torch.Tensor  # [B]


def draw_noise(mixture: MixtureProgram, n_chains: int,
               generator: torch.Generator) -> StepNoise:
    dev = mixture.gpmm.device
    z = torch.randn((n_chains, mixture.num_components, mixture.gpmm.rank),
                    generator=generator, device=dev)
    weights = torch.as_tensor(mixture.weights, dtype=torch.float32, device=dev)
    idx = torch.multinomial(weights.expand(n_chains, -1), 1, replacement=True,
                            generator=generator)[:, 0]
    log_u = torch.log(torch.rand(n_chains, generator=generator, device=dev))
    return StepNoise(z=z, idx=idx, log_u=log_u)


def _select(cands, idx: torch.Tensor) -> FitState:
    """Per chain, the candidate of component idx[b]."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    return FitState(*(torch.stack(fields, dim=1)[rows, idx]
                      for fields in zip(*cands)))


def _where(accept: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(accept.reshape(accept.shape + (1,) * (a.dim() - 1)), a, b)


def _where_anchor(accept: torch.Tensor, a, b):
    """Per chain, anchor a where accepted, else b: ICP posterior factors
    field by field, or MALA's gradient."""
    if isinstance(a, gp.PosteriorFactors):
        return gp.PosteriorFactors(*(_where(accept, x, y) for x, y in zip(a, b)))
    return _where(accept, a, b)


def _normals_of(gpmm, mixture: MixtureProgram):
    """points [B, V, 3] → unit vertex normals, or None when no component
    reads them (no ICP component)."""
    if not mixture.needs_normals():
        return lambda points: None
    adjacency = torch.as_tensor(
        vertex_face_adjacency(gpmm.cells.cpu().numpy(), gpmm.num_points),
        dtype=torch.int64, device=gpmm.device)
    return lambda points: vertex_normals_gather(points, gpmm.cells, adjacency)


def make_mh_step(gpmm, mixture: MixtureProgram, evaluator: EvaluatorProgram,
                 store_params: bool = False, fuse: bool = True):
    """Build the MH step for a fixed configuration:
    ``step(carry, noise=None, generator=None) -> (carry, record)``.

    ``noise`` (a ``StepNoise``) is drawn from ``generator`` when not given;
    ``step.mixture`` is the mixture it is drawn for.  fuse=True shares one
    target-surface closest-point pass between the model-direction ICP
    correspondence and the Euclidean evaluator when the configuration allows
    it; the results are identical to separate passes."""
    # gradient-informed components differentiate the target density itself
    mixture.bind_target(evaluator)
    plan = _fusion_plan(mixture, evaluator) if fuse else None
    normals_of = _normals_of(gpmm, mixture)
    icp_idx = sorted(mixture.icp_components)

    def step(carry: MhCarry, noise: StepNoise | None = None,
             generator: torch.Generator | None = None):
        state = carry.state
        if noise is None:
            noise = draw_noise(mixture, state.coeffs.shape[0], generator)
        factors_cur = dict(zip(icp_idx, carry.icp_factors))
        scales = (torch.exp(carry.adapt_log_scales) if mixture.adapt is not None
                  else None)

        # dense candidate generation, then per-chain selection
        candidates = mixture.propose_all(state, factors_cur, noise.z, scales)
        cand = _select(candidates, noise.idx)

        # reverse anchor + densities
        cand_pts = transformed_points(gpmm, cand)
        cand_normals = normals_of(cand_pts)
        shared_icp = shared_eval = None
        if plan is not None:
            q = cand_pts[:, plan.eval_ids]
            ctx = mixture.ctx
            cp_all, d2_all, fidx_all = closest_auto(q, ctx.points, ctx.cells, ctx.index)
            shared_icp = {i: (cp_all[:, m], fidx_all[:, m])
                          for i, m in plan.icp_maps.items()}
            shared_eval = {plan.spec_name: d2_all}
        factors_cand = mixture.anchor_factors(cand, cand_pts, cand_normals,
                                              shared_icp)
        log_q_fwd = mixture.log_q_mixture(state, cand, factors_cur, scales)
        log_q_rev = mixture.log_q_mixture(cand, state, factors_cand, scales)
        log_post_cand, named_cand = evaluator(cand, cand_pts, shared_eval)

        log_alpha = (log_post_cand - carry.log_post) + (log_q_rev - log_q_fwd)
        log_alpha = torch.where(torch.isnan(log_alpha), -torch.inf, log_alpha)
        accept = noise.log_u < log_alpha

        new_state = FitState(*(_where(accept, c, s) for c, s in zip(cand, state)))
        new_factors = tuple(_where_anchor(accept, factors_cand[i], factors_cur[i])
                            for i in icp_idx)
        log_scales, step_idx = carry.adapt_log_scales, carry.step_idx
        if mixture.adapt is not None:
            log_scales = mixture.update_scales(log_scales, step_idx, noise.idx, log_alpha)
            step_idx = step_idx + 1
        new_carry = MhCarry(
            state=new_state,
            log_post=torch.where(accept, log_post_cand, carry.log_post),
            named=_where(accept, named_cand, carry.named),
            icp_factors=new_factors,
            adapt_log_scales=log_scales,
            step_idx=step_idx,
        )
        record = ChainRecord(
            accepted=accept,
            proposal_idx=noise.idx.to(torch.int32),
            log_product=log_post_cand,
            named=named_cand,
            coeffs=new_state.coeffs if store_params else None,
            pose=(torch.cat([new_state.trans, new_state.rot, new_state.center], dim=-1)
                  if store_params else None),
            log_alpha=log_alpha if store_params else None,
        )
        return new_carry, record

    step.mixture = mixture
    return step


def init_carry(gpmm, evaluator: EvaluatorProgram, state: FitState,
               mixture: Optional[MixtureProgram] = None) -> MhCarry:
    """Evaluator values, the anchors of the mixture's anchored components
    at the initial state and, with adaptation, log-scales 0 and step 0."""
    pts = transformed_points(gpmm, state)
    log_post, named = evaluator(state, pts)
    factors = ()
    if mixture is not None and mixture.icp_components:
        mixture.bind_target(evaluator)
        fac = mixture.anchor_factors(state, pts, _normals_of(gpmm, mixture)(pts))
        factors = tuple(fac[i] for i in sorted(fac))
    log_scales = step_idx = None
    if mixture is not None and mixture.adapt is not None:
        n = state.coeffs.shape[0]
        log_scales = torch.zeros((n, mixture.num_components), device=gpmm.device)
        step_idx = torch.zeros(n, device=gpmm.device)
    return MhCarry(state=state, log_post=log_post, named=named, icp_factors=factors,
                   adapt_log_scales=log_scales, step_idx=step_idx)


def run_chains(step, carry: MhCarry, n_steps: int,
               generator: torch.Generator | None = None):
    """Run every chain of ``carry`` for n_steps → (final carry, records)."""
    records = []
    for _ in range(n_steps):
        carry, rec = step(carry, generator=generator)
        records.append(rec)
    return carry, records


def run_chain(step, carry: MhCarry, n_steps: int,
              generator: torch.Generator | None = None):
    """Run one chain (a carry of batch 1) for n_steps → (final carry,
    ``ChainRecord`` with [T, ...] fields)."""
    if carry.log_post.shape[0] != 1:
        raise ValueError(f"run_chain takes one chain, got {carry.log_post.shape[0]}; "
                         "use run_chains")
    carry, records = run_chains(step, carry, n_steps, generator)
    return carry, ChainRecord(*(None if x is None else x[0]
                                for x in stack_records(records)))


def stack_states(states) -> FitState:
    """Join a list of FitStates (each with its own chains, B = 1 for one
    chain) into one batched FitState, in order."""
    return FitState(*(torch.cat(fields) for fields in zip(*states)))


def stack_records(records) -> ChainRecord:
    """A run's per-step records → one ``ChainRecord`` with [B, T, ...]
    fields (chains first, then steps, as the reference's stacked trace);
    fields that were not stored stay None."""
    return ChainRecord(*(None if field[0] is None else torch.stack(field, dim=1)
                         for field in zip(*records)))
