"""Typed run configuration.

Counterpart of ``icp_proposal_tpu/utils/config.py``.  The reference has no
config system: every knob is a constant in an app's ``main`` (SURVEY §5.6).
This module captures that configuration surface as a dataclass tree with
JSON round-tripping: proposal mixture weights and noise scales, projection
direction, evaluation mode, likelihood σ and rate, point counts (rank-derived
or absolute), chain length, decimation levels, seeds.  The default
``RunConfig`` is the flagship recipe: ICP 0.9 in both directions, random
shape 0.1 at σ = 0.1, the independent Euclidean evaluator with σ = 2.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class IcpProposalConfig:
    weight: float = 0.9
    projection_direction: str = "model_and_target"  # model | target | model_and_target
    step_length: float = 0.1
    tangential_noise: float = 10.0
    noise_along_normal: float = 5.0
    n_points: Optional[int] = None  # None → 2·rank (reference default)
    boundary_aware: bool = True


@dataclass
class RandomShapeConfig:
    weight: float = 0.1
    steps: Tuple[float, ...] = (0.1,)


@dataclass
class PoseProposalConfig:
    weight: float = 0.0
    rot_sigma: Tuple[float, float, float] = (0.01, 0.01, 0.01)  # yaw,pitch,roll
    trans_sigma: Tuple[float, float, float] = (0.1, 0.1, 0.1)


@dataclass
class EvaluatorConfig:
    kind: str = "independent"  # independent | hausdorff | collective | acceptall
    mode: str = "model_to_target"  # model_to_target | target_to_model | symmetric
    sigma: float = 2.0  # Gaussian σ (independent) / σ_avg (collective)
    rate: float = 100.0  # Exponential rate (hausdorff) / rate_max (collective)
    mean: float = 0.0  # collective avg mean
    n_points: Optional[int] = None  # None → 4·rank (reference default)


@dataclass
class ChainConfig:
    num_samples: int = 10000
    n_chains: int = 1
    seed: int = 1024
    parity: bool = False  # True → reference-faithful transition density
    store_params: bool = True
    segment_size: Optional[int] = None


@dataclass
class RunConfig:
    model_components: int = 50
    decimate_model_to: Optional[int] = None
    decimate_target_to: Optional[int] = None
    icp: IcpProposalConfig = field(default_factory=IcpProposalConfig)
    random_shape: RandomShapeConfig = field(default_factory=RandomShapeConfig)
    pose: PoseProposalConfig = field(default_factory=PoseProposalConfig)
    evaluator: EvaluatorConfig = field(default_factory=EvaluatorConfig)
    chain: ChainConfig = field(default_factory=ChainConfig)

    # ------------------------------------------------------------------ io
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw = json.loads(text)
        return RunConfig(
            model_components=raw.get("model_components", 50),
            decimate_model_to=raw.get("decimate_model_to"),
            decimate_target_to=raw.get("decimate_target_to"),
            icp=IcpProposalConfig(**raw.get("icp", {})),
            random_shape=RandomShapeConfig(
                **{**raw.get("random_shape", {}),
                   "steps": tuple(raw.get("random_shape", {}).get("steps", (0.1,)))}
            ),
            pose=PoseProposalConfig(
                **{**raw.get("pose", {}),
                   "rot_sigma": tuple(raw.get("pose", {}).get("rot_sigma", (0.01,) * 3)),
                   "trans_sigma": tuple(raw.get("pose", {}).get("trans_sigma", (0.1,) * 3))}
            ),
            evaluator=EvaluatorConfig(**raw.get("evaluator", {})),
            chain=ChainConfig(**raw.get("chain", {})),
        )


def build_from_config(cfg: RunConfig, model, target, model_boundary, target_boundary):
    """Materialize (ctx, mixture, evaluator) from a RunConfig on the
    model's device, with the shortlist index's exact coarse pass.  The ICP
    components observe the reference's seeded vertex subsets
    (``MixtureProgram``'s default), as JAX's ``build_from_config`` does: the
    first 2·rank ids of the evaluator's seeded subset, so one closest-point
    pass serves both.  The hand-built flagship setup
    (``apps/femur.make_icp_proposal_setup``) observes a stride-2 slice of the
    evaluator's points instead, so its ICP proposals differ from these."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import (
        accept_all,
        proximity_and_collective_hausdorff_boundary_aware,
        proximity_and_hausdorff,
        proximity_and_independent,
    )
    from icp_proposal_tpu_torch.sampling.proposals import (
        MixtureProgram,
        mixed_proposal_icp,
        mixed_random_pose_proposal,
        mixed_random_shape_proposal,
        nest,
    )

    ctx = build_target_context(target, target_boundary, device=model.device)
    rank = model.rank
    groups = []
    if cfg.icp.weight > 0:
        groups.append(
            (cfg.icp.weight, mixed_proposal_icp(
                n_points=cfg.icp.n_points or 2 * rank,
                projection_direction=cfg.icp.projection_direction,
                tangential_noise=cfg.icp.tangential_noise,
                noise_along_normal=cfg.icp.noise_along_normal,
                step_length=cfg.icp.step_length,
                boundary_aware=cfg.icp.boundary_aware,
            ))
        )
    if cfg.random_shape.weight > 0:
        groups.append(
            (cfg.random_shape.weight,
             mixed_random_shape_proposal(cfg.random_shape.steps))
        )
    if cfg.pose.weight > 0:
        y, p, r = cfg.pose.rot_sigma
        tx, ty, tz = cfg.pose.trans_sigma
        groups.append(
            (cfg.pose.weight, mixed_random_pose_proposal(y, p, r, tx, ty, tz))
        )
    mixture = MixtureProgram(nest(*groups), model, ctx, np.asarray(model_boundary),
                             parity=cfg.chain.parity)

    e = cfg.evaluator
    n_eval = e.n_points or 4 * rank
    if e.kind == "independent":
        evaluator = proximity_and_independent(
            model, ctx, mode=e.mode, sigma=e.sigma, n_points=n_eval
        )
    elif e.kind == "hausdorff":
        evaluator = proximity_and_hausdorff(model, ctx, rate=e.rate)
    elif e.kind == "collective":
        evaluator = proximity_and_collective_hausdorff_boundary_aware(
            model, ctx, mode=e.mode, sigma_avg=e.sigma, rate_max=e.rate,
            mean=e.mean, n_points=n_eval,
        )
    elif e.kind == "acceptall":
        evaluator = accept_all(model, ctx)
    else:
        raise ValueError(f"unknown evaluator kind {e.kind}")
    return ctx, mixture, evaluator
