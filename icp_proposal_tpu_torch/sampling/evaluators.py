"""Prior + likelihood evaluators, batched over chains.

Counterpart of ``icp_proposal_tpu/sampling/evaluators.py`` for the slice's
evaluator: the prior plus the Euclidean model→target independent-points
likelihood (reference ``IndependentPointDistanceEvaluator.scala:27-67``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.ops.morton import morton_sort_ids
from icp_proposal_tpu_torch.ops.surface_index import distances_auto
from icp_proposal_tpu_torch.ops.surface_sampling import seeded_vertex_subset
from icp_proposal_tpu_torch.sampling.context import TargetContext
from icp_proposal_tpu_torch.sampling.state import FitState

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logpdf(x, mean, sigma):
    z = (x - mean) / sigma
    return -0.5 * z * z - math.log(sigma) - 0.5 * _LOG_2PI


@dataclass(frozen=True)
class IndependentPointsSpec:
    """Sum of Gaussian(0, σ) log-likelihoods of point→surface distances."""

    sigma: float = 1.0
    mode: str = "model_to_target"
    n_points: int = 100
    name: str = "distance"


class EvaluatorProgram:
    """The prior plus the likelihood terms of ``specs``:
    ``__call__(state, points [B, V, 3]) -> (log_product [B], named [B, k])``
    with ``named_keys`` = ["product", "prior", <likelihood names>]."""

    def __init__(self, gpmm, target_ctx: TargetContext, specs):
        for s in specs:
            if not isinstance(s, IndependentPointsSpec):
                raise NotImplementedError(
                    f"{type(s).__name__} is not ported yet (ROADMAP queue 1, "
                    f"slice 6: remaining evaluators and modes)")
            if s.mode != "model_to_target":
                raise NotImplementedError(
                    f"the {s.mode} mode needs the dense kernel K5 (ROADMAP "
                    f"queue 1, slice 6)")
        self.gpmm = gpmm
        self.ctx = target_ctx
        self.specs = tuple(specs)
        self.named_keys: List[str] = ["product", "prior"] + [s.name for s in self.specs]
        ref = gpmm.ref_points.cpu().numpy()
        # the reference's seeded, Morton-ordered evaluation subsets
        self._model_ids = {
            s.name: np.asarray(morton_sort_ids(
                ref, seeded_vertex_subset(gpmm.num_points, s.n_points, seed=1024)))
            for s in self.specs
        }
        self._model_ids_t = {
            name: torch.as_tensor(ids, dtype=torch.int64, device=gpmm.device)
            for name, ids in self._model_ids.items()
        }

    def model_ids(self, spec_name: str = "distance"):
        """A likelihood spec's seeded model-vertex subset (numpy)."""
        try:
            return self._model_ids[spec_name]
        except KeyError:
            raise KeyError(
                f"no likelihood spec named {spec_name!r} with a model-vertex "
                f"subset; have {sorted(self._model_ids)}"
            ) from None

    def _independent(self, spec: IndependentPointsSpec, points, shared_d2=None):
        if shared_d2 is None:
            q = points[:, self._model_ids_t[spec.name]]
            shared_d2, _ = distances_auto(q, self.ctx.tri, self.ctx.index)
        return torch.sum(gaussian_logpdf(torch.sqrt(shared_d2), 0.0, spec.sigma),
                         dim=-1)

    def __call__(self, state: FitState, current_points, shared=None):
        """``shared``: optional dict spec name → d2 [B, P] from a fused query
        pass (``mh._fusion_plan``)."""
        shared = shared or {}
        values = [gp.prior_logpdf(state.coeffs)]
        for s in self.specs:
            values.append(self._independent(s, current_points, shared.get(s.name)))
        product = sum(values)
        named = torch.stack([product] + values, dim=-1)
        return product, named


def proximity_and_independent(gpmm, target_ctx, mode="model_to_target",
                              sigma=1.0, n_points=100):
    """Reference ``ProductEvaluators.proximityAndIndependent`` (:38-55)."""
    return EvaluatorProgram(
        gpmm, target_ctx,
        [IndependentPointsSpec(sigma=sigma, mode=mode, n_points=n_points)])
