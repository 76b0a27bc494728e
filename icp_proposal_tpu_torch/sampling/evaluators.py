"""Prior + likelihood evaluators, batched over chains.

Counterpart of ``icp_proposal_tpu/sampling/evaluators.py``: the prior plus
the Euclidean independent-points likelihood in its three modes (reference
``IndependentPointDistanceEvaluator.scala:27-67``), the Hausdorff likelihood
(``HausdorffDistanceEvaluator.scala:25-36``), the boundary-aware collective
avg/max likelihood for partial targets
(``CollectiveAverageHausdorffDistanceBoundaryAwareEvaluator``) and the
constant accept-all term.  Model→target sums go through the shortlist index
(K3/K4) when the context has one; every target→model query and every max
statistic goes through the dense kernel K5, as in the reference.

Distribution conventions (breeze):
    Gaussian(mean, σ).logPdf(x)  = -(x-mean)²/(2σ²) - log(σ·√(2π))
    Exponential(rate).logPdf(x)  = log(rate) - rate·x
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Union

import numpy as np
import torch

from icp_proposal_tpu_torch.mesh import boundary_vertex_mask
from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.ops.closest_point import (
    closest_points_on_surface,
    nearest_vertex_of_faces,
    surface_distances_auto,
)
from icp_proposal_tpu_torch.ops.morton import morton_sort_ids
from icp_proposal_tpu_torch.ops.surface_index import distances_auto
from icp_proposal_tpu_torch.ops.surface_sampling import seeded_vertex_subset
from icp_proposal_tpu_torch.sampling.context import TargetContext
from icp_proposal_tpu_torch.sampling.state import FitState
from icp_proposal_tpu_torch.utils.profiling import span

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logpdf(x, mean, sigma):
    z = (x - mean) / sigma
    return -0.5 * z * z - math.log(sigma) - 0.5 * _LOG_2PI


def exponential_logpdf(x, rate):
    return math.log(rate) - rate * x


@dataclass(frozen=True)
class IndependentPointsSpec:
    """Sum of Gaussian(0, σ) log-likelihoods of point→surface distances."""

    sigma: float = 1.0
    mode: str = "model_to_target"  # model_to_target | target_to_model | symmetric
    n_points: int = 100
    name: str = "distance"


@dataclass(frozen=True)
class HausdorffSpec:
    """Exponential(rate) log-likelihood of the symmetric Hausdorff distance
    between the whole current mesh and the whole target."""

    rate: float = 1.0
    name: str = "distance_haussdorff"  # sic: the reference's key


@dataclass(frozen=True)
class CollectiveAvgMaxSpec:
    """Boundary-aware (avg, max) distance likelihood for partial targets:
    Gaussian(mean, σ_avg).logPdf(avg) + Exponential(rate_max).logPdf(max),
    over the correspondences whose nearest vertex on the queried surface is
    not on its boundary.  In the target→model direction that is the model's
    boundary, as the JAX package implements the reference's intent (its
    deviation note on ``CollectiveAvgMaxSpec``)."""

    sigma_avg: float = 1.0
    rate_max: float = 0.2
    mean: float = 0.0
    mode: str = "symmetric"
    n_points: int = 100
    name: str = "collective_distance"


@dataclass(frozen=True)
class AcceptAllSpec:
    """Constant 0 log-density (reference ``AcceptAllEvaluator.scala``)."""

    name: str = "acceptall"


LikelihoodSpec = Union[IndependentPointsSpec, HausdorffSpec, CollectiveAvgMaxSpec, AcceptAllSpec]


class EvaluatorProgram:
    """The prior (when ``include_prior``) plus the likelihood terms of
    ``specs``: ``__call__(state, points [B, V, 3]) -> (log_product [B],
    named [B, k])`` with ``named_keys`` = ["product", "prior", <likelihood
    names>] ("prior" only with the prior).  ``model_boundary`` [V] bool is
    the model's boundary mask, which the collective term's target→model
    direction reads (``build_evaluator`` derives it from the cells)."""

    def __init__(self, gpmm, target_ctx: TargetContext, specs, include_prior,
                 model_boundary):
        with span("setup.evaluator"):
            for s in specs:
                if not isinstance(s, (IndependentPointsSpec, HausdorffSpec,
                                      CollectiveAvgMaxSpec, AcceptAllSpec)):
                    raise TypeError(f"unknown evaluator spec {s}")
            self.gpmm = gpmm
            self.ctx = target_ctx
            self.specs = tuple(specs)
            self.include_prior = include_prior
            self.named_keys: List[str] = (["product"] + (["prior"] if include_prior else [])
                                          + [s.name for s in self.specs])
            dev = gpmm.device
            cells = gpmm.cells.cpu().numpy()
            self._model_boundary = torch.as_tensor(model_boundary, device=dev).bool()
            # int32 cells for K5
            self._model_cells = torch.as_tensor(cells, dtype=torch.int32, device=dev)
            self._target_cells = target_ctx.cells.to(torch.int32)
            ref = gpmm.ref_points.cpu().numpy()
            tpts = target_ctx.points.cpu().numpy()
            # the reference's seeded, Morton-ordered evaluation subsets
            self._model_ids, self._target_ids = {}, {}
            for s in self.specs:
                if isinstance(s, (IndependentPointsSpec, CollectiveAvgMaxSpec)):
                    self._model_ids[s.name] = np.asarray(morton_sort_ids(
                        ref, seeded_vertex_subset(gpmm.num_points, s.n_points, seed=1024)))
                    self._target_ids[s.name] = np.asarray(morton_sort_ids(
                        tpts, seeded_vertex_subset(len(tpts), s.n_points, seed=2048)))
            self._model_ids_t = {n: torch.as_tensor(ids, dtype=torch.int64, device=dev)
                                 for n, ids in self._model_ids.items()}
            self._target_q = {n: target_ctx.points[torch.as_tensor(ids, dtype=torch.int64,
                                                                   device=dev)]
                              for n, ids in self._target_ids.items()}

    def model_ids(self, spec_name: str = "distance"):
        """A likelihood spec's seeded model-vertex subset (numpy)."""
        try:
            return self._model_ids[spec_name]
        except KeyError:
            raise KeyError(
                f"no likelihood spec named {spec_name!r} with a model-vertex "
                f"subset; have {sorted(self._model_ids)}"
            ) from None

    def target_ids(self, spec_name: str):
        """A likelihood spec's seeded target-vertex subset (numpy), queried
        against the current mesh in the target→model direction."""
        return self._target_ids[spec_name]

    def _independent(self, spec: IndependentPointsSpec, points, shared_d2=None):
        terms = []
        if spec.mode in ("model_to_target", "symmetric"):
            if shared_d2 is None:
                q = points[:, self._model_ids_t[spec.name]]
                shared_d2, _ = distances_auto(q, self.ctx.points, self._target_cells,
                                              self.ctx.index)
            terms.append(torch.sum(gaussian_logpdf(torch.sqrt(shared_d2), 0.0,
                                                   spec.sigma), dim=-1))
        if spec.mode in ("target_to_model", "symmetric"):
            with span("surface.query"):
                d2, _ = surface_distances_auto(self._target_q[spec.name], points,
                                               self._model_cells)
            terms.append(torch.sum(gaussian_logpdf(torch.sqrt(d2), 0.0, spec.sigma),
                                   dim=-1))
        if spec.mode == "symmetric":
            return 0.5 * terms[0] + 0.5 * terms[1]
        return terms[0]

    def _hausdorff(self, spec: HausdorffSpec, points):
        # max statistics go through the dense kernel, never the shortlist
        with span("surface.query"):
            d2_m2t, _ = surface_distances_auto(points, self.ctx.points, self._target_cells)
            d2_t2m, _ = surface_distances_auto(self.ctx.points, points, self._model_cells)
        hd = torch.sqrt(torch.maximum(torch.amax(d2_m2t, dim=-1),
                                      torch.amax(d2_t2m, dim=-1)))
        return exponential_logpdf(hd, spec.rate)

    def _collective(self, spec: CollectiveAvgMaxSpec, points):
        # exact dense queries in both directions: the max term is a max
        # statistic too
        def masked_avg_max(queries, surf_points, cells, boundary):
            with span("surface.query"):
                cp, d2, fidx = closest_points_on_surface(queries, surf_points, cells)
            near = nearest_vertex_of_faces(cells, fidx, cp, surf_points)
            keep = ~boundary[near]
            d = torch.sqrt(d2)
            wsum = torch.clamp_min(torch.sum(keep, dim=-1), 1)
            avg = torch.sum(torch.where(keep, d, 0.0), dim=-1) / wsum
            mx = torch.amax(torch.where(keep, d, -torch.inf), dim=-1)
            return avg, mx

        avgs, maxs = [], []
        if spec.mode in ("model_to_target", "symmetric"):
            a, m = masked_avg_max(points[:, self._model_ids_t[spec.name]],
                                  self.ctx.points, self._target_cells, self.ctx.boundary)
            avgs.append(a)
            maxs.append(m)
        if spec.mode in ("target_to_model", "symmetric"):
            a, m = masked_avg_max(self._target_q[spec.name], points, self._model_cells,
                                  self._model_boundary)
            avgs.append(a)
            maxs.append(m)
        if spec.mode == "symmetric":
            avg = 0.5 * avgs[0] + 0.5 * avgs[1]
            mx = torch.maximum(maxs[0], maxs[1])
        else:
            avg, mx = avgs[0], maxs[0]
        return (gaussian_logpdf(avg, spec.mean, spec.sigma_avg)
                + exponential_logpdf(mx, spec.rate_max))

    def __call__(self, state: FitState, current_points, shared=None):
        """``shared``: optional dict spec name → model→target d2 [B, P] from
        a fused query pass (``mh._fusion_plan``)."""
        shared = shared or {}
        values = [gp.prior_logpdf(state.coeffs)] if self.include_prior else []
        for s in self.specs:
            if isinstance(s, IndependentPointsSpec):
                values.append(self._independent(s, current_points, shared.get(s.name)))
            elif isinstance(s, HausdorffSpec):
                values.append(self._hausdorff(s, current_points))
            elif isinstance(s, CollectiveAvgMaxSpec):
                values.append(self._collective(s, current_points))
            else:
                values.append(torch.zeros(state.coeffs.shape[0],
                                          device=state.coeffs.device))
        product = sum(values) if values else torch.zeros(
            state.coeffs.shape[0], device=state.coeffs.device)
        named = torch.stack([product] + values, dim=-1)
        return product, named


def build_evaluator(gpmm, target_ctx: TargetContext, specs, include_prior: bool = True,
                    model_boundary=None) -> EvaluatorProgram:
    """An ``EvaluatorProgram``; ``model_boundary`` defaults to the boundary
    of the model's cells."""
    if model_boundary is None:
        model_boundary = boundary_vertex_mask(gpmm.cells.cpu().numpy(), gpmm.num_points)
    return EvaluatorProgram(gpmm, target_ctx, specs, include_prior, model_boundary)


def proximity_and_independent(gpmm, target_ctx, mode="model_to_target",
                              sigma=1.0, n_points=100):
    """Reference ``ProductEvaluators.proximityAndIndependent`` (:38-55)."""
    return build_evaluator(
        gpmm, target_ctx,
        [IndependentPointsSpec(sigma=sigma, mode=mode, n_points=n_points)])


def proximity_and_hausdorff(gpmm, target_ctx, rate=1.0):
    """Reference ``ProductEvaluators.proximityAndHausdorff`` (:57-74)."""
    return build_evaluator(gpmm, target_ctx, [HausdorffSpec(rate=rate)])


def proximity_and_collective_hausdorff_boundary_aware(
        gpmm, target_ctx, mode="symmetric", sigma_avg=1.0, rate_max=0.2, mean=0.0,
        n_points=100):
    """Reference ``ProductEvaluators.proximityAndCollectiveHausdorffBoundaryAware``
    (:76-94); ``rate_max`` is the Exponential's rate, as breeze reads the
    reference's ``uncertaintyMax``."""
    return build_evaluator(
        gpmm, target_ctx,
        [CollectiveAvgMaxSpec(sigma_avg=sigma_avg, rate_max=rate_max, mean=mean,
                              mode=mode, n_points=n_points)])


def accept_all(gpmm, target_ctx):
    """Reference ``ProductEvaluators.acceptAll`` (:28-36): the constant term
    alone, no prior."""
    return build_evaluator(gpmm, target_ctx, [AcceptAllSpec()], include_prior=False)
