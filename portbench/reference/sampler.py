"""Plain reference of one Metropolis–Hastings step of the ICP-proposal
sampler, written from the method's equations.

    shape      x(α) = ref + μ + Qα,  Q = Φ·diag(√λ),  prior α ~ N(0, I)
    world      s · (R(x − c) + c + t)
    ICP        M = I + Σᵢ wᵢ QᵢᵀPᵢQᵢ,  α̂ = M⁻¹ Σᵢ wᵢ QᵢᵀPᵢ(yᵢ − μᵢ),
               P = I/σt² + (1/σn² − 1/σt²) nnᵀ,  α* = α̂ + L⁻ᵀz (M = LLᵀ),
               α' = α + ℓ(α* − α)
    density    q(α'|α) = N(α + (α' − α)/ℓ; α̂, M⁻¹) · ℓ⁻ʳ
    accept     log u < [log π(θ') − log π(θ)] + [log q(θ|θ') − log q(θ'|θ)]

It takes the cell's description (its mixture and evaluator) and host
arrays, never an object of the program.  A batch entry is one chain-step: its state before
the step, its noise and its adaptive scales.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import geometry as g

LOG_2PI = math.log(2 * math.pi)
MODEL_SEED = 1024  # the seeded vertex subsets of the reference method


def seeded_subset(n_total: int, n: int, seed: int) -> np.ndarray:
    n = min(n, n_total)
    return np.sort(np.random.RandomState(seed).choice(n_total, size=n, replace=False))


def _spread(x):
    x = x.astype(np.uint64) & 0x3FF
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                        (2, 0x09249249)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def morton_order(points: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """ids sorted by the Morton code (10 bits an axis) of their points."""
    pts = np.asarray(points, np.float64)[ids]
    lo = pts.min(0)
    q = np.clip((pts - lo) / np.maximum(pts.max(0) - lo, 1e-12) * 1023.0, 0, 1023)
    q = q.astype(np.uint64)
    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1)) | (
        _spread(q[:, 2]) << np.uint64(2))
    return np.asarray(ids)[np.argsort(code, kind="stable")]


@dataclass
class State:
    scale: torch.Tensor  # [N]
    rot: torch.Tensor  # [N, 3]
    trans: torch.Tensor  # [N, 3]
    center: torch.Tensor  # [N, 3]
    coeffs: torch.Tensor  # [N, r]

    def replace(self, **kw):
        return State(**{**self.__dict__, **kw})

    def where(self, mask, other):
        """Per entry, self where mask, else other."""
        def pick(a, b):
            return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)
        return State(**{k: pick(v, getattr(other, k)) for k, v in self.__dict__.items()})


class Reference:
    """The sampler of one cell, on ``device`` in ``dtype``.

    ``inputs``: host arrays ``ref_points``, ``cells``, ``mean``, ``basis``,
    ``variance``, ``target_points``, ``target_cells``.  ``cell``: the
    workload's ``mixture`` and ``evaluator`` lists and the configuration's
    ``index_k``."""

    def __init__(self, inputs: dict, cell: dict, device, dtype=torch.float64):
        self.dtype, self.device = dtype, device

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), device=device).to(dt)

        ref = np.asarray(inputs["ref_points"], np.float64)
        tgt = np.asarray(inputs["target_points"], np.float64)
        cells = np.asarray(inputs["cells"], np.int64)
        tcells = np.asarray(inputs["target_cells"], np.int64)
        basis = np.asarray(inputs["basis"], np.float64)
        var = np.asarray(inputs["variance"], np.float64)
        self.v, self.r = basis.shape[0], basis.shape[2]
        self.ref, self.mean = t(ref), t(inputs["mean"])
        self.q = t(basis * np.sqrt(var)[None, None, :])  # [V, 3, r]
        self.q_flat = self.q.reshape(3 * self.v, self.r)
        self.cells = t(cells, torch.long)
        self.model_boundary = t(g.boundary_mask(cells, len(ref)), torch.bool)
        self.tpoints, self.tcells = t(tgt), t(tcells, torch.long)
        self.target_boundary = t(g.boundary_mask(tcells, len(tgt)), torch.bool)
        self.shortlist = g.Shortlist(self.tpoints, self.tcells, int(cell["index_k"]))

        self.evaluator = dict(cell["evaluator"])
        n_eval = self.evaluator["n_points"]
        self.eval_model_ids = t(morton_order(ref, seeded_subset(len(ref), n_eval, 1024)),
                                torch.long)
        self.eval_target_ids = t(morton_order(tgt, seeded_subset(len(tgt), n_eval, 2048)),
                                 torch.long)
        self.components = [dict(c) for c in cell["mixture"]]
        weights = np.asarray([c["weight"] for c in self.components], np.float64)
        self.log_w = t(np.log(weights / weights.sum()))
        for c in self.components:
            if c["kind"] != "icp":
                continue
            n = c["n_points"]
            if c["model_ids"] == "evaluator_stride2":
                mids = self.eval_model_ids.cpu().numpy()[::2][:n]
            else:
                mids = morton_order(ref, seeded_subset(len(ref), n, MODEL_SEED))
            c["model_ids_t"] = t(mids, torch.long)
            c["target_ids_t"] = t(morton_order(
                tgt, seeded_subset(len(tgt), n, MODEL_SEED + 1)), torch.long)
        self.adapt = cell.get("adapt")
        self.tied = None  # [N] during step(): entries with a lookup tied at rounding
        self.last_tied = None
        self.alternate = False  # tied lookups take the second nearest vertex

    def _tied(self, tied):
        if self.tied is not None:
            self.tied |= tied.reshape(tied.shape[0], -1).any(-1)

    # ------------------------------------------------------------ model
    def points(self, s: State):
        shape = self.ref + self.mean + (s.coeffs @ self.q_flat.T).reshape(-1, self.v, 3)
        return g.world_points(shape, s.scale, s.rot, s.trans, s.center)

    def log_posterior(self, s: State, pts=None):
        """log prior + log likelihood [N]."""
        pts = self.points(s) if pts is None else pts
        prior = -0.5 * (s.coeffs ** 2).sum(-1) - 0.5 * self.r * LOG_2PI
        ev = self.evaluator
        if ev["kind"] == "independent":
            # the winning faces are found without gradient; the distance to
            # the winner is recomputed from the live points
            q = pts[:, self.eval_model_ids]
            with torch.no_grad():
                _, _, face, tied = self.shortlist.closest(q.detach(), self.alternate)
                self._tied(tied)
            t = self.shortlist.tri[face]
            _, d2 = g.closest_on_triangle(q, t[..., 0, :], t[..., 1, :], t[..., 2, :])
            d = torch.sqrt(d2)
            like = (-0.5 * (d / ev["sigma"]) ** 2 - math.log(ev["sigma"])
                    - 0.5 * LOG_2PI).sum(-1)
        elif ev["kind"] == "collective":
            like = self._collective(pts)
        else:
            raise ValueError(f"unknown evaluator {ev['kind']}")
        return prior + like

    def _collective(self, pts):
        """Boundary-aware average and maximum distance, both directions:
        Gaussian(avg; mean, σ_avg) + Exponential(max; rate)."""
        ev = self.evaluator

        def avg_max(cp, d2, face, cells, surf, boundary):
            keep = ~boundary[g.nearest_corner(cells, face, cp, surf)]
            d = torch.sqrt(d2)
            avg = torch.where(keep, d, 0).sum(-1) / keep.sum(-1).clamp_min(1)
            mx = torch.where(keep, d, -math.inf).amax(-1)
            return avg, mx

        cp, d2, face = g.closest_over_faces(pts[:, self.eval_model_ids],
                                            self.tpoints[self.tcells])
        a1, m1 = avg_max(cp, d2, face, self.tcells, self.tpoints, self.target_boundary)
        tq = self.tpoints[self.eval_target_ids].expand(pts.shape[0], -1, -1)
        cp, d2, face = g.closest_over_faces(tq, pts[:, self.cells])
        a2, m2 = avg_max(cp, d2, face, self.cells, pts, self.model_boundary)
        avg, mx = 0.5 * a1 + 0.5 * a2, torch.maximum(m1, m2)
        z = (avg - ev["mean"]) / ev["sigma_avg"]
        return (-0.5 * z * z - math.log(ev["sigma_avg"]) - 0.5 * LOG_2PI
                + math.log(ev["rate_max"]) - ev["rate_max"] * mx)

    # ------------------------------------------------------------ anchors
    def icp_factors(self, c: dict, s: State, pts, normals):
        """(α̂ [N, r], L [N, r, r], log det M [N]) of component c at s."""
        n = s.coeffs.shape[0]
        if c["direction"] == "model":
            ids = c["model_ids_t"].expand(n, -1)
            cp, _, face, tied = self.shortlist.closest(pts[:, c["model_ids_t"]],
                                                       self.alternate)
            self._tied(tied)
            near = g.nearest_corner(self.tcells, face, cp, self.tpoints)
            w = (~self.target_boundary[near]).to(self.dtype)
            obs = g.model_frame(cp, s.scale, s.rot, s.trans, s.center) - self.ref[ids]
        else:
            tq = self.tpoints[c["target_ids_t"]].expand(n, -1, -1)
            ids, other, tied = g.nearest_vertex(tq, pts, second=True)
            ids = torch.where(tied, other, ids) if self.alternate else ids
            self._tied(tied)
            w = (~self.model_boundary[ids]).to(self.dtype)
            obs = g.model_frame(tq, s.scale, s.rot, s.trans, s.center) - self.ref[ids]
        nrm = torch.gather(normals, 1, ids[..., None].expand(-1, -1, 3))
        q = self.q[ids]  # [N, m, 3, r]
        a = 1 / c["normal"] ** 2
        b = 1 / c["tangential"] ** 2
        nq = torch.einsum("nmi,nmir->nmr", nrm, q)
        pq = (b * q + (a - b) * nrm[..., None] * nq[:, :, None, :]) * w[..., None, None]
        m = torch.eye(self.r, dtype=self.dtype, device=self.device) + torch.einsum(
            "nmir,nmis->nrs", q, pq)
        rhs = torch.einsum("nmir,nmi->nr", pq, obs - self.mean[ids])
        chol, info = torch.linalg.cholesky_ex(m)
        alpha_hat = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
        logdet = 2 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        bad = info != 0
        return (torch.where(bad[:, None], math.nan, alpha_hat),
                torch.where(bad[:, None, None], math.nan, chol),
                torch.where(bad, math.nan, logdet))

    def gradient(self, s: State):
        """∇_α log π at s, non-finite entries set to 0."""
        with torch.enable_grad():
            a = s.coeffs.detach().clone().requires_grad_(True)
            lp = self.log_posterior(s.replace(coeffs=a))
            (grad,) = torch.autograd.grad(lp.sum(), a)
        return torch.where(torch.isfinite(grad), grad, 0)

    def anchors(self, s: State, pts=None):
        """Per anchored component (ICP, MALA), its anchor at s."""
        pts = self.points(s) if pts is None else pts
        normals = None
        out = {}
        for i, c in enumerate(self.components):
            if c["kind"] == "icp":
                if normals is None:
                    normals = g.vertex_normals(pts, self.cells)
                out[i] = self.icp_factors(c, s, pts, normals)
            elif c["kind"] == "mala":
                out[i] = self.gradient(s)
        return out

    # ------------------------------------------------------------ proposals
    def _sigma(self, i, c, scales):
        sigma = c["sigma"]
        return sigma if scales is None else sigma * scales[:, i]

    def propose(self, s: State, anchors, z, idx, scales):
        """The candidate of component idx[n] from noise z [N, C, r]."""
        cands = []
        for i, c in enumerate(self.components):
            kind = c["kind"]
            if kind == "icp":
                alpha_hat, chol, _ = anchors[i]
                star = alpha_hat + torch.linalg.solve_triangular(
                    chol.transpose(-1, -2), z[:, i, :, None], upper=True)[..., 0]
                cands.append(s.replace(coeffs=s.coeffs + (star - s.coeffs) * c["step"]))
            elif kind == "mala":
                h = _col(self._sigma(i, c, scales))
                cands.append(s.replace(coeffs=s.coeffs + 0.5 * h * h * anchors[i]
                                       + h * z[:, i]))
            elif kind == "shape":
                cands.append(s.replace(coeffs=s.coeffs
                                       + _col(self._sigma(i, c, scales)) * z[:, i]))
            else:
                field = "rot" if kind == "rotation" else "trans"
                moved = getattr(s, field).clone()
                moved[:, c["axis"]] = moved[:, c["axis"]] + (
                    self._sigma(i, c, scales) * z[:, i, 0])
                cands.append(s.replace(**{field: moved}))
        out = cands[0]
        for i in range(1, len(cands)):
            out = cands[i].where(idx == i, out)
        return out

    def log_q(self, frm: State, to: State, anchors, scales):
        """log Σ_c w_c q_c(to | frm) [N]."""
        same_pose = ((frm.scale == to.scale) & (frm.rot == to.rot).all(-1)
                     & (frm.trans == to.trans).all(-1) & (frm.center == to.center).all(-1))
        terms = []
        for i, c in enumerate(self.components):
            kind = c["kind"]
            if kind == "icp":
                alpha_hat, chol, logdet = anchors[i]
                comp = frm.coeffs + (to.coeffs - frm.coeffs) / c["step"]
                lt = torch.einsum("nji,nj->ni", chol, comp - alpha_hat)
                lq = (-0.5 * (lt * lt).sum(-1) - 0.5 * self.r * LOG_2PI + 0.5 * logdet
                      - self.r * math.log(c["step"]))
                lq = torch.where(same_pose, lq, -math.inf)
            elif kind in ("mala", "shape"):
                sigma = self._sigma(i, c, scales)
                mean = frm.coeffs
                if kind == "mala":
                    mean = mean + 0.5 * _col(sigma) ** 2 * anchors[i]
                lq = _gauss(to.coeffs - mean, sigma)
                lq = torch.where(same_pose, lq, -math.inf)
            else:
                field = "rot" if kind == "rotation" else "trans"
                ax = c["axis"]
                sigma = self._sigma(i, c, scales)
                delta = getattr(to, field)[:, ax] - getattr(frm, field)[:, ax]
                lq = -0.5 * (delta / sigma) ** 2 - _log(sigma) - 0.5 * LOG_2PI
                keep = torch.arange(3, device=self.device) != ax
                others = {k: (getattr(frm, k) == getattr(to, k)).all(-1)
                          for k in ("rot", "trans", "center", "coeffs")}
                others[field] = ((getattr(frm, field) == getattr(to, field)) | ~keep).all(-1)
                same = (frm.scale == to.scale) & others["rot"] & others["trans"] \
                    & others["center"] & others["coeffs"]
                lq = torch.where(same, lq, -math.inf)
            terms.append(self.log_w[i] + lq)
        return torch.logsumexp(torch.stack(terms), dim=0)

    def update_log_scales(self, log_s, k: int, idx, log_alpha):
        """One Robbins–Monro step of the log-scales [N, C] after step k:
        the picked component's log-scale moves by (1 + k)^−decay · (min(1,
        e^{log α}) − target), toward 0.574 for MALA and the configured
        target otherwise; ICP is not adapted."""
        cfg = self.adapt
        adaptable = torch.tensor([c["kind"] != "icp" for c in self.components],
                                 dtype=log_s.dtype, device=log_s.device)
        target = torch.tensor([0.574 if c["kind"] == "mala" else cfg["target"]
                               for c in self.components], dtype=log_s.dtype,
                              device=log_s.device)
        prob = torch.exp(torch.clamp_max(log_alpha.to(log_s.dtype), 0)).clamp_max(1)
        gamma = cfg["rate"] / (1.0 + k) ** cfg["decay"]
        onehot = torch.nn.functional.one_hot(idx.long(), len(self.components))
        return log_s + gamma * onehot.to(log_s.dtype) * adaptable * (prob[:, None] - target)

    def scales_after(self, idx_hist, log_alpha_hist):
        """The adaptive scale factors before each step [T, N, C] from the
        components picked [T, N] and the log α [T, N] of the steps before;
        None without adaptation."""
        if not self.adapt:
            return None
        steps, n = idx_hist.shape
        log_s = torch.zeros((n, len(self.components)), dtype=self.dtype, device=self.device)
        out = torch.empty((steps,) + log_s.shape, dtype=self.dtype, device=self.device)
        for k in range(steps):
            out[k] = torch.exp(log_s)
            log_s = self.update_log_scales(log_s, k, idx_hist[k], log_alpha_hist[k])
        return out

    # ------------------------------------------------------------ one step
    def step(self, s: State, z, idx, log_u, scales=None):
        """→ (candidate, log π(candidate), log α, accept) for entries at s;
        ``last_tied`` then marks the entries one of whose nearest-vertex
        lookups (the index's coarse step, the target-direction ICP's
        correspondences) tied at rounding: ``alternate`` = True recomputes
        them with the other answer."""
        self.tied = torch.zeros(s.coeffs.shape[0], dtype=torch.bool, device=self.device)
        z = z.to(self.dtype)
        pts = self.points(s)
        anchors = self.anchors(s, pts)
        cand = self.propose(s, anchors, z, idx, scales)
        cand_pts = self.points(cand)
        lp_cur = self.log_posterior(s, pts)
        lp_cand = self.log_posterior(cand, cand_pts)
        anchors_cand = self.anchors(cand, cand_pts)
        log_alpha = (lp_cand - lp_cur) + (self.log_q(cand, s, anchors_cand, scales)
                                          - self.log_q(s, cand, anchors, scales))
        log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
        self.last_tied, self.tied = self.tied, None
        return cand, lp_cand, log_alpha, log_u.to(self.dtype) < log_alpha


def _col(x):
    return x[:, None] if isinstance(x, torch.Tensor) else x


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _gauss(delta, sigma):
    n = delta.shape[-1]
    return (-0.5 * ((delta / _col(sigma)) ** 2).sum(-1) - n * _log(sigma)
            - 0.5 * n * LOG_2PI)
