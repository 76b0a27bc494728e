"""Judge the chain-steps the timed window ran against the reference.

The window keeps, for a sample of chains drawn from the seed, every step's
record (the program's post-step state, log α, decision and candidate log
posterior).  For a sample of those chain-steps the reference starts from
the program's state before the step (the post-step state of the step
before, or the initial state), takes the same noise and the adaptive
scales that follow from the program's log α of the steps before, and
recomputes the step in float64.  Where one of the step's nearest-vertex
lookups ties at the program's rounding (the two nearest within
``geometry.TIE``), either vertex is a right answer, and the answers after
it differ whole (a shortlist, a correspondence): the reference computes
the step both ways and judges the program against the way nearer to it.
Three numbers are compared, each with the cell's limit:

* ``lp_gap_p90``: the 90th percentile of the |log π(candidate)| gaps;
* ``log_alpha_gap_p90``: the 90th percentile of the log α gaps;
* ``bad_step_share``: the share of chain-steps with a gap in log π or in
  log α above the cell's ``gap_tol``, or whose accept decision differs from
  the reference's where log u lies farther than ``tie_margin`` from the
  reference's log α, or whose post-step state differs from the reference's
  candidate (accepted) or from the state before (rejected) by more than
  ``state_tol`` relative to 1 + |value|.

The first two follow the arithmetic of every chain-step; the third the
rare chain-step that goes wrong whole (a decision, a state).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.sampler import State

NUMBERS = ("lp_gap_p90", "log_alpha_gap_p90", "bad_step_share")


def _gap(a, b):
    """|a − b| with equal infinities 0 and a NaN on either side infinite."""
    same = (a == b)
    gap = torch.abs(a - b)
    gap = torch.where(same, torch.zeros_like(gap), gap)
    return torch.where(torch.isnan(gap), torch.full_like(gap, math.inf), gap)


def pre_states(init: State, hist: dict, t, j) -> State:
    """The state before step t of sampled chain j (int64 tensors)."""
    prev = (t - 1).clamp_min(0)
    first = (t == 0)

    def pick(field, rec):
        return torch.where(first.reshape(-1, *([1] * (rec.dim() - 2))),
                           getattr(init, field)[j], rec[prev, j])

    pose = hist["pose"]
    return State(scale=init.scale[j],
                 trans=pick("trans", pose[..., 0:3]),
                 rot=pick("rot", pose[..., 3:6]),
                 center=pick("center", pose[..., 6:9]),
                 coeffs=pick("coeffs", hist["coeffs"]))


def judge(ref, init: State, hist: dict, noise: dict, pairs, check: dict,
          batch: int) -> dict:
    """→ {number: value} and diagnostics, for the chain-steps ``pairs`` =
    (t [P], j [P]) of the sampled chains.  ``hist`` holds [T, n, ...]
    tensors of the sampled chains, ``noise`` their z [T, n, C, r], idx
    [T, n], log_u [T, n]; ``init`` their initial state."""
    dt = ref.dtype
    hist = {k: v.to(ref.device) for k, v in hist.items()}
    noise = {k: v.to(ref.device) for k, v in noise.items()}
    init = State(**{k: v.to(ref.device, dt) for k, v in init.__dict__.items()})
    hist_f = {k: (v.to(dt) if v.is_floating_point() else v) for k, v in hist.items()}
    scales = ref.scales_after(noise["idx"], hist_f["log_alpha"])
    t_all, j_all = (torch.as_tensor(x, device=ref.device) for x in pairs)
    out = {k: [] for k in ("lp", "la", "mismatch", "state", "acc", "idx", "tied")}
    out["alternate"] = []
    for lo in range(0, len(t_all), batch):
        t, j = t_all[lo:lo + batch], j_all[lo:lo + batch]
        pre = pre_states(init, hist_f, t, j)
        sc = None if scales is None else scales[t, j]
        args = (noise["z"][t, j], noise["idx"][t, j], noise["log_u"][t, j])
        cand, lp, la, acc = ref.step(pre, *args, sc)
        acc_prog = hist["accepted"][t, j]
        tied = ref.last_tied
        if tied.any():  # each tied lookup's other answer, where nearer the program
            sub = State(**{k: v[tied] for k, v in pre.__dict__.items()})
            ref.alternate = True
            try:
                alt = ref.step(sub, *(x[tied] for x in args), None if sc is None else sc[tied])
            finally:
                ref.alternate = False

            def miss(lp_, la_):
                return (_gap(hist_f["log_product"][t, j][tied], lp_)
                        + _gap(hist_f["log_alpha"][t, j][tied], la_))
            near = torch.zeros_like(tied)
            near[tied] = miss(alt[1], alt[2]) < miss(lp[tied], la[tied])
            ids = near[tied]
            rows = tied.nonzero()[:, 0][ids]
            cand = State(**{k: v.clone() for k, v in cand.__dict__.items()})
            for k, v in alt[0].__dict__.items():
                getattr(cand, k)[rows] = v[ids]
            lp, la, acc = lp.clone(), la.clone(), acc.clone()
            lp[rows], la[rows], acc[rows] = alt[1][ids], alt[2][ids], alt[3][ids]
            out["alternate"].append(near)
        out["tied"].append(tied)
        out["lp"].append(_gap(hist_f["log_product"][t, j], lp))
        out["la"].append(_gap(hist_f["log_alpha"][t, j], la))
        tie = torch.abs(noise["log_u"][t, j].to(dt) - la) <= check["tie_margin"]
        out["mismatch"].append((acc_prog != acc) & ~tie)
        expect = cand.where(acc_prog, pre)
        post = State(scale=pre.scale, trans=hist_f["pose"][t, j, 0:3],
                     rot=hist_f["pose"][t, j, 3:6], center=hist_f["pose"][t, j, 6:9],
                     coeffs=hist_f["coeffs"][t, j])
        gaps = [torch.amax(_gap(getattr(post, f), getattr(expect, f))
                           / (1 + torch.abs(getattr(expect, f))), dim=-1)
                for f in ("coeffs", "rot", "trans")]
        out["state"].append(torch.stack(gaps).amax(0))
        out["acc"].append(acc_prog)
        out["idx"].append(noise["idx"][t, j])
    alternate = sum(int(a.sum()) for a in out.pop("alternate"))
    cat = {k: torch.cat(v).double().cpu().numpy() for k, v in out.items()}
    worst = int(np.argmax(np.maximum(cat["lp"], cat["la"])))
    t_w, j_w = int(t_all[worst]), int(j_all[worst])
    state_bad = cat["state"] > check["state_tol"]
    bad = ((cat["lp"] > check["gap_tol"]) | (cat["la"] > check["gap_tol"])
           | (cat["mismatch"] > 0) | state_bad)
    return {
        "lp_gap_p90": float(np.quantile(cat["lp"], 0.9)),
        "log_alpha_gap_p90": float(np.quantile(cat["la"], 0.9)),
        "bad_step_share": float(bad.mean()),
        "diag": {
            "pairs": int(len(cat["lp"])),
            "tied_share": float(cat["tied"].mean()),
            "judged_the_other_way": alternate,
            "accepted_share": float(cat["acc"].mean()),
            "accepted_by_component": {
                c["name"]: [int(cat["acc"][cat["idx"] == i].sum()), int((cat["idx"] == i).sum())]
                for i, c in enumerate(ref.components)},
            "decision_mismatch_share": float(cat["mismatch"].mean()),
            "state_mismatch_share": float(state_bad.mean()),
            "lp_gap_p50": float(np.quantile(cat["lp"], 0.5)),
            "lp_gap_p99": float(np.quantile(cat["lp"], 0.99)),
            "log_alpha_gap_p50": float(np.quantile(cat["la"], 0.5)),
            "log_alpha_gap_p99": float(np.quantile(cat["la"], 0.99)),
            "state_gap_p99": float(np.quantile(cat["state"], 0.99)),
            "state_gap_max": float(cat["state"].max()),
            "worst": {"step": t_w, "chain": j_w,
                      "component": ref.components[int(noise["idx"][t_w, j_w])]["name"],
                      "accepted": bool(cat["acc"][worst]), "lp_gap": float(cat["lp"][worst]),
                      "log_alpha_gap": float(cat["la"][worst])},
        },
    }


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over ``NUMBERS``."""
    rows = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS}
    ok = all(np.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows.values())
    return ok, rows
