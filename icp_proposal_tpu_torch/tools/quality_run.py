"""Quality evidence run: femur fitting at 10k samples, many chains.

Counterpart of the repository's ``tools/quality_run.py``.  Rows:

  * ``flagship`` — the reference recipe (0.9·ICP + 0.1·RW, exact density)
  * ``hybrid``   — 0.5·ICP + 0.4·MALA + 0.1·RW with scale adaptation
  * ``rw``       — random-walk-only, the exact baseline (the ESS yardstick)

Writes ``quality_femur.json`` beside ``--out``'s path: per row the MAP
surface error (avg, Hausdorff; K5), acceptance overall and by component,
the hold-trace ESS of the first 8 coefficients over the second half and
the ESS earned per wall-second (an untimed warm-up segment first: the first
launches build the kernels), the index check, the row with the most ESS
per wall-second as data (``recommended_by_ess_per_wall_second``; the
port's ``RECOMMENDED_SETUP`` is not changed by it), the flagship chain log
(``quality_femur_chain.json``) and its posterior maps (``posterior/``).
Rows of an earlier output at the same width are kept and updated:

    python3 -m icp_proposal_tpu_torch.tools.quality_run [--samples 10000]
        [--chains 16] [--rows flagship hybrid rw] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from icp_proposal_tpu_torch.tools import add_common_args, femur_data, write_json


def chain_state_traces(records):
    """The held chain-state traces.  ``ChainRecord.coeffs`` stores the
    post-step state directly (candidate on accept, held on reject) since
    round 4 — no reconstruction needed."""
    return np.asarray(records.coeffs), np.asarray(records.accepted)


def run_row(name, data, setup, n_samples, n_chains, json_path=None):
    """One row: a warm-up run of one segment (2,000 steps, seed 7), then the
    timed ``n_samples`` × ``n_chains`` run (seed 1024) → (row, result)."""
    from icp_proposal_tpu_torch.ops.metrics import avg_distance, hausdorff_distance
    from icp_proposal_tpu_torch.registration.sampling_registration import (
        SamplingRegistration,
    )
    from icp_proposal_tpu_torch.sampling.diagnostics import ess
    from icp_proposal_tpu_torch.sampling.state import transformed_mesh

    _, mixture, evaluator = setup(data)
    reg = SamplingRegistration(data.model, data.target, mixture, evaluator,
                               accept_info_interval=2000, verbose=True)
    warm = min(reg.accept_info_interval, n_samples)
    reg.runfitting(warm, seed=7, n_chains=n_chains)  # ends waiting for the device
    t0 = time.time()
    res = reg.runfitting(n_samples, n_chains=n_chains, json_path=json_path)
    elapsed = time.time() - t0

    best_mesh = transformed_mesh(data.model, res.best_state)
    avg = float(avg_distance(best_mesh, data.target))
    hd = float(hausdorff_distance(best_mesh, data.target))

    states, _ = chain_state_traces(res.records)
    post = states[:, n_samples // 2:, :]
    ess_first8 = ess(torch.as_tensor(post[:, :, :8]), max_lag=200).numpy()
    posterior_mean = post.reshape(-1, post.shape[-1]).mean(axis=0)
    posterior_sd = post.reshape(-1, post.shape[-1]).std(axis=0)

    row = {
        "samples": n_samples,
        "chains": n_chains,
        "elapsed_s": elapsed,
        "wall_excludes_compile": True,
        "samples_per_sec": n_samples * n_chains / elapsed,
        # the decision metric: mean hold-trace ESS per wall-second, the
        # kernels' build excluded
        "ess_per_wall_second": float(ess_first8.mean()) / elapsed,
        "map_avg_distance_mm": avg,
        "map_hausdorff_mm": hd,
        "best_log_product": res.best_log_value,
        "acceptance": res.acceptance,
        "ess_first8_mean": float(ess_first8.mean()),
        "ess_coeff0": float(ess_first8[0]),
        "posterior_mean_coeffs_norm": float(np.linalg.norm(posterior_mean)),
        "posterior_mean_coeffs_first8": posterior_mean[:8].tolist(),
        "posterior_sd_mean": float(posterior_sd.mean()),
    }
    print(f"[quality:{name}] MAP avg {avg:.3f} mm, ESS(8) "
          f"{row['ess_first8_mean']:.0f}, acc {res.acceptance['overall']:.3f}")
    return row, res


def index_check(data, ctx):
    """The shortlist index against the dense K5 on one prior-draw instance
    (every 4th vertex; draw from a CPU generator seeded 7) → the
    ``validate_index`` errors, or None without an index."""
    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.ops.surface_index import validate_index

    if ctx.index is None:
        return None
    coeffs = torch.randn(data.model.rank, generator=torch.Generator().manual_seed(7))
    pts = instance_points(data.model, coeffs.to(data.model.device))
    max_err, max_rel, frac = validate_index(ctx.index, pts[::4], with_rel=True)
    return {"max_abs_err_mm": max_err, "max_rel_err": max_rel, "frac_mismatched": frac}


def main(argv=None) -> dict:
    from icp_proposal_tpu_torch.analysis.replay import posterior_analysis
    from icp_proposal_tpu_torch.apps.femur import SETUPS
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, out="quality_femur.json")
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--rows", nargs="+", choices=sorted(SETUPS),
                    default=["flagship", "hybrid", "rw"])
    args = ap.parse_args(argv)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)

    data = femur_data(args.components, args.data_dir, args.device)
    check = index_check(data, build_target_context(data.target, data.target_boundary_mask,
                                                   device=data.model.device))
    print(f"[quality] index check: {check}")

    rows = {}
    flagship_res = None
    for name in args.rows:
        json_path = os.path.join(out_dir, "quality_femur_chain.json") if name == "flagship" \
            else None
        rows[name], res = run_row(name, data, SETUPS[name], args.samples, args.chains,
                                  json_path)
        if name == "flagship":
            flagship_res = res

    # merge into an earlier output at the same width, so rows measured in
    # separate invocations accumulate
    summary = {"components": args.components, "density": "exact (all rows; "
               "'parity' row if present uses the reference density)"}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        if prev.get("components") == args.components:
            summary["rows"] = prev.get("rows", {})
    summary.setdefault("rows", {})
    summary["rows"].update(rows)
    summary["index_check"] = check
    rows = summary["rows"]
    if "hybrid" in rows and "rw" in rows:
        summary["hybrid_ess_vs_rw"] = (
            rows["hybrid"]["ess_first8_mean"] / rows["rw"]["ess_first8_mean"])
    summary["recommended_by_ess_per_wall_second"] = max(
        rows, key=lambda k: rows[k]["ess_per_wall_second"])

    if flagship_res is not None:
        post = posterior_analysis(
            data.model, flagship_res.json_records, burn_in=min(200, args.samples // 5),
            take_every_n=50, out_dir=os.path.join(out_dir, "posterior"))
        summary["posterior_num_thinned"] = post["num_samples"]
        summary["variability_total_max"] = float(post["variability_total"].max())

    write_json(args.out, summary)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
