"""BFM quality evidence: 10k-sample synthetic-face fitting runs.

Counterpart of the repository's ``tools/quality_bfm.py``.  Rows:

  * ``complete`` — full-scan fitting (reference ``BfmFittingComplete.scala:76``:
    0.4·pose + 0.55·ICP + 0.05·RW; Euclidean σ = 3.0)
  * ``partial``  — occluded-scan fitting (reference
    ``BfmFittingPartial.scala:74-80``: collective avg/max boundary-aware
    evaluator, symmetric)

on the synthetic face stand-in (``apps/bfm.load_synthetic_face_data``; the
real BFM assets are license-gated).  Writes per row the MAP surface error
against the COMPLETE target (the partial row's point is the occluded
region), acceptance and the hold-trace ESS, after an untimed warm-up
segment:

    python3 -m icp_proposal_tpu_torch.tools.quality_bfm [--rank 24]
        [--samples 10000] [--chains 16] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE
from icp_proposal_tpu_torch.tools import EVIDENCE_DIR, write_json


def main(argv=None) -> dict:
    from icp_proposal_tpu_torch.apps.bfm import load_synthetic_face_data, make_bfm_fitting_setup
    from icp_proposal_tpu_torch.ops.metrics import avg_distance, hausdorff_distance
    from icp_proposal_tpu_torch.registration.sampling_registration import (
        SamplingRegistration,
    )
    from icp_proposal_tpu_torch.sampling.diagnostics import ess
    from icp_proposal_tpu_torch.sampling.state import transformed_mesh

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--rank", type=int, default=24)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (the card) or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--out", default=str(EVIDENCE_DIR / "quality_bfm.json"))
    args = ap.parse_args(argv)
    n_samples, n_chains, rank = args.samples, args.chains, args.rank

    data = load_synthetic_face_data(rank=rank, device=args.device)
    rows = {}
    for name, partial in (("complete", False), ("partial", True)):
        target = data.target_partial if partial else data.target
        _, mixture, evaluator = make_bfm_fitting_setup(data, partial)
        reg = SamplingRegistration(data.model, target, mixture, evaluator, verbose=True)
        warm = min(reg.accept_info_interval, n_samples)
        reg.runfitting(warm, seed=7, n_chains=n_chains)  # ends waiting for the device
        t0 = time.time()
        res = reg.runfitting(n_samples, seed=1024, n_chains=n_chains)
        elapsed = time.time() - t0

        # the MAP error is judged against the complete ground-truth target
        best_mesh = transformed_mesh(data.model, res.best_state)
        avg = float(avg_distance(best_mesh, data.target))
        hd = float(hausdorff_distance(best_mesh, data.target))

        post = res.records.coeffs[:, n_samples // 2:, :]  # post-step chain state
        ess_first8 = ess(torch.as_tensor(post[:, :, :min(8, rank)]), max_lag=200).numpy()
        rows[name] = {
            "samples": n_samples,
            "chains": n_chains,
            "rank": rank,
            "elapsed_s": elapsed,
            "wall_excludes_compile": True,
            "samples_per_sec": n_samples * n_chains / elapsed,
            "map_avg_distance_vs_full_target": avg,
            "map_hausdorff_vs_full_target": hd,
            "best_log_product": res.best_log_value,
            "acceptance": res.acceptance,
            "ess_first8_mean": float(ess_first8.mean()),
            "ess_coeff0": float(ess_first8[0]),
        }
        print(f"[quality_bfm:{name}] MAP avg {avg:.4f}, ESS(8) "
              f"{rows[name]['ess_first8_mean']:.0f}, acc {res.acceptance['overall']:.3f}")

    summary = {
        "workload": "synthetic face stand-in (real BFM assets license-gated)",
        "density": "exact evaluators; ICP proposal framework default",
        "rows": rows,
    }
    write_json(args.out, summary)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
