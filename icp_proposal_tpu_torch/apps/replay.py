"""CLI: replay a chain log and produce posterior-variability artifacts.

Counterpart of ``icp_proposal_tpu/apps/replay.py``: headless equivalents of
the reference's ``ReplayFittingFromLog`` and
``PosteriorVariabilityToMeshColor`` apps.  The femur model comes from
``load_femur_data(components, data_dir=--data-dir)`` (default the
reference's relative ``data/femur``) on ``--device`` (the card unless
``--device cpu``).

    python -m icp_proposal_tpu_torch.apps.replay replay chain.json --components 50 \\
        --stride 10 --out-dir replay_out --data-dir DIR
    python -m icp_proposal_tpu_torch.apps.replay posterior chain.json --components 50 \\
        --burn-in 200 --take-every 50 --out-dir posterior_out --data-dir DIR
"""
from __future__ import annotations

import argparse
import os

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("replay", help="export mesh snapshots along the chain")
    pr.add_argument("log")
    pr.add_argument("--components", type=int, default=50)
    pr.add_argument("--stride", type=int, default=10)
    pr.add_argument("--out-dir", default="replay_out")
    pr.add_argument("--max-snapshots", type=int, default=50)

    pp = sub.add_parser("posterior", help="posterior-variability maps from a log")
    pp.add_argument("log")
    pp.add_argument("--components", type=int, default=50)
    pp.add_argument("--burn-in", type=int, default=200)
    pp.add_argument("--take-every", type=int, default=50)
    pp.add_argument("--out-dir", default="posterior_out")

    for sp in (pr, pp):
        sp.add_argument("--data-dir", default=None,
                        help="directory of the femur assets (statismo model, landmarks, "
                             "femur_target.stl); default data/femur")
        sp.add_argument("--device", default=DEFAULT_DEVICE,
                        help="'cuda' (the card) or 'cpu'")
    args = p.parse_args(argv)

    from icp_proposal_tpu_torch.apps.femur import load_femur_data
    from icp_proposal_tpu_torch.sampling import loggers

    data = load_femur_data(args.components, data_dir=args.data_dir, device=args.device)
    records = loggers.load_log(args.log)

    if args.cmd == "replay":
        from icp_proposal_tpu_torch.analysis.replay import replay_meshes
        from icp_proposal_tpu_torch.io.stl import write_stl

        meshes = replay_meshes(data.model, records, stride=args.stride)
        os.makedirs(args.out_dir, exist_ok=True)
        cells = data.model.cells.cpu().numpy()
        for i, pts in enumerate(meshes[: args.max_snapshots]):
            write_stl(os.path.join(args.out_dir, f"replay_{i:05d}.stl"), pts, cells)
        print(f"wrote {min(len(meshes), args.max_snapshots)} snapshots to {args.out_dir}")
    else:
        from icp_proposal_tpu_torch.analysis.replay import posterior_analysis

        out = posterior_analysis(data.model, records, burn_in=args.burn_in,
                                 take_every_n=args.take_every, out_dir=args.out_dir)
        print(f"posterior analysis over {out['num_samples']} samples; artifacts in "
              f"{args.out_dir}; max total-variability "
              f"{float(out['variability_total'].max()):.4f}")


if __name__ == "__main__":
    main()
