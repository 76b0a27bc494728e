"""CLI: build GPMMs from analytic kernels (offline model construction).

Counterpart of ``icp_proposal_tpu/apps/create_gp_model.py`` (reference
``apps/femur/CreateGPModel.scala``: the 50/100/200-component femur models
from the anisotropic multi-scale Gaussian kernel; ``apps/bfm/CreateGPModel.scala``:
FaceKernel and Nyström on a decimated reference).  The basis is computed in
float64 on the host; the model passes through ``--device`` (the card unless
``--device cpu``) on its way to the statismo file.

    python -m icp_proposal_tpu_torch.apps.create_gp_model femur \\
        --reference femur_reference.stl --components 50 100 200 --out-dir ./models
    python -m icp_proposal_tpu_torch.apps.create_gp_model face \\
        --reference ref.stl --components 200 --out models/faceGPmodel_200c.h5
"""
from __future__ import annotations

import argparse
import os

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("femur")
    pf.add_argument("--reference", required=True)
    pf.add_argument("--components", type=int, nargs="+", default=[50, 100, 200])
    pf.add_argument("--out-dir", default=".")

    pb = sub.add_parser("face")
    pb.add_argument("--reference", required=True)
    pb.add_argument("--components", type=int, default=200)
    pb.add_argument("--decimate-to", type=int, default=2000)
    pb.add_argument("--sample-points", type=int, default=800)
    pb.add_argument("--out", required=True)

    for sp in (pf, pb):
        sp.add_argument("--device", default=DEFAULT_DEVICE,
                        help="'cuda' (the card) or 'cpu'")
    args = p.parse_args(argv)

    from icp_proposal_tpu_torch.io.statismo import write_statismo_gpmm
    from icp_proposal_tpu_torch.io.stl import read_stl

    points, cells = read_stl(args.reference)
    print(f"reference: {len(points)} vertices / {len(cells)} faces")

    if args.cmd == "femur":
        from icp_proposal_tpu_torch.models.build_femur import (
            build_femur_gpmm,
            femur_kernel,
            variance_capture_ratio,
        )

        os.makedirs(args.out_dir, exist_ok=True)
        for i in args.components:
            model = build_femur_gpmm(points, cells, num_components=i, device=args.device)
            ratio = variance_capture_ratio(femur_kernel(points), points,
                                           model.variance.cpu().numpy())
            out = os.path.join(args.out_dir, f"femur_gp_model_{i}-components.h5")
            write_statismo_gpmm(out, model)
            print(f"wrote {out}: rank {model.rank}, variance-capture ratio {ratio:.3f}")
    else:
        from icp_proposal_tpu_torch.models.build_face import build_face_gpmm

        model = build_face_gpmm(
            points, cells,
            num_components=args.components,
            num_sample_points=args.sample_points,
            decimate_to=args.decimate_to,
            device=args.device,
        )
        write_statismo_gpmm(args.out, model)
        print(f"wrote {args.out}: {model.num_points} vertices, rank {model.rank}")


if __name__ == "__main__":
    main()
