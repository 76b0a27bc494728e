"""Shortlist-index exactness sweep.

Counterpart of the repository's ``tools/validate_index.py``.  Holds
``ops/surface_index.index_closest`` (the coarse pass K3, or K8 with
``--coarse dot``, then the refine K4) against the dense kernel K5 on
queries from the regime random-init chains visit: model instances with
coefficients ~ N(0, s²·I) and perturbed poses, for shortlist widths K.
Writes the max absolute distance error and the mismatch fraction per
(K, regime):

    python3 -m icp_proposal_tpu_torch.tools.validate_index [--components 50]
        [--ks 16 32 64 128] [--coarse exact|dot] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from icp_proposal_tpu_torch.tools import add_common_args, femur_data, write_json

REGIMES = {
    "prior-s1.0": dict(coeff_scale=1.0, trans_mm=0.0, rot_rad=0.0),
    "prior-s2.5": dict(coeff_scale=2.5, trans_mm=0.0, rot_rad=0.0),
    "random-init": dict(coeff_scale=1.0, trans_mm=20.0, rot_rad=0.2),
    "far-init": dict(coeff_scale=2.0, trans_mm=50.0, rot_rad=0.5),
}


def perturbed_queries(data, generator: torch.Generator, coeff_scale, trans_mm, rot_rad,
                      n_states=8, stride=4) -> np.ndarray:
    """Sampled chain-like states, coeffs ~ N(0, s²I), pose ~ U(±trans, ±rot),
    drawn from ``generator`` (a CPU generator, so the card and the CPU get
    the same queries) → every ``stride``-th vertex of each state's mesh,
    [n_states · ⌈V / stride⌉, 3] float32."""
    from icp_proposal_tpu_torch.sampling.state import init_state, transformed_points

    model = data.model
    dev = model.device
    out = []
    for _ in range(n_states):
        coeffs = coeff_scale * torch.randn(model.rank, generator=generator)
        trans = trans_mm * (2.0 * torch.rand(3, generator=generator) - 1.0)
        rot = rot_rad * (2.0 * torch.rand(3, generator=generator) - 1.0)
        st = init_state(model, 1)._replace(coeffs=coeffs[None].to(dev),
                                           trans=trans[None].to(dev), rot=rot[None].to(dev))
        out.append(transformed_points(model, st)[0, ::stride].cpu().numpy())
    return np.concatenate(out, axis=0).astype(np.float32)


def run(data, ks=(16, 32, 64, 128), coarse: str = "exact", seed: int = 1024,
        verbose: bool = True) -> list:
    """The sweep on ``data``'s target, indices on the model's device → rows
    {k, regime, n_queries, max_abs_err_mm, max_rel_err, frac_mismatched}."""
    from icp_proposal_tpu_torch.ops.surface_index import build_surface_index, validate_index

    dev = data.model.device
    pts = np.asarray(data.target.points, np.float32)
    cells = np.asarray(data.target.cells)
    gen = torch.Generator().manual_seed(seed)
    queries = {name: perturbed_queries(data, gen, **kw) for name, kw in REGIMES.items()}
    rows = []
    for k in ks:
        index = build_surface_index(pts, cells, k=k, coarse=coarse, device=dev)
        for name, q in queries.items():
            max_err, max_rel, frac = validate_index(index, q, with_rel=True)
            rows.append({"k": k, "regime": name, "n_queries": int(q.shape[0]),
                         "max_abs_err_mm": max_err, "max_rel_err": max_rel,
                         "frac_mismatched": frac})
            if verbose:
                print(f"K={k:4d} {name:12s} n={q.shape[0]:5d} max_err={max_err:.2e} mm "
                      f"rel={max_rel:.2e} frac>{1e-4:.0e}={frac:.4f}", flush=True)
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, out="index_validation.json")
    ap.add_argument("--ks", type=int, nargs="+", default=[16, 32, 64, 128])
    ap.add_argument("--coarse", choices=["exact", "dot"], default="exact")
    ap.add_argument("--seed", type=int, default=1024)
    args = ap.parse_args(argv)

    data = femur_data(args.components, args.data_dir, args.device)
    rows = run(data, args.ks, args.coarse, args.seed)
    write_json(args.out, rows)
    print(f"[validate_index] wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
