"""Mixing of the ICP-proposal mixture on the femur, over its settings.

Counterpart of the repository's ``tools/mixing_sweep.py``.  Sweeps
(parity, step length, noise scales, MALA share, adaptation) on the femur
GPMM ICP-proposal mixture and reports, per configuration: per-component
and overall acceptance, ESS of the held coefficient traces over the second
half, and the mean surface distance (K5) of the final states.  The
random-walk chain is the yardstick (reference
``NonRigidIcpProposal.scala:53-85`` with the configuration of
``IcpProposalRegistration.scala:59-87``):

    python3 -m icp_proposal_tpu_torch.tools.mixing_sweep [--components 50]
        [--chains 64] [--steps 2000] [--quick] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from icp_proposal_tpu_torch.tools import (
    add_common_args,
    femur_data,
    surface_avg_dist,
    warm_up,
    write_json,
)

# the flagship recipe's ICP settings (reference IcpProposalRegistration.scala:59-87)
FLAGSHIP = dict(parity=False, step_length=0.1, noise_normal=5.0, tangential=10.0)


def grid(quick: bool = False) -> list:
    """The sweep's configurations, (label, ``_setup`` keywords), in the JAX
    tool's order; ``quick``: the first three."""
    rows = [
        ("rw-only", dict(FLAGSHIP, icp_weight=0.0)),  # the random-walk yardstick
        ("flagship-exact-s0.1", dict(FLAGSHIP)),
        ("flagship-parity-s0.1", dict(FLAGSHIP, parity=True)),
    ]
    if quick:
        return rows
    rows += [(f"exact-s{s}", dict(FLAGSHIP, step_length=s)) for s in (0.3, 0.5, 1.0)]
    # tighter proposal noise (a posterior closer to the likelihood's σ = 2)
    rows += [(f"exact-s0.5-n{nn}-t{tg}", dict(FLAGSHIP, step_length=0.5, noise_normal=nn,
                                              tangential=tg))
             for nn, tg in ((2.0, 4.0), (1.0, 2.0))]
    rows.append(("exact-s1.0-n2-t4", dict(FLAGSHIP, step_length=1.0, noise_normal=2.0,
                                          tangential=4.0)))
    # gradient-informed: MALA alone, MALA + random walk, ICP + MALA, scales
    # adapted (MALA toward acceptance 0.574)
    mala = dict(FLAGSHIP, icp_weight=0.0, mala_h=0.1, adapt=True)
    rows += [("mala-adapt", dict(mala, mala_weight=1.0)),
             ("mala0.5+rw-adapt", dict(mala, mala_weight=0.5)),
             ("icp0.5+mala0.4-adapt", dict(mala, icp_weight=0.5, mala_weight=0.4))]
    return rows


def _setup(data, parity, step_length, noise_normal, tangential, rw_sigma=0.1,
           icp_weight=0.9, mala_weight=0.0, mala_h=0.2, adapt=False, build_index=True):
    """(ctx, mixture, evaluator) of one configuration on the model's device:
    ``icp_weight``·ICP (both directions, 2·rank points, the reference's
    seeded subsets) + ``mala_weight``·MALA + the rest random walk; the
    Euclidean model→target evaluator of σ = 2 over 4·rank points.
    ``build_index=False``: every closest-point query takes the dense K5 (the
    JAX package's ``ICP_TPU_NO_SHORTLIST=1``)."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu_torch.sampling.proposals import (
        AdaptConfig,
        MixtureProgram,
        gradient_shape_proposal,
        mixed_proposal_icp,
        mixed_random_shape_proposal,
        nest,
    )

    model = data.model
    ctx = build_target_context(data.target, data.target_boundary_mask,
                               build_index=build_index, device=model.device)
    groups = []
    if icp_weight > 0:
        groups.append((icp_weight, mixed_proposal_icp(
            n_points=2 * model.rank,
            projection_direction="model_and_target",
            tangential_noise=tangential,
            noise_along_normal=noise_normal,
            step_length=step_length,
        )))
    if mala_weight > 0:
        groups.append((mala_weight, gradient_shape_proposal((mala_h,))))
    rw_weight = 1.0 - icp_weight - mala_weight
    if rw_weight > 0:
        groups.append((rw_weight, mixed_random_shape_proposal((rw_sigma,))))
    weighted = nest(*groups) if len(groups) > 1 else groups[0][1]
    mixture = MixtureProgram(weighted, model, ctx, np.asarray(data.model_boundary_mask),
                             parity=parity, adapt=AdaptConfig() if adapt else None)
    evaluator = proximity_and_independent(model, ctx, mode="model_to_target", sigma=2.0,
                                          n_points=4 * model.rank)
    return ctx, mixture, evaluator


def start_chains(data, n_chains: int, **kw):
    """(ctx, mixture, step with stored coefficients, carry of ``n_chains``
    chains at the initial state) of one configuration, the step warmed up."""
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    ctx, mixture, evaluator = _setup(data, **kw)
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)
    carry = mh.init_carry(data.model, evaluator, init_state(data.model, n_chains), mixture)
    warm_up(step, carry)
    return ctx, mixture, step, carry


def run_config(data, label, n_chains, n_steps, seed: int = 1024, **kw) -> dict:
    """``n_steps`` steps of ``n_chains`` chains of one configuration
    (randomness from a generator seeded with ``seed``) → the JAX tool's
    summary row."""
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.diagnostics import ess

    ctx, mixture, step, carry = start_chains(data, n_chains, **kw)
    gen = torch.Generator(device=carry.log_post.device).manual_seed(seed)
    t0 = time.perf_counter()
    final, records = mh.run_chains(step, carry, n_steps, gen)
    records = mh.stack_records(records)
    acc = records.accepted.cpu().numpy()  # [C, T]; waits for the device
    dt = time.perf_counter() - t0

    pidx = records.proposal_idx.cpu().numpy()
    per_comp = {}
    for i, name in enumerate(mixture.names):
        sel = pidx == i
        per_comp[name] = {
            "selected_frac": float(sel.mean()),
            "acceptance": float(acc[sel].mean()) if sel.any() else None,
        }

    # the held chain state (the post-step coefficients) over the second half
    states = records.coeffs.cpu().numpy()  # [C, T, r]
    half = n_steps // 2
    post = states[:, half:, :]
    ess_c0 = float(ess(torch.as_tensor(post[:, :, 0]), max_lag=200))
    ess_mean = float(np.mean(ess(torch.as_tensor(post[:, :, :8]), max_lag=200).numpy()))
    errs = surface_avg_dist(data.model, ctx, final.state)
    out = {
        "label": label,
        "config": {k: (v if not callable(v) else str(v)) for k, v in kw.items()},
        "chains": n_chains,
        "steps": n_steps,
        "wall_s": round(dt, 2),
        "acceptance_overall": float(acc.mean()),
        "per_component": per_comp,
        "ess_per_step_coeff0": ess_c0 / (n_chains * (n_steps - half)),
        "ess_total_coeff0": ess_c0,
        "ess_mean_first8": ess_mean,
        "final_avg_dist_mm_mean": float(errs.mean()),
        "final_avg_dist_mm_best": float(errs.min()),
        "posterior_mean_c0_first4": post.mean(axis=(0, 1))[:4].tolist(),
        "posterior_sd_first4": post.std(axis=(0, 1))[:4].tolist(),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, out="mixing_sweep.json")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1024)
    ap.add_argument("--quick", action="store_true", help="only 3 configs")
    args = ap.parse_args(argv)

    data = femur_data(args.components, args.data_dir, args.device)
    results = [run_config(data, label, args.chains, args.steps, args.seed, **kw)
               for label, kw in grid(args.quick)]
    write_json(args.out, results)
    print(f"[mixing_sweep] wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
