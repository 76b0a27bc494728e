"""Femur convergence run: rounds of chains until split-R̂ falls below a target.

Counterpart of the repository's ``tools/converged_run.py``.  Protocol:

  * ``--chains`` chains of the femur GPMM from OVERDISPERSED inits
    (per-chain coefficient draws of the N(0, I) prior,
    ``apps/femur_experiments._batched_init_states(variance=1.0)``), so
    split-R̂ starts far above 1 and has to fall;
  * the setup ``--setup``, default ``apps/femur.recommended_setup()``;
  * rounds of ``--round-steps`` steps through
    ``parallel/runner.run_sharded_chains``, R̂ and ESS pooled over the
    ranks by ``all_reduce``; one random stream over all rounds;
  * done when a round after the first (round 0 is burn-in) reads max
    split-R̂ of the first 8 coefficients below ``--rhat-target``, or after
    ``--max-rounds`` rounds.  The post-burn-in rounds are checked again on
    rank 0 with ``diagnostics.split_rhat``/``ess`` over the traces of every
    rank gathered there (the "host" cross-check: no collective).

One process on one card, or one rank per card:

    python3 -m icp_proposal_tpu_torch.tools.converged_run [--device cpu]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m icp_proposal_tpu_torch.tools.converged_run

Rank 0 writes ``--out`` and prints the summary as the last line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from icp_proposal_tpu_torch.tools import add_common_args, femur_data, write_json


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, out="converged_run.json")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--setup", default=None,
                    help="femur setup name (default: recommended_setup())")
    ap.add_argument("--round-steps", type=int, default=10000)
    ap.add_argument("--max-rounds", type=int, default=8)
    ap.add_argument("--segment-steps", type=int, default=1000)
    ap.add_argument("--rhat-target", type=float, default=1.1)
    ap.add_argument("--diag-max-lag", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from icp_proposal_tpu_torch.apps import femur as femur_app
    from icp_proposal_tpu_torch.apps.femur_experiments import _batched_init_states, _fold_in
    from icp_proposal_tpu_torch.parallel.distributed import initialize_distributed
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu_torch.sampling import diagnostics, mh
    from icp_proposal_tpu_torch.sampling.state import FitState

    joined = not dist.is_initialized()
    device = initialize_distributed(device=args.device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_chain_mesh([device] * world)  # each rank reads its own entry
        setup_name = args.setup or femur_app.recommended_setup()
        data = femur_data(args.components, args.data_dir, device)
        _, mixture, evaluator = femur_app.SETUPS[setup_name](data)
        step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)

        chains = args.chains
        # OVERDISPERSED inits: the full prior variance (1.0), not the
        # reference's 0.1 comparison variance; every rank draws them all
        # and keeps its rows
        states = _batched_init_states(data.model, chains, args.seed, variance=1.0)
        carry = mh.init_carry(data.model, evaluator,
                              FitState(*(x[mesh.chain_rows(chains)] for x in states)),
                              mixture)
        gen = torch.Generator(device=device).manual_seed(_fold_in(args.seed, 7))

        rounds = []
        post_parts = []  # host copies of this rank's post-burn-in traces
        converged_round = None
        t_start = time.time()
        for r in range(args.max_rounds):
            t0 = time.time()
            carry, records, stats = run_sharded_chains(
                step, carry, gen, args.round_steps, mesh, burn_in=0,
                segment_steps=args.segment_steps, diag_max_lag=args.diag_max_lag)
            rhat_max = float(torch.max(stats.rhat))
            ess0 = float(stats.ess)
            acc = float(stats.acceptance)
            dt = time.time() - t0
            rounds.append({
                "round": r,
                "steps": args.round_steps,
                "collective_split_rhat_max_first8": rhat_max,
                "collective_ess_coeff0": ess0,
                "pooled_acceptance": acc,
                "wall_s": round(dt, 1),
            })
            if mesh.rank == 0:
                print(f"[converged] round {r}: split-R^ {rhat_max:.4f} ESS0 {ess0:.0f} "
                      f"acc {acc:.3f} ({dt:.0f}s)", flush=True)
            if r >= 1:
                post_parts.append(records.coeffs.cpu())
            del records
            if r >= 1 and rhat_max < args.rhat_target:
                converged_round = r
                break

        out = {
            "devices": world,
            "mesh": f"{world} {'rank' if world == 1 else 'ranks'} of {device.type} "
                    f"({'collectives' if mesh.group is not None else 'one process'})",
            "chains": chains,
            "components": args.components,
            "setup": setup_name,
            "init": "overdispersed (per-chain prior draws, variance 1.0)",
            "round_steps": args.round_steps,
            "rhat_target": args.rhat_target,
            "rounds": rounds,
            "converged": converged_round is not None,
            "converged_at_round": converged_round,
            "total_steps_run": args.round_steps * len(rounds),
            "burn_in_discarded_steps": args.round_steps,  # round 0 discarded
            "trace": "chain_state",
            "diagnostics_via": ("collectives" if mesh.group is not None
                                else "single_device_fast_path"),
            "total_wall_s": round(time.time() - t_start, 1),
        }
        if post_parts:
            # host cross-check over ALL post-burn-in rounds pooled (round 0
            # discarded as burn-in), the traces of every rank gathered
            post = torch.cat(post_parts, dim=1)  # [C_local, T, r]
            parts = [post]
            if mesh.group is not None:
                parts = [None] * world if mesh.rank == 0 else None
                dist.gather_object(post, parts, dst=0)
            if mesh.rank == 0:
                post = torch.cat(parts)
                # the gathered traces on rank 0's device: a thousand lags of
                # a [C, T, 8] product are slow on one host core
                t = post[:, :, :8].to(device)
                out["host_split_rhat_max_first8_postburn"] = float(
                    torch.max(diagnostics.split_rhat(t)))
                ess8 = diagnostics.ess(t, max_lag=args.diag_max_lag).cpu().numpy()
                out["host_ess_first8_postburn"] = ess8.tolist()
                out["host_ess_first8_mean"] = float(ess8.mean())
                flat = post.reshape(-1, post.shape[-1]).numpy()
                out["posterior_mean_coeffs_first8"] = flat.mean(axis=0)[:8].tolist()
                out["posterior_mean_coeffs_norm"] = float(np.linalg.norm(flat.mean(axis=0)))
                out["posterior_sd_mean"] = float(flat.std(axis=0).mean())

        if mesh.rank == 0:
            write_json(args.out, out)
            print(json.dumps({k: out[k] for k in (
                "converged", "converged_at_round", "total_steps_run", "chains",
                "setup", "diagnostics_via")}), flush=True)
        return out
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
