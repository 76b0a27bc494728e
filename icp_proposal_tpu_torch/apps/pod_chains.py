"""Many chains sharded over the cards of a node, with pooled convergence
diagnostics.

Counterpart of ``icp_proposal_tpu/apps/pod_chains.py`` (BASELINE config[4]:
e.g. 1,024 chains with pooled R̂/ESS/acceptance).  One process per card:

    python -m icp_proposal_tpu_torch.apps.pod_chains --chains 1024 --steps 1000
    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m icp_proposal_tpu_torch.apps.pod_chains --chains 1024 --steps 1000

Without ``--data-dir`` it runs on the stand-in femur GPMM
(``load_standin_femur_data``).  Rank 0 prints the result as one JSON line,
the last of its output, and alone writes ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE


def main(argv=None) -> dict:
    """Run the CLI → the result dict (on every rank; rank 0 prints it)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chains", type=int, default=1024)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--components", type=int, default=100)
    p.add_argument("--seed", type=int, default=1024)
    p.add_argument("--init-variance", type=float, default=0.1)
    p.add_argument("--setup", default="flagship",
                   help="proposal/evaluator recipe, any femur SETUPS key: "
                        "flagship = reference ICP mixture; hybrid = exact-mode "
                        "ICP + MALA + RW; rw / rw-adapt / mala = fast-mixing "
                        "exact samplers")
    p.add_argument("--burn-frac", type=float, default=0.2,
                   help="fraction of steps discarded before diagnostics")
    p.add_argument("--diag-max-lag", type=int, default=100,
                   help="autocorrelation window of the pooled ESS; raise it for "
                        "slow-mixing setups (τ beyond the window truncates the "
                        "Geyer sum and overestimates ESS)")
    p.add_argument("--segment-steps", type=int, default=100,
                   help="steps of per-step records held before they are stacked")
    p.add_argument("--host-diagnostics", action="store_true",
                   help="also gather the coefficient traces to rank 0 and "
                        "recompute R-hat/ESS there (cross-check of the pooled "
                        "values; costs the traces' transfer)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the result JSON to this path (rank 0)")
    p.add_argument("--data-dir", type=str, default=None,
                   help="directory of the real femur assets; without it the "
                        "stand-in is used")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="'cuda' (NCCL between cards) or 'cpu' (gloo; the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from icp_proposal_tpu_torch.apps.femur import (
        SETUPS,
        load_femur_data,
        load_standin_femur_data,
    )
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
        chains = args.chains
        if chains < world:
            raise ValueError(f"{chains} chains for {world} ranks")
        if mesh.rank == 0:
            print(f"devices={world} chains={chains} steps={args.steps}", flush=True)

        data = (load_femur_data(args.components, args.data_dir, device=device)
                if args.data_dir else
                load_standin_femur_data(device=device, model_components=args.components))
        _, mixture, evaluator = SETUPS[args.setup](data)
        step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)
        # every rank builds the global inits (seeded per init index) and keeps its rows
        states = _batched_init_states(data.model, chains, args.seed, args.init_variance)
        states = FitState(*(x[mesh.chain_rows(chains)] for x in states))
        carries = mh.init_carry(data.model, evaluator, states, mixture)
        burn_in = int(args.steps * args.burn_frac)

        t0 = time.perf_counter()
        final, records, stats = run_sharded_chains(
            step, carries, _fold_in(args.seed, 7), args.steps, mesh, burn_in=burn_in,
            segment_steps=args.segment_steps, diag_max_lag=args.diag_max_lag)
        pooled_acc = float(stats.acceptance)  # waits for the device
        rhat_max = float(torch.max(stats.rhat))
        ess_c0 = float(stats.ess)
        dt = time.perf_counter() - t0

        out = {
            "devices": world,
            "chains": chains,
            "steps": args.steps,
            "components": args.components,
            "setup": args.setup,
            # the whole run with its records and pooling, not the bare
            # step's rate (store_params=False)
            "samples_per_sec": chains * args.steps / dt,
            "samples_per_sec_per_chip": chains * args.steps / dt / world,
            "pooled_acceptance": pooled_acc,
            "coeff_mean_norm": float(torch.linalg.norm(stats.coeff_mean)),
            # pooled from per-rank moment sums; the traces are the post-step
            # chain state, so these are diagnostics of the held Markov chain
            "rhat_max_first8": rhat_max,
            "ess_coeff0": ess_c0,
            "trace": "chain_state",
            "diagnostics_via": ("collectives" if mesh.group is not None
                                else "single_device_fast_path"),
        }

        if args.host_diagnostics:
            tail = records.coeffs[:, burn_in:, :8].cpu()
            parts = [tail]
            if mesh.group is not None:
                parts = [None] * world if mesh.rank == 0 else None
                dist.gather_object(tail, parts, dst=0)
            if mesh.rank == 0:
                traces = torch.cat(parts)
                out["host_rhat_max_first8"] = float(torch.max(diagnostics.split_rhat(traces)))
                out["host_ess_coeff0"] = float(diagnostics.ess(
                    traces[..., 0], max_lag=args.diag_max_lag))

        if mesh.rank == 0:
            print(json.dumps(out), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(out, f, indent=1)
        return out
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
