"""Driver entry points: one batched step, and a dry run over several ranks.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX package's
``entry`` and ``dryrun_multichip``) on the stand-in femur GPMM-50 (rank 51).
``dryrun_multichip`` starts one process per rank itself:

    python -c "from icp_proposal_tpu_torch.graft_entry import dryrun_multichip as d; d(2)"

and each rank runs ``python -m icp_proposal_tpu_torch.graft_entry --rank R
--world N --init file://... --device cuda|cpu``.
"""
from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

from icp_proposal_tpu_torch.device import DEFAULT_DEVICE

DRYRUN_SEED = 1024
DRYRUN_STEPS = 100
# a rank that has not finished by then is killed and the dry run fails
DRYRUN_RANK_TIMEOUT = 300.0


def entry(device=DEFAULT_DEVICE):
    """→ (fn, example_args): one batched MH step of the flagship femur
    ICP-proposal configuration (GPMM-50 stand-in, 8 chains) on explicit
    noise; ``fn(carry, noise)`` → (carry, accepted, log_product)."""
    import torch

    from icp_proposal_tpu_torch.apps.femur import (
        load_standin_femur_data,
        make_icp_proposal_setup,
    )
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    data = load_standin_femur_data(device=device, model_components=50)
    _, mixture, evaluator = make_icp_proposal_setup(data)
    step = mh.make_mh_step(data.model, mixture, evaluator, store_params=False)
    n_chains = 8
    carry = mh.init_carry(data.model, evaluator, init_state(data.model, n_chains), mixture)
    noise = mh.draw_noise(mixture, n_chains,
                          torch.Generator(device=data.model.device).manual_seed(0))

    def fn(carry, noise):
        new_carry, record = step(carry, noise)
        return new_carry, record.accepted, record.log_product

    return fn, (carry, noise)


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """Run the flagship femur GPMM-50 configuration (reference
    ``IcpProposalRegistration.scala:59-87``: 0.9·ICP both directions +
    0.1·random walk, 4·rank evaluator points) as ≥ 64 chains × 100 steps
    sharded over ``n_devices`` ranks, with acceptance and split-R̂/ESS pooled
    by all-reduce.  ``device="cuda"``: one rank per card over NCCL;
    ``"cpu"``: gloo ranks.  The ranks meet at a ``file://`` rendezvous in a
    temporary directory; each is waited for with a time limit, and any rank
    that fails or outlives it fails the dry run."""
    import torch

    from icp_proposal_tpu_torch.device import resolve_device
    from icp_proposal_tpu_torch.parallel.distributed import run_ranks

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    root = Path(__file__).resolve().parents[1]
    envs = [dict(os.environ, LOCAL_RANK=str(rank)) for rank in range(n_devices)]
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[sys.executable, "-m", "icp_proposal_tpu_torch.graft_entry",
                 "--rank", str(rank), "--world", str(n_devices),
                 "--init", f"file://{tmp}/rendezvous", "--device", dev.type]
                for rank in range(n_devices)]
        outputs = run_ranks(cmds, DRYRUN_RANK_TIMEOUT, tmp, cwd=root, envs=envs)
    print(outputs[0], end="")


def _dryrun_rank(rank: int, world: int, init: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from icp_proposal_tpu_torch.apps.femur import (
        load_standin_femur_data,
        make_icp_proposal_setup,
    )
    from icp_proposal_tpu_torch.apps.femur_experiments import _batched_init_states, _fold_in
    from icp_proposal_tpu_torch.parallel.distributed import initialize_distributed
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import FitState

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    dev = initialize_distributed(init, world, rank, device=device)
    try:
        mesh = make_chain_mesh([dev] * world)  # each rank reads its own entry
        data = load_standin_femur_data(device=dev, model_components=50)
        _, mixture, evaluator = make_icp_proposal_setup(data)
        step = mh.make_mh_step(data.model, mixture, evaluator, store_params=True)
        n_chains = max(64, 8 * world) // world * world
        states = _batched_init_states(data.model, n_chains, DRYRUN_SEED, variance=0.1)
        carries = mh.init_carry(data.model, evaluator,
                                FitState(*(x[mesh.chain_rows(n_chains)] for x in states)),
                                mixture)
        _, _, stats = run_sharded_chains(step, carries, _fold_in(DRYRUN_SEED, 7),
                                         DRYRUN_STEPS, mesh, burn_in=DRYRUN_STEPS // 5)
        acc, rhat, ess = float(stats.acceptance), float(torch.max(stats.rhat)), float(stats.ess)
        if not 0.0 < acc < 1.0:
            raise AssertionError(f"pooled acceptance degenerate: {acc}")
        if stats.coeff_mean.shape != (data.model.rank,):
            raise AssertionError(f"coeff_mean shape {tuple(stats.coeff_mean.shape)}")
        if not (rhat > 0.0 and ess > 0.0):
            raise AssertionError(f"pooled R-hat {rhat}, ESS {ess}")
        if rank == 0:
            via = "all-reduce over " + dist.get_backend() if mesh.group is not None else "none"
            print(f"dryrun_multichip ok: {world} ranks ({dev.type}), {n_chains} sharded chains "
                  f"x {DRYRUN_STEPS} steps, femur GPMM-50 stand-in flagship; pooled "
                  f"acceptance={acc:.3f} max split-Rhat(first 8)={rhat:.3f} "
                  f"ESS(coeff0)={ess:.1f} (pooled by {via})", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="one rank of dryrun_multichip")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True, help="init_method URL of the rendezvous")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args()
    _dryrun_rank(a.rank, a.world, a.init, a.device)
