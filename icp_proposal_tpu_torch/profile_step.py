"""Device-time breakdown of one MH setup's step on the card, by kernel.

    python3 -m icp_proposal_tpu_torch.profile_step --setup bfm-partial
    python3 -m icp_proposal_tpu_torch.profile_step --setup femur
    python3 -m icp_proposal_tpu_torch.profile_step --setup hybrid
    python3 -m icp_proposal_tpu_torch.profile_step --setup femur --rank 401

Builds the setup at its full width (femur stand-in GPMM-100 with the
flagship setup, ``femur``, or one of the femur ``SETUPS`` rows ``hybrid``,
``mala``, ``rw-adapt``; or the rank-200 face stand-in with the partial-face
setup; ``--rank`` sets the model's rank instead: the femur stand-in
GPMM-(rank − 1), the face stand-in at that rank), runs 3 warm-up steps of 2,048
chains, then 5 steps under ``torch.profiler`` and prints, on one line each:
the card's name and power limit (``nvidia-smi``), the wall time per step,
the device busy time per step (the sum of kernel durations; the port runs
on one stream), the busy share, the number of device operations per step,
and the device time per step of every kernel name, largest first.  The same window unprofiled is
timed first, so the profiler's own cost shows.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict

import torch

N_CHAINS, WARMUP_STEPS, STEPS = 2048, 3, 5
FEMUR_SETUPS = {"femur": "flagship", "hybrid": "hybrid", "mala": "mala",
                "rw-adapt": "rw-adapt"}


def _setup(name: str, device, rank: int | None = None):
    if name in FEMUR_SETUPS:
        from icp_proposal_tpu_torch.apps.femur import SETUPS, load_standin_femur_data

        data = load_standin_femur_data(device=device, model_components=(rank or 101) - 1)
        return data.model, SETUPS[FEMUR_SETUPS[name]](data)
    from icp_proposal_tpu_torch.apps.bfm import (
        load_synthetic_face_data,
        make_bfm_fitting_setup,
    )

    data = load_synthetic_face_data(rank=rank or 200, subdiv=4, device=device)
    return data.model, make_bfm_fitting_setup(data, partial=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--setup", choices=(*FEMUR_SETUPS, "bfm-partial"),
                        default="bfm-partial")
    parser.add_argument("--rank", type=int, default=None,
                        help="the model's rank: for the femur setups the stand-in "
                             "GPMM-(rank - 1), e.g. 401 as in chip_smoke.py's "
                             "[main:gpmm400]; for bfm-partial the face stand-in at that "
                             "rank, e.g. 600 as in [main:bfm600] (default: femur 101, "
                             "face 200)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    dev = torch.device("cuda", 0)
    model, (_, mixture, evaluator) = _setup(args.setup, dev, args.rank)
    step = mh.make_mh_step(model, mixture, evaluator)
    gen = torch.Generator(device=dev).manual_seed(0)
    carry = mh.init_carry(model, evaluator, init_state(model, N_CHAINS), mixture)
    carry, _ = mh.run_chains(step, carry, WARMUP_STEPS, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    carry, _ = mh.run_chains(step, carry, STEPS, gen)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t) / STEPS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        carry, _ = mh.run_chains(step, carry, STEPS, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / STEPS
    by_name, n_ops = defaultdict(float), 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total / 1e3 / STEPS  # µs → ms
            n_ops += 1
    busy = sum(by_name.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[:1]
    print(f"[profile] {args.setup} at rank {model.rank}: {N_CHAINS} chains x {STEPS} steps; "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi: {', '.join(smi) or 'none'}")
    print(f"[profile] wall {wall_ms:.3f} ms/step profiled, {plain_ms:.3f} unprofiled; "
          f"device busy {busy:.3f} ms/step, busy share {busy / wall_ms:.3f} of the "
          f"profiled wall, {busy / plain_ms:.3f} of the unprofiled; "
          f"{n_ops / STEPS:.0f} device operations per step")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {ms:9.3f} ms/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
