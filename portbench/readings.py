"""The readings a cell's limits are set from, in one process on the card:

    python3 portbench/readings.py --workload <cell> --seeds 12 --control-seeds 3 \\
        --seconds 10 [--first-seed N] [--out FILE]

runs the port for ``--seeds`` seeds (each a window of ``--seconds`` at the
cell's own size, judged as a benchmark run judges it), then the control
(``control.py``: the reference in the port's place in float32 with TF32)
for ``--control-seeds`` seeds over as many chain-steps as a run judges.
One JSON line a run: side, seed, the compared numbers and the
diagnostics.  The lower reading of a number is its largest over the port's
seeds, the upper its smallest over the control's."""
from __future__ import annotations

import time

START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench.check import NUMBERS  # noqa: E402
from portbench.control import ControlSystem  # noqa: E402
from portbench.manifest import ROOT, Manifest  # noqa: E402
from portbench.run import run_cell  # noqa: E402

CONTROL_STEPS = 4  # window steps of the control (each a whole reference step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # as a benchmark run
    device = torch.device("cuda", 0)
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    out = open(args.out, "a") if args.out else None
    pairs = int(cell["check"]["pairs"])
    runs = [("port", s) for s in range(args.seeds)] + [
        ("control", s) for s in range(args.control_seeds)]
    caches = {"port": {}, "control": {}}
    for side, k in runs:
        seed = args.first_seed + 7919 * k
        t = time.monotonic()
        if side == "port":
            res, lines = run_cell(man, cell, seed, args.seconds, False, device, t,
                                  cache=caches[side])
        else:  # as many chain-steps as a run judges, over few steps of many chains
            ctl = {**cell, "check": {**cell["check"],
                                     "chains": math.ceil(pairs / CONTROL_STEPS)}}
            res, lines = run_cell(man, ctl, seed, 3600.0, False, device, t,
                                  system_class=ControlSystem, max_steps=CONTROL_STEPS,
                                  cache=caches[side])
        row = {"cell": cell["name"], "side": side, "seed": seed,
               "correct": res["correct"], "attempted": res["attempted"],
               **{n: res["check"][n]["value"] for n in NUMBERS},
               "metrics": {k2: v["value"] for k2, v in res["metrics"].items()},
               "seconds": time.monotonic() - t, "log": lines}
        text = json.dumps(row)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
