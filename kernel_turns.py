"""Time K2 and K3 of one checkout of the port on one NVIDIA GPU.

    python3 kernel_turns.py [--root DIR] [--sass]

Times K2 (``tri_solve_lt``, r = 101, beside ``torch.linalg.solve_triangular``)
and K3 (``nearest_vertices``: the shared set, P = 404 against the stand-in
femur's 1,622 vertices, and per chain, P = 202 against each chain's own
1,622) at the femur path's shapes on 256 and 2,048 chains, with CUDA
events, for the package ``icp_proposal_tpu_torch`` of the checkout at DIR
(default: the one that holds this script).  Two checkouts are compared on
one card by running the script once per checkout in turns (A, B, B, A),
each run its own process.  K3's ids are checked against its plain twin at
256 chains first.

``--sass`` also reads the inner loop of K3's scan from the built library's
SASS (``cuobjdump -sass``): issued instructions per (query, vertex) pair in
the vertex loop, and with the per-group bookkeeping of the loop around it,
for the template instance each mode launches at 2,048 chains.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
``{"root": ..., "times": {...}, "sass": {...}}`` (ms per call, the mean of
``REPS`` calls, each timing repeated ``TURNS`` times).
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

CHAINS = (256, 2048)
REPS, TURNS = 20, 3


def _time_ms(torch, fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sass_per_pair(lib_path, nvcc, q):
    """(issued instructions per pair in the innermost loop that holds the
    pairs' FMNMX, the same with the enclosing loop) for K3's instance with
    Q = q, or None when cuobjdump or the loop is not found."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for func in re.split(r"\n\s*Function : ", sass):
        name = func.split("\n", 1)[0]
        if "nearest_vertices_kernel" not in name or f"Li{q}EEEv" not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        loops = []  # (instructions, pairs, first address, last address)
        for at, text in ins:
            m = re.search(r"BRA (0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < at:
                lo = int(m.group(1), 16)
                body = [t for a, t in ins if lo <= a <= at]
                pairs = sum("FMNMX" in t for t in body)
                if pairs:
                    loops.append((len(body), pairs, lo, at))
        if not loops:
            return None
        inner = min(loops)
        outer = [x for x in loops if x[2] <= inner[2] and x[3] >= inner[3] and x > inner]
        return inner[0] / inner[1], (min(outer)[0] / min(outer)[1]) if outer else None
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from icp_proposal_tpu_torch import _build
    from icp_proposal_tpu_torch.apps.femur import (
        load_standin_femur_data,
        make_icp_proposal_setup,
    )
    from icp_proposal_tpu_torch.ops import chol_cuda as cc
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    if not str(Path(cp.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {cp.__file__}, not the package under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] nvidia-smi: {smi.splitlines()[0]}")
    dev = torch.device("cuda", 0)
    _build.build_library()
    data = load_standin_femur_data(device=dev)
    ctx = make_icp_proposal_setup(data)[0]
    r, v = data.model.rank, data.model.num_points
    ref = data.model.ref_points
    rng = np.random.RandomState(0)

    times = {}
    for b in CHAINS:
        a = torch.as_tensor(rng.randn(b, r, 3 * r).astype(np.float32) * 0.1, device=dev)
        m = a @ a.transpose(1, 2) + torch.eye(r, device=dev)
        lo = torch.linalg.cholesky(m).contiguous()
        z = torch.as_tensor(rng.randn(b, r).astype(np.float32), device=dev)
        q = (ref[torch.as_tensor(rng.randint(0, v, (b, 4 * r)), device=dev)]
             + torch.as_tensor(rng.randn(b, 4 * r, 3).astype(np.float32) * 0.5,
                               device=dev)).contiguous()
        pts_b = (ref[None] + torch.as_tensor(rng.randn(b, 1, 3).astype(np.float32),
                                             device=dev)).contiguous()
        tq = ctx.points[:2 * r].expand(b, -1, -1).contiguous()
        fns = {
            "tri_solve_lt": lambda: cc.tri_solve_lt(lo, z),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                lo.transpose(-1, -2), z[..., None], upper=True),
            "nearest_vertices[shared]": lambda: cp.nearest_vertices(q, ctx.index.points),
            "nearest_vertices[per_chain]": lambda: cp.nearest_vertices(tq, pts_b),
        }
        if b == CHAINS[0]:
            for qq, pts in ((q, ctx.index.points), (tq, pts_b)):
                n = int((cp.nearest_vertices(qq, pts) != cp.nearest_vertices_plain(qq, pts))
                        .sum())
                if n:
                    raise AssertionError(f"K3: {n} ids differ from the plain twin")
        for name, fn in fns.items():
            times[f"{name}@{b}"] = [_time_ms(torch, fn, REPS) for _ in range(TURNS)]
        del a, m, lo, q, pts_b, tq

    sass = {}
    if args.sass:
        for mode, p in (("shared", 4 * r), ("per_chain", 2 * r)):
            qn = cp.nearest_vertices_config(CHAINS[-1], p, v, mode == "per_chain")["q"]
            got = _sass_per_pair(_build.library_path(), _build.find_nvcc(), qn)
            sass[f"nearest_vertices[{mode}]"] = None if got is None else {
                "q": qn, "per_pair": got[0], "per_pair_with_bookkeeping": got[1]}
    print(json.dumps({"root": str(root), "device": smi.splitlines()[0], "times": times,
                      "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
