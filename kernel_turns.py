"""Time K2, K3, K4 and K8 of one checkout of the port on one NVIDIA GPU.

    python3 kernel_turns.py [--root DIR] [--sass] [--probe] [--contexts]

Times K2 (``tri_solve_lt``, r = 101, beside ``torch.linalg.solve_triangular``),
K3 (``nearest_vertices``: the shared set, P = 404 against the stand-in
femur's 1,622 vertices, and per chain, P = 202 against each chain's own
1,622), K4 (``refine_shortlist``: the K = 64 shortlists of K3's anchors
for those 404 queries) and K8 (``coarse_nearest_dot``: the same 404
queries against the target's [1,622, 4] table) at the femur path's shapes,
and K4 at the BFM partial face's (``refine_shortlist[bfm]``: P = 400
queries near the rank-200 face stand-in's partial target against its
1,648 vertices and 3,202 faces), on 256 and 2,048
chains, with CUDA events, for the package
``icp_proposal_tpu_torch`` of the checkout at DIR (default: the one that
holds this script).  Two checkouts are compared on one card by running the
script once per checkout in turns (A, B, B, A), each run its own process.
The ids are checked against the plain twins at 256 chains first.  A
checkout whose K4 reads a per-vertex corner table (``SurfaceIndex.cand_tri``)
is timed with that table; one with the face table, with the face table.

``--sass`` also reads inner loops from the built library's SASS
(``cuobjdump -sass``): for K3 and K8 the issued instructions per (query,
vertex) pair in the vertex loop (and with the per-group bookkeeping of the
loop around it) of the template instance each launches at 2,048 chains;
for K4 the instructions in the body of the slot loop per (query, face)
pair, pairs counted by the cascade's five IEEE divisions (``MUFU.RCP``).

``--probe`` (this checkout's K4 and K8 only) builds the kernels again with
their launch choices overridden (``-DICP_REFINE_LANES=L -DICP_DOT_Q=Q``,
one library per pair, under ``build/icp_kernels``) and times K4 at the
femur shapes with L = 1, 2, 4, 8, 16 and 32 lanes a query and K8 with
Q = 1 ... 8 queries a lane, at 256 and 2,048 chains, through each
library's C entry points, after checking each against the plain twin.

``--contexts`` times whole ``build_target_context`` calls instead of the
kernels: the stand-in femur's target, the face stand-in's target and its
partial target (rank 200, subdivision 4), ``TURNS`` calls each, each ended
by a synchronize, after the setups have built contexts once.  The
checkout builds its shortlist index its own way (on the host with numpy
before K9; with K9 on the card since).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
``{"root": ..., "times": {...}, "sass": {...}, "probe": {...}}`` (ms per
call, the mean of ``REPS`` calls, each timing repeated ``TURNS`` times).
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CHAINS = (256, 2048)
REPS, TURNS = 20, 3
BFM_P = 400  # the BFM partial step's ICP queries a chain (model direction)
BFM_NOISE = 0.005  # their offset from the target, below its mean edge (0.0069)
# (lanes a query, K8's queries a lane) of the --probe builds, beside the
# default build's own
PROBE_BUILDS = ((1, 1), (2, 2), (8, 3), (16, 5), (32, 6), (4, 7), (4, 8))


def _time_ms(torch, fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sass_functions(lib_path, nvcc):
    """{mangled name: [(address, instruction)]} of the library's SASS, or
    None without cuobjdump."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        out[func.split("\n", 1)[0].strip()] = [
            (int(m.group(1), 16), m.group(2))
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    return out


def _loops(ins, per_pair):
    """Backward-branch loops of one function: (instructions in the body,
    pairs in it by ``per_pair(body)``, first address, last address) for
    those with pairs."""
    loops = []
    for at, text in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < at:
            lo = int(m.group(1), 16)
            body = [t for a, t in ins if lo <= a <= at]
            pairs = per_pair(body)
            if pairs:
                loops.append((len(body), pairs, lo, at))
    return loops


def _nv_sass(funcs, pair, q):
    """K3's or K8's scan (``pair`` "EuclidPair" or "DotPair", Q = q): issued
    instructions per pair in the innermost loop that holds the pairs'
    FMNMX, and the same with the enclosing loop; None if not found."""
    for name, ins in funcs.items():
        if "nearest_vertices_kernel" not in name or f"{pair}ELi{q}EEEv" not in name:
            continue
        loops = _loops(ins, lambda body: sum("FMNMX" in t for t in body))
        if not loops:
            return None
        inner = min(loops)
        outer = [x for x in loops if x[2] <= inner[2] and x[3] >= inner[3] and x > inner]
        return inner[0] / inner[1], (min(outer)[0] / min(outer)[1]) if outer else None
    return None


def _refine_sass(funcs):
    """K4's slot loop: (instructions in the body per pair, pairs in the
    body) for the loop with the most pairs, pairs counted by the cascade's
    five IEEE divisions (one ``MUFU.RCP`` each); None if not found."""
    for name, ins in funcs.items():
        if "refine_shortlist_kernel" not in name:
            continue
        loops = _loops(ins, lambda body: sum("MUFU.RCP" in t for t in body) / 5)
        if not loops:
            return None
        body, pairs = max(loops, key=lambda x: (x[1], -x[0]))[:2]
        return body / pairs, pairs
    return None


def _probe_libraries():
    """{(lanes, q): library} for the default build and the ``PROBE_BUILDS``,
    compiled together; each library's own launch is checked to take its
    lanes and Q."""
    import ctypes

    from icp_proposal_tpu_torch import _build

    def build(lq):
        flags = (f"-DICP_REFINE_LANES={lq[0]}", f"-DICP_DOT_Q={lq[1]}")
        return _build.bind_library(_build.build_library(extra_flags=flags)[0])

    with ThreadPoolExecutor(len(PROBE_BUILDS)) as pool:
        libs = dict(zip(PROBE_BUILDS, pool.map(build, PROBE_BUILDS)))
    libs[(4, 4)] = _build.load_library()
    for (lanes, qn), lib in libs.items():
        out = (ctypes.c_int * 5)()
        if lib.icp_refine_shortlist_config(1024, out) or out[0] != lanes:
            raise AssertionError(f"the build for {lanes} lanes launches {out[0]}")
        if lib.icp_nearest_vertices_config(2048, 404, 1622, 0, 1, out) or out[0] != qn:
            raise AssertionError(f"the build for Q = {qn} launches Q = {out[0]}")
    return libs


def _probe(torch, dev, libs, q, nv, index, va):
    """K4 by lanes (the builds of distinct lanes) and K8 by Q, through each
    library's C entry points (not counted as launches), each checked
    against the plain twin first: {name: [ms, ...]}."""
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    n, out = q.shape[0] * q.shape[1], {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    f = torch.empty(q.shape[:2], dtype=torch.int32, device=dev)
    w = torch.empty(q.shape[:2] + (9,), dtype=torch.float32, device=dev)
    ids = torch.empty(q.shape[:2], dtype=torch.int32, device=dev)
    want_k4 = cp.refine_shortlist_plain(q, nv, index.cand, index.faces)
    want_k8 = cp.coarse_nearest_dot_plain(q, va)

    def call(fn, *args):
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    timed_lanes = set()
    for (lanes, qn), lib in sorted(libs.items()):
        def k4(lib=lib):
            call(lib.icp_refine_shortlist, q.data_ptr(), nv.data_ptr(), index.cand.data_ptr(),
                 index.faces.data_ptr(), f.data_ptr(), w.data_ptr(), n,
                 index.cand.shape[0], index.faces.shape[0], index.cand.shape[1])

        def k8(lib=lib):
            call(lib.icp_coarse_nearest_dot, q.data_ptr(), va.data_ptr(), ids.data_ptr(),
                 q.shape[0], q.shape[1], va.shape[0])

        if lanes not in timed_lanes:
            timed_lanes.add(lanes)
            k4()
            if not (torch.equal(f, want_k4[0]) and torch.equal(w, want_k4[1])):
                raise AssertionError(f"K4 built for {lanes} lanes differs from the twin")
            out[f"refine_shortlist[lanes={lanes}]"] = [_time_ms(torch, k4, REPS)
                                                       for _ in range(TURNS)]
        k8()
        if not torch.equal(ids, want_k8):
            raise AssertionError(f"K8 built for Q = {qn} differs from the twin")
        out[f"coarse_nearest_dot[q={qn}]"] = [_time_ms(torch, k8, REPS) for _ in range(TURNS)]
    return out


def _context_times(torch, dev, data, face):
    """Seconds of ``TURNS`` whole ``build_target_context`` calls per target."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    targets = {"femur": (data.target, data.target_boundary_mask),
               "face": (face.target, face.target_boundary_mask),
               "partial-face": (face.target_partial, face.partial_boundary_mask)}
    out = {}
    for name, (target, mask) in targets.items():
        out[name] = []
        for _ in range(TURNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            build_target_context(target, mask, device=dev)
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--contexts", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from icp_proposal_tpu_torch import _build
    from icp_proposal_tpu_torch.apps.bfm import load_synthetic_face_data, make_bfm_fitting_setup
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
    index = ctx.index
    va = make_icp_proposal_setup(data, coarse="dot")[0].index.points_aug
    face = load_synthetic_face_data(rank=200, subdiv=4, device=dev)
    bindex = make_bfm_fitting_setup(face, partial=True)[0].index
    if args.contexts:
        print(json.dumps({"root": str(root), "device": smi.splitlines()[0],
                          "contexts": _context_times(torch, dev, data, face)}))
        return 0
    # the refine's table: the face table, or an older checkout's per-vertex one
    table = index.faces if hasattr(index, "faces") else index.cand_tri
    btable = bindex.faces if hasattr(bindex, "faces") else bindex.cand_tri
    libs = _probe_libraries() if args.probe else None
    r, v = data.model.rank, data.model.num_points
    ref = data.model.ref_points
    rng = np.random.RandomState(0)

    times, probe = {}, {}
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
        nv = cp.nearest_vertices(q, index.points)
        bq = (bindex.points[torch.as_tensor(
            rng.randint(0, bindex.points.shape[0], (b, BFM_P)), device=dev)]
            + torch.as_tensor(rng.randn(b, BFM_P, 3).astype(np.float32) * BFM_NOISE,
                              device=dev)).contiguous()
        bnv = cp.nearest_vertices(bq, bindex.points)
        fns = {
            "tri_solve_lt": lambda: cc.tri_solve_lt(lo, z),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                lo.transpose(-1, -2), z[..., None], upper=True),
            "nearest_vertices[shared]": lambda: cp.nearest_vertices(q, index.points),
            "nearest_vertices[per_chain]": lambda: cp.nearest_vertices(tq, pts_b),
            "refine_shortlist": lambda: cp.refine_shortlist(q, nv, index.cand, table),
            "refine_shortlist[bfm]": lambda: cp.refine_shortlist(bq, bnv, bindex.cand, btable),
            "coarse_nearest_dot": lambda: cp.coarse_nearest_dot(q, va),
        }
        if b == CHAINS[0]:
            for qq, pts in ((q, index.points), (tq, pts_b)):
                n = int((cp.nearest_vertices(qq, pts) != cp.nearest_vertices_plain(qq, pts))
                        .sum())
                if n:
                    raise AssertionError(f"K3: {n} ids differ from the plain twin")
            for args4 in ((q, nv, index.cand, table), (bq, bnv, bindex.cand, btable)):
                for got, want in zip(cp.refine_shortlist(*args4),
                                     cp.refine_shortlist_plain(*args4)):
                    if not torch.equal(got, want):
                        raise AssertionError("K4 differs from the plain twin")
            if not torch.equal(cp.coarse_nearest_dot(q, va), cp.coarse_nearest_dot_plain(q, va)):
                raise AssertionError("K8 differs from the plain twin")
        for name, fn in fns.items():
            times[f"{name}@{b}"] = [_time_ms(torch, fn, REPS) for _ in range(TURNS)]
        if args.probe:
            probe.update({f"{name}@{b}": t for name, t in _probe(torch, dev, libs, q, nv, index,
                                                                  va).items()})
        del a, m, lo, q, pts_b, tq, nv, bq, bnv

    sass = {}
    funcs = _sass_functions(_build.library_path(), _build.find_nvcc()) if args.sass else None
    if funcs:
        for mode, p in (("shared", 4 * r), ("per_chain", 2 * r)):
            qn = cp.nearest_vertices_config(CHAINS[-1], p, v, mode == "per_chain")["q"]
            got = _nv_sass(funcs, "EuclidPair", qn)
            sass[f"nearest_vertices[{mode}]"] = None if got is None else {
                "q": qn, "per_pair": got[0], "per_pair_with_bookkeeping": got[1]}
        qn = cp.nearest_vertices_config(CHAINS[-1], 4 * r, v, False, dot=True)["q"]
        got = _nv_sass(funcs, "DotPair", qn)
        sass["coarse_nearest_dot"] = None if got is None else {
            "q": qn, "per_pair": got[0], "per_pair_with_bookkeeping": got[1]}
        lanes = cp.refine_shortlist_config(CHAINS[-1] * 4 * r)["lanes"]
        got = _refine_sass(funcs)
        sass["refine_shortlist"] = None if got is None else {
            "lanes": lanes, "per_pair": got[0], "pairs_in_body": got[1]}
    print(json.dumps({"root": str(root), "device": smi.splitlines()[0], "times": times,
                      "sass": sass, "probe": probe}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
