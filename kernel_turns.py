"""Time K2, K3, K4 and K8 (or K5, K9, K10, the streamed K6, the target assembly) of one checkout of the port on one GPU.

    python3 kernel_turns.py [--root DIR] [--sass] [--probe] [--contexts] [--streamed] [--ablate]
                            [--k5] [--assembly]

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

``--sass`` also counts K9's and K10's FP64 instructions (DADD, DMUL, DFMA,
DSETP, DMNMX) per pair in the loop that holds the cascade (pairs counted by
its four divisions' ``MUFU.RCP64H``, so an unrolled loop counts right; every
region's code, as the static body holds it), and compiles two probe kernels
with the build's flags, one IEEE division a / b and one reciprocal 1 / x,
whose fast paths give the FP64 instructions a division and a reciprocal
take (``native.DIV_FP64_INSTRUCTIONS``, ``RCP_FP64_INSTRUCTIONS``).

``--contexts`` times whole ``build_target_context`` calls instead of the
kernels: the stand-in femur's target, the face stand-in's target and its
partial target (rank 200, subdivision 4), ``TURNS`` calls each, each ended
by a synchronize, after the setups have built contexts once.  The
checkout builds its shortlist index its own way (on the host with numpy
before K9; with K9 on the card since).  With K9 in the checkout it also
times K9 (``shortlist_topk``) at the femur target (K = 64), at the open
patches of subdivision 5 (every 8th vertex, K = 64 and 1,024) and 6 (every
8th vertex, K = 64), and K10 (``point_tri_d2``) at the femur shape, each
held to its plain twin first at the femur shape, then one whole
``build_surface_index`` over the 31,715 vertices and 63,114 faces of the
subdivision-6 patch at K = 64 (host clock, ended by a synchronize).

``--streamed`` times only the streamed K6 (``chol_solve_streamed``, the
factor of r > 320) at ``STREAMED_CASES``: r = 401 and 600 on 2,048 chains
(the GPMM-400 and rank-600 paths) and r = 321, 401, 600, 1,024, 1,224 and
2,048 on 256,
each first held to ``chol_solve_plain`` (rtol 1e-4 + atol 1e-4, the
non-SPD chain NaN).  Inputs M = I + AAᵀ are drawn on the card from a
seeded generator.  Beside each time it prints the bound (r³/3 FP32 flops a
chain, or M's lower triangle in and L, x, log det out over HBM) and the
bytes this checkout's schedule moves: the workspace of finished panels
written and read again (each row tile's rows and the panel's 64 rows, once
per tile) and the back substitution's read of L's lower triangle, with
their time at 3.35 TB/s.

``--k5`` times only K5 (``surface_distances``, culled) at ``chip_smoke.py``'s
BFM shapes: the rank-200 face stand-in moved off its mean by 0.5·N(0, I)
coefficients, the partial-face evaluator's queries (as ``chip_smoke.py``
takes them: P = 800 model points against the partial target's 3,202
faces, ``shared``, and 800 target points against each chain's 3,872,
``per_chain``), on 256 and 2,048 chains.  Each is first held to the dense
scan (``cull=False``) bitwise, and at 256 chains to the plain twin too; one
counted call gives
the shares of (query, tile) and (query, face) pairs visited and, where the
checkout counts them, the cascades run.  With ``--sass``, the instructions
a pair of each loop of ``surface_distances_kernel`` that holds the
cascade (pairs counted by its five ``MUFU.RCP``), with the loop's shuffles,
and a box of each loop that holds box tests (six ``FMNMX`` a box).

``--ablate`` (this checkout only) builds copies of ``csrc/chol.cu`` under
``build/ablate/``, each with one phase of the streamed K6 taken out (its
results are then wrong and not checked) or its chains an SM changed
(checked against the plain twin), one ``nvcc`` each, all started together,
and times them through their C entry point at r = 401 and 600 on 2,048
chains, the list and then the list reversed (``ABLATIONS``).

``--assembly`` (a checkout with ``ops/assemble_cuda``) times only the ICP
target direction's assembly at ``ASSEMBLY_CASES``, the two femur
flagship cells' shapes (r = 101, m = 202 on 4,096 chains; r = 401, m = 802
on 2,048), on inputs drawn on the card: the kernel (``target_assembly``)
and its float32 plain twin in turns (twin, kernel, kernel, twin), with the
kernel's largest distance from the twin on M's lower triangle, the bound
(B·3m·r(r+1)/2 FP32 multiply-adds, or the basis, inputs and M's lower
triangle and rhs over HBM), the kernel's launch and its ptxas registers
and spills.

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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CHAINS = (256, 2048)
REPS, TURNS = 20, 3
# --streamed: (r, chains, calls a timing)
STREAMED_CASES = ((401, 2048, 10), (600, 2048, 5), (321, 256, 20), (401, 256, 20),
                  (600, 256, 10), (1024, 256, 5), (1224, 256, 4), (2048, 256, 2))
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12  # H100 SXM datasheet
# --ablate: (name, [(text in csrc/chol.cu, its replacement)]); the phases'
# names follow the kernel's comment, steps (1)–(5)
_FACTOR = ("    factor_tiles<kStreamWarps>(dblk, dblk + kDiagTiles * kTileElems, ild, logd, "
           "kPanel / kTile,\n                               tid >> 5, tid & 31);\n")
ABLATIONS = (
    ("as built", ()),
    ("3 chains an SM", (("kStreamCtas = 4;", "kStreamCtas = 3;"),)),
    ("5 chains an SM", (("kStreamCtas = 4;", "kStreamCtas = 5;"),)),
    ("no update (1)-(2)", (("  const int nk = j0 / kSlice;", "  const int nk = 0;"),)),
    ("no diagonal factor (3)", ((_FACTOR, "    __syncthreads();\n"),)),
    ("no solve of the rows below (4)", (("    for (int jc = 0; jc < 4; ++jc) {\n      if (16",
                                         "    for (int jc = 0; jc < 0; ++jc) {\n      if (16"),)),
    ("no M loads (1)", (("if (j0 + c <= i) v = mb[(size_t)i * r + j0 + c];",
                         "if (j0 + c <= i) v = 1.0f;"),)),
    ("no L rows out (5)", (("    (i < r ? lb + (size_t)i * r : xb)[j0 + c] = v;\n",
                            "    if (v == 12345.0f) xb[0] = v;\n"),)),
    ("no zeros above the block", (("      lb[(size_t)(j0 + e / run) * r + j0 + kPanel + e % run] = 0.0f;",
                                   "      if (e < 0) lb[0] = 0.0f;"),)),
    ("no back substitution", (("  solve_lt_streamed<kStreamWarps, false>(lb, vec, part, r);\n", ""),)),
)
K5_REPS = 10  # --k5: calls a timing
# --assembly: (rank, observations, chains, calls a timing of the kernel);
# the twin takes 2 calls a timing
ASSEMBLY_CASES = ((101, 202, 4096, 20), (401, 802, 2048, 5))
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


_FP64 = re.compile(r"^(@!?U?P\w+\s+)?D(ADD|MUL|FMA|SETP|MNMX)\b")
# one IEEE division and one reciprocal, compiled with the build's flags
_DIV_PROBE = r"""
extern "C" __global__ void div_probe(const double* a, const double* b, double* o) {
  o[threadIdx.x] = a[threadIdx.x] / b[threadIdx.x];
}
extern "C" __global__ void rcp_probe(const double* a, double* o) {
  o[threadIdx.x] = 1.0 / a[threadIdx.x];
}
"""


def _fp64_count(body):
    return sum(bool(_FP64.match(t.strip())) for t in body)


def _division_sass(nvcc, work):
    """FP64 instructions on the fast path (up to the first EXIT) of the
    probe division and reciprocal → {"div": n, "rcp": n}, or None."""
    from icp_proposal_tpu_torch import _build

    src, cubin = Path(work) / "div_probe.cu", Path(work) / "div_probe.cubin"
    src.write_text(_DIV_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)], check=True,
                   capture_output=True, timeout=300)
    funcs = _sass_functions(cubin, nvcc)
    if not funcs:
        return None
    out = {}
    for name, key in (("div_probe", "div"), ("rcp_probe", "rcp")):
        ins = [t for f, body in funcs.items() if f == name for _, t in body]
        fast = ins[:next((i for i, t in enumerate(ins) if t.strip().startswith("EXIT")),
                         len(ins))]
        out[key] = _fp64_count(fast)
        out[f"{key}_mufu"] = sum("MUFU.RCP64H" in t for t in fast)
    return out


def _cascade_sass(funcs, kernel):
    """The innermost loop of ``kernel`` that holds the cascade (its four
    divisions' ``MUFU.RCP64H``): FP64 instructions per pair, pairs in the
    body; None if not found."""
    for name, ins in funcs.items():
        if kernel not in name:
            continue
        loops = _loops(ins, lambda body: sum("MUFU.RCP64H" in t for t in body) // 4)
        if not loops:
            return None
        lo, hi = min(loops)[2:]
        body = [t for a, t in ins if lo <= a <= hi]
        pairs = sum("MUFU.RCP64H" in t for t in body) // 4
        return {"fp64_per_pair": _fp64_count(body) / pairs, "pairs_in_body": pairs,
                "instructions_per_pair": len(body) / pairs}
    return None


def _k5_sass(funcs):
    """K5's innermost loops: for those that hold the cascade (pairs counted
    by its five IEEE divisions, one ``MUFU.RCP`` each) {instructions a pair,
    pairs in the body, shuffles in the body}; for the others that hold
    ``FMNMX`` (the box tests: six a box) {instructions a box, boxes in the
    body}."""
    out = {"cascade": [], "boxes": []}
    for name, ins in funcs.items():
        if "surface_distances_kernel" not in name:
            continue
        loops = _loops(ins, lambda b: len(b))
        for body, _, lo, hi in loops:
            if any(lo < x[2] and x[3] <= hi for x in loops):
                continue  # an enclosing loop: its inner loops are counted on their own
            text = [t for a, t in ins if lo <= a <= hi]
            pairs = sum("MUFU.RCP" in t for t in text) / 5
            boxes = sum("FMNMX" in t for t in text) / 6
            if pairs:
                out["cascade"].append({"per_pair": body / pairs, "pairs_in_body": pairs,
                                       "shuffles": sum("SHFL" in t for t in text)})
            elif boxes:
                out["boxes"].append({"per_box": body / boxes, "boxes_in_body": boxes})
    return out


def _k5_times(torch, dev, face, evaluator):
    """K5 culled at the BFM shapes (``--k5``) → ({name@chains: [ms, ...]},
    {name@chains: shares of pairs visited and cascades run})."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp
    from icp_proposal_tpu_torch.sampling.state import init_state, transformed_points

    model, ctx = face.model, evaluator.ctx
    rng = np.random.RandomState(1)
    times, shares = {}, {}
    for b in CHAINS:
        state = init_state(model, b)
        state = state._replace(coeffs=torch.as_tensor(
            rng.randn(b, model.rank).astype(np.float32) * 0.5, device=dev))
        pts = transformed_points(model, state).contiguous()
        spec = evaluator.specs[0]
        if hasattr(spec, "n_points"):  # a seeded subset each way, as chip_smoke.py
            ids_m = torch.as_tensor(evaluator.model_ids(spec.name), dtype=torch.int64,
                                    device=dev)
            ids_t = torch.as_tensor(evaluator.target_ids(spec.name), dtype=torch.int64,
                                    device=dev)
        else:  # the Hausdorff term: every vertex each way
            ids_m = torch.arange(model.num_points, device=dev)
            ids_t = torch.arange(len(ctx.points), device=dev)
        cases = {"shared": (pts[:, ids_m].contiguous(), ctx.points, ctx.cells.int()),
                 "per_chain": (ctx.points[ids_t].contiguous(), pts, model.cells.int())}
        for mode, args in cases.items():
            got = cp.surface_distances(*args)
            wants = [cp.surface_distances(*args, cull=False)]
            if b == CHAINS[0]:
                wants.append(cp.surface_distances_plain(*args))
            for want in wants:
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K5 {mode} at {b} chains differs from the dense "
                                         "scan or the plain twin")
            for n in (3, 2):  # a checkout from before the cascade count has two
                visits = torch.zeros(n, dtype=torch.int64, device=dev)
                try:
                    cp.surface_distances(*args, visits=visits)
                    break
                except ValueError:
                    continue
            counts = visits.tolist()
            p, f = args[0].shape[-2], args[2].shape[0]
            key = f"surface_distances[{mode}]@{b}"
            shares[key] = {"tiles": counts[0] / (b * p * -(-f // cp.TILE_FACES)),
                           "pairs": counts[1] / (b * p * f),
                           "cascades": counts[2] / (b * p * f) if n == 3 else None}
            times[key] = [_time_ms(torch, lambda: cp.surface_distances(*args), K5_REPS)
                          for _ in range(TURNS)]
        del pts
    return times, shares


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


def _index_shapes(torch, dev, index):
    """{name: (queries, tri)} float64 on the card: the femur target's index,
    every 8th vertex of the open patches of subdivision 5 and 6 against all
    their faces, and all the subdivision-6 patch's vertices; and the
    subdivision-6 patch's (points, cells)."""
    import numpy as np

    from icp_proposal_tpu_torch.models.synthetic import make_open_patch

    shapes = {"femur": (index.points.double(), index.tri.reshape(-1, 9).double())}
    patch6 = None
    for s in (5, 6):
        points, cells = make_open_patch(s, 0.1, 0.55)
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        ptri = pts[torch.as_tensor(np.asarray(cells), dtype=torch.int64, device=dev)]
        shapes[f"patch{s}"] = (pts[::8].double().contiguous(), ptri.reshape(-1, 9).double())
        patch6 = (points, cells)
    return shapes, patch6


# (shape, K) of K9 in the index timings
INDEX_CASES = (("femur", 64), ("patch5", 64), ("patch5", 1024), ("patch6", 64))


def _index_times(torch, dev, shapes, patch6):
    """K9 and K10 at the index build's shapes (each held to its twin at the
    femur shape first), and whole subdivision-6 index builds → {name:
    [ms, ...]} (the builds in host-clock ms)."""
    from icp_proposal_tpu_torch import native
    from icp_proposal_tpu_torch.ops.surface_index import build_surface_index

    q, tri = shapes["femur"]
    for got, want in zip(native.shortlist_topk(q, tri, 64),
                         native.shortlist_topk_plain(q, tri, 64)):
        if not torch.equal(got, want):
            raise AssertionError("K9 differs from the plain twin at the femur target")
    if not torch.equal(native.point_tri_d2(q, tri), native.point_tri_d2_plain(q, tri)):
        raise AssertionError("K10 differs from the plain twin at the femur shape")
    fns = {f"shortlist_topk[{name}, K={k}]":
           (lambda name=name, k=k: native.shortlist_topk(*shapes[name], k))
           for name, k in INDEX_CASES}
    fns["point_tri_d2[femur]"] = lambda: native.point_tri_d2(q, tri)
    out = {name: [_time_ms(torch, fn, REPS) for _ in range(TURNS)] for name, fn in fns.items()}
    points, cells = patch6
    build_surface_index(points, cells, k=64, device=dev)
    builds = []
    for _ in range(TURNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        build_surface_index(points, cells, k=64, device=dev)
        torch.cuda.synchronize()
        builds.append(1e3 * (time.perf_counter() - t))
    out["build_surface_index[patch6, K=64]"] = builds
    return out


def streamed_bytes(r, b):
    """Bytes the streamed K6's schedule (this checkout's ``chol_cuda``) moves
    for b chains at rank r: M's lower triangle and the right-hand side in,
    L (zeros above the diagonal too), x and log det out, each finished
    panel's rows written to the workspace and read again by the update
    (each row tile's rows that exist, and the panel's rows once per tile),
    and the back substitution's read of L's lower triangle → {name: bytes};
    None for a checkout without the row tiles."""
    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    if not hasattr(cc, "streamed_row_tiles"):
        return None
    a_rows = b_rows = ws_rows = 0
    for j0 in range(0, r, cc.PANEL):
        w = min(cc.PANEL, r - j0)
        tiles = cc.streamed_row_tiles(r + 1 - j0)
        a_rows += sum(min(h, r + 1 - j0 - p0) for p0, h in tiles) * j0
        b_rows += len(tiles) * w * j0
        ws_rows += (r + 1 - j0) * w
    tri = r * (r + 1) // 2
    return {k: 4 * b * v for k, v in {
        "in_out": tri + r + r * r + r + 1, "workspace_out": ws_rows,
        "rereads_tile_rows": a_rows, "rereads_panel_rows": b_rows,
        "back_substitution": tri}.items()}


def _streamed_times(torch, dev):
    """The streamed K6 at ``STREAMED_CASES``, each held to the plain twin
    first → {"r=…@chains": {"ms": [...], ...}}."""
    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    out = {}
    for r, b, reps in STREAMED_CASES:
        gen = torch.Generator(device=dev).manual_seed(r + b)
        m = torch.empty(b, r, r, device=dev)
        for lo in range(0, b, 64):
            a = torch.randn(min(64, b - lo), r, 3 * r, generator=gen, device=dev) * 0.1
            m[lo:lo + 64] = a @ a.transpose(1, 2)
            del a
        m += torch.eye(r, device=dev)
        m[b // 2, r // 2, r // 2] = -1.0
        rhs = torch.randn(b, r, generator=gen, device=dev)
        got, want = cc.chol_solve_streamed(m, rhs), cc.chol_solve_plain(m, rhs)
        good = torch.arange(b, device=dev) != b // 2
        for g, w in zip(got, want):
            torch.testing.assert_close(g[good], w[good], rtol=1e-4, atol=1e-4)
        if not (torch.isnan(got[1][b // 2]).all() and torch.isnan(got[2][b // 2])):
            raise AssertionError(f"r={r}: a non-SPD pivot must give NaN")
        del want
        ms = [_time_ms(torch, lambda: cc.chol_solve_streamed(m, rhs), reps)
              for _ in range(TURNS)]
        n_bytes = streamed_bytes(r, b)
        tri = r * (r + 1) // 2
        io = 4 * b * (tri + r + r * r + r + 1)  # M's lower triangle, rhs in; L, x, log det out
        t_flops, t_io = b * r ** 3 / 3 / PEAK_FP32_FLOPS, io / PEAK_HBM_BYTES
        rec = {"ms": ms, "bound_ms": 1e3 * max(t_flops, t_io),
               "bound_by": "operations" if t_flops >= t_io else "bytes", "bytes": n_bytes}
        line = (f"[streamed] r={r} on {b} chains: {', '.join(f'{t:.4f}' for t in ms)} ms; "
                f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        if n_bytes:
            rec["design_bytes_ms"] = 1e3 * sum(n_bytes.values()) / PEAK_HBM_BYTES
            line += (f", the design's bytes {sum(n_bytes.values()) / 1e9:.3f} GB = "
                     f"{rec['design_bytes_ms']:.4f} ms")
        if hasattr(cc, "streamed_ctas_per_sm"):
            rec.update(ctas_per_sm=cc.streamed_ctas_per_sm(r),
                       smem_bytes=cc.streamed_smem_bytes(r), panel=cc.PANEL)
            line += f"; {rec['ctas_per_sm']} chains an SM, {rec['smem_bytes']} B shared"
        out[f"r={r}@{b}"] = rec
        print(line, flush=True)
        del m, rhs, got
        torch.cuda.empty_cache()
    return out


def _assembly_times(torch, dev, build_log):
    """The target assembly at ``ASSEMBLY_CASES``: kernel and twin in turns
    → {"r=…@chains": {...}}."""
    import chip_smoke
    from icp_proposal_tpu_torch.ops import assemble_cuda as ac

    regs = re.findall(r"Function properties for \S*target_assembly_kernel\S*\n(.*?)\n.*?"
                      r"Used (\d+) registers", build_log, re.S)
    sig = chip_smoke.ASSEMBLY_SIGMAS
    out = {}
    for r, m, b, reps in ASSEMBLY_CASES:
        v = 1622
        tables, ids, tp, nrm = chip_smoke.assembly_inputs(torch, dev, r, b, m, r, v)
        kernel = lambda: ac.target_assembly(tables, ids, tp, nrm, *sig)  # noqa: E731
        twin = lambda: ac.target_assembly_plain(tables, ids, tp, nrm, *sig)  # noqa: E731
        got, want = kernel(), twin()
        lower = torch.tril(torch.ones((r, r), dtype=torch.bool, device=dev))
        scale = torch.sqrt(torch.diagonal(want[0], dim1=1, dim2=2))
        rel = ((got[0] - want[0]).abs() / (scale[:, :, None] * scale[:, None, :]))[:, lower]
        del got, want
        ms = {"twin": [], "kernel": []}
        for name in ("twin", "kernel", "kernel", "twin"):
            ms[name].append(_time_ms(torch, {"twin": twin, "kernel": kernel}[name],
                                     reps if name == "kernel" else 2))
        flops = 2.0 * b * 3 * m * r * (r + 1) / 2
        n_bytes = 4.0 * (v * 3 * r + 8 * b * m + b * (r * (r + 1) / 2 + r))
        t_flops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_HBM_BYTES
        rec = {"ms": ms, "bound_ms": 1e3 * max(t_flops, t_bytes),
               "bound_by": "operations" if t_flops >= t_bytes else "bytes",
               "launch": ac.target_assembly_config(r, m),
               "max_err_over_diag_scale": float(rel.max()), "ptxas": regs}
        rec["roofline_pct"] = 100 * rec["bound_ms"] / min(ms["kernel"])
        out[f"r={r}@{b}"] = rec
        print(f"[assembly] r={r}, m={m} on {b} chains: kernel {ms['kernel']} ms, twin "
              f"{ms['twin']} ms; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"{rec['roofline_pct']:.1f} % of it; |kernel − twin| ≤ "
              f"{rec['max_err_over_diag_scale']:.3g}·√(MᵢᵢMⱼⱼ); launch {rec['launch']}",
              flush=True)
        del tables, ids, tp, nrm
        torch.cuda.empty_cache()
    return out


def _ablate(torch, dev):
    """The streamed K6 built from each of ``ABLATIONS`` → {"r=…@chains":
    {name: [ms, ms]}}, and each build's ptxas registers and spill bytes."""
    import ctypes

    from icp_proposal_tpu_torch import _build
    from icp_proposal_tpu_torch.ops import chol_cuda as cc

    src = (_build.CSRC / "chol.cu").read_text()
    nvcc, procs, libs, ptxas = _build.find_nvcc(), [], {}, {}
    for k, (name, edits) in enumerate(ABLATIONS):
        text = src
        for old, new in edits:
            if old not in text:
                raise AssertionError(f"ablation {name!r}: {old!r} is not in chol.cu")
            text = text.replace(old, new)
        work = _build.BUILD_DIR.parent / "ablate" / str(k)
        work.mkdir(parents=True, exist_ok=True)
        (work / "chol.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(work / "libchol.so"),
               str(work / "chol.cu")]
        procs.append((name, work, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, work, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {name!r} failed to build:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "chol_solve_streamed_kernel" in line:
                ptxas[name] = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
        lib = ctypes.CDLL(str(work / "libchol.so"))
        lib.icp_chol_solve_streamed.argtypes = [P, P, P, P, P, P, I, I, P]
        lib.icp_chol_streamed_ws_floats.argtypes = [I]
        libs[name] = lib
    out = {}
    for r, b, reps in STREAMED_CASES[:2]:
        gen = torch.Generator(device=dev).manual_seed(r + b)
        m = torch.empty(b, r, r, device=dev)
        for lo in range(0, b, 64):
            a = torch.randn(min(64, b - lo), r, 3 * r, generator=gen, device=dev) * 0.1
            m[lo:lo + 64] = a @ a.transpose(1, 2)
            del a
        m += torch.eye(r, device=dev)
        rhs = torch.randn(b, r, generator=gen, device=dev)
        want = cc.chol_solve_plain(m, rhs)
        l, x, ld = torch.empty_like(m), torch.empty_like(rhs), torch.empty(b, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        times = {name: [] for name, _ in ABLATIONS}
        names = [name for name, _ in ABLATIONS]
        for name in names + names[::-1]:
            lib = libs[name]
            ws = torch.empty(b * lib.icp_chol_streamed_ws_floats(r), device=dev)

            def call(lib=lib, ws=ws):
                if lib.icp_chol_solve_streamed(m.data_ptr(), rhs.data_ptr(), l.data_ptr(),
                                               x.data_ptr(), ld.data_ptr(), ws.data_ptr(), b,
                                               r, stream):
                    raise RuntimeError(f"ablation {name!r}: launch failed")

            call()
            if not name.startswith("no "):
                torch.cuda.synchronize()
                for got, w in zip((l, x, ld), want):
                    torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-4)
            times[name].append(_time_ms(torch, call, reps))
            del ws
        out[f"r={r}@{b}"] = times
        for name in names:
            print(f"[ablate] r={r} on {b} chains, {name}: "
                  f"{', '.join(f'{t:.4f}' for t in times[name])} ms; {ptxas.get(name)}",
                  flush=True)
        del m, rhs, want, l, x
        torch.cuda.empty_cache()
    return {"times": out, "ptxas": ptxas}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--contexts", action="store_true")
    ap.add_argument("--streamed", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--k5", action="store_true")
    ap.add_argument("--assembly", action="store_true")
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
    lib_path, build_log = _build.build_library()
    if args.k5:
        face = load_synthetic_face_data(rank=200, subdiv=4, device=dev)
        evaluator = make_bfm_fitting_setup(face, partial=True)[2]
        times, shares = _k5_times(torch, dev, face, evaluator)
        funcs = _sass_functions(lib_path, _build.find_nvcc()) if args.sass else None
        regs = re.findall(r"Function properties for \S*surface_distances_kernel\S*\n.*?"
                          r"Used (\d+) registers", build_log, re.S)
        print(json.dumps({"root": str(root), "device": smi.splitlines()[0], "times": times,
                          "shares": shares, "sass": _k5_sass(funcs) if funcs else None,
                          "registers": regs[:1] or None}))
        return 0
    if args.assembly:
        print(json.dumps({"root": str(root), "device": smi.splitlines()[0],
                          "assembly": _assembly_times(torch, dev, build_log)}))
        return 0
    if args.streamed or args.ablate:
        print(json.dumps({"root": str(root), "device": smi.splitlines()[0],
                          "streamed": _streamed_times(torch, dev) if args.streamed else None,
                          "ablate": _ablate(torch, dev) if args.ablate else None}))
        return 0
    data = load_standin_femur_data(device=dev)
    ctx = make_icp_proposal_setup(data)[0]
    index = ctx.index
    va = make_icp_proposal_setup(data, coarse="dot")[0].index.points_aug
    face = load_synthetic_face_data(rank=200, subdiv=4, device=dev)
    bindex = make_bfm_fitting_setup(face, partial=True)[0].index
    if args.contexts:
        from icp_proposal_tpu_torch import native

        index_ms = {}
        if hasattr(native, "shortlist_topk"):
            index_ms = _index_times(torch, dev, *_index_shapes(torch, dev, index))
        print(json.dumps({"root": str(root), "device": smi.splitlines()[0],
                          "contexts": _context_times(torch, dev, data, face),
                          "index_ms": index_ms}))
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
        sass["shortlist_topk"] = _cascade_sass(funcs, "shortlist_topk_kernel")
        sass["point_tri_d2"] = _cascade_sass(funcs, "point_tri_d2_kernel")
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
            sass["division"] = _division_sass(_build.find_nvcc(), work)
    print(json.dumps({"root": str(root), "device": smi.splitlines()[0], "times": times,
                      "sass": sass, "probe": probe}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
