"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line or a short block, and ends in
``torch.cuda.synchronize()`` so a fault shows where it happened):

1. device   the card, torch/CUDA/nvcc versions, name and power limit;
2. build    nvcc builds every kernel in icp_proposal_tpu_torch/csrc into build/;
3. kernels  K1–K4 against their plain PyTorch twins on the card at the main
            path's per-chain shapes on 256 chains, with times;
4. main     the stand-in femur GPMM-100 (rank 101) flagship ICP-proposal MH
            step at 2,048 chains through the kernels: warm-up, then timed
            steps, with each kernel's launch count;
5. check    8 chains stepped on the card and on the CPU (plain twins) from
            the same carry with the same noise must agree.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  Without a
CUDA device it exits non-zero before doing anything.
"""
import json
import subprocess
import sys
import time

N_CHAINS = 2048
WARMUP_STEPS = 3
TIMED_STEPS = 20
CMP_CHAINS = 256
KERNEL_REPS = 20
STEP_LAUNCHES = {"chol_solve": 2, "tri_solve_lt": 2, "nearest_vertices[shared]": 1,
                 "nearest_vertices[per_chain]": 1, "refine_shortlist": 1}
TOL = 1e-4  # K1/K2 values: rtol and atol; K3/K4 ids and corners: exact


def _sync(torch):
    torch.cuda.synchronize()


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps=KERNEL_REPS):
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync(torch)
    return start.elapsed_time(end) / reps


def _paired_times(torch, kernel, plain):
    """plain, kernel, kernel, plain in turns → (kernel ms, plain ms)."""
    p1 = _time_ms(torch, plain)
    k1 = _time_ms(torch, kernel)
    k2 = _time_ms(torch, kernel)
    p2 = _time_ms(torch, plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _id_errors(ids, ids_p):
    """(max |id − id_plain| as a float, number of ids that differ)."""
    diff = (ids.long() - ids_p.long()).abs()
    return float(diff.max()), int((diff != 0).sum())


def phase_kernels(torch, dev, data, ctx):
    """K1–K4 against the plain twins; returns the per-kernel records."""
    import numpy as np

    from icp_proposal_tpu_torch.ops import chol_cuda as cc
    from icp_proposal_tpu_torch.ops import closest_point_cuda as cp

    rng = np.random.RandomState(0)
    b, r, v = CMP_CHAINS, data.model.rank, data.model.num_points
    records = {}

    # K1 / K2: SPD systems like M = I + QᵀPQ, one chain deliberately not SPD
    a = torch.as_tensor(rng.randn(b, r, 3 * r).astype(np.float32) * 0.1, device=dev)
    m = (a @ a.transpose(1, 2) + torch.eye(r, device=dev)).contiguous()
    bad = b // 2
    m[bad, r // 2, r // 2] = -1.0
    rhs = torch.as_tensor(rng.randn(b, r).astype(np.float32), device=dev)
    l, x, ld = cc.chol_solve(m, rhs)
    l_p, x_p, ld_p = cc.chol_solve_plain(m, rhs)
    _sync(torch)
    good = torch.arange(b, device=dev) != bad
    for got, want in ((l, l_p), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[good], want[good], rtol=TOL, atol=TOL)
    if not (torch.isnan(x[bad]).all() and torch.isnan(ld[bad])):
        raise AssertionError("K1: a non-SPD pivot must give NaN")
    err = max(float((g[good] - w[good]).abs().max())
              for g, w in ((l, l_p), (x, x_p), (ld, ld_p)))
    records["chol_solve"] = (err, 0, *_paired_times(
        torch, lambda: cc.chol_solve(m, rhs), lambda: cc.chol_solve_plain(m, rhs)))

    lg = l[good].contiguous()
    z = torch.as_tensor(rng.randn(b - 1, r).astype(np.float32), device=dev)
    xt, xt_p = cc.tri_solve_lt(lg, z), cc.tri_solve_lt_plain(lg, z)
    _sync(torch)
    torch.testing.assert_close(xt, xt_p, rtol=TOL, atol=TOL)
    records["tri_solve_lt"] = (float((xt - xt_p).abs().max()), 0, *_paired_times(
        torch, lambda: cc.tri_solve_lt(lg, z), lambda: cc.tri_solve_lt_plain(lg, z)))

    # K3: shared target vertices (P = 4·rank) and per-chain meshes (P = 2·rank)
    ref = data.model.ref_points
    q = (ref[torch.as_tensor(rng.randint(0, v, (b, 4 * r)), device=dev)]
         + torch.as_tensor(rng.randn(b, 4 * r, 3).astype(np.float32) * 0.5,
                           device=dev)).contiguous()
    pts_b = (ref[None] + torch.as_tensor(rng.randn(b, 1, 3).astype(np.float32),
                                         device=dev)).contiguous()
    tq = ctx.points[:2 * r].expand(b, -1, -1).contiguous()
    for mode, (qq, pts) in (("shared", (q, ctx.index.points)),
                            ("per_chain", (tq, pts_b))):
        ids, ids_p = cp.nearest_vertices(qq, pts), cp.nearest_vertices_plain(qq, pts)
        _sync(torch)
        records[f"nearest_vertices[{mode}]"] = (
            *_id_errors(ids, ids_p), *_paired_times(
                torch, lambda: cp.nearest_vertices(qq, pts),
                lambda: cp.nearest_vertices_plain(qq, pts)))
    nv = cp.nearest_vertices(q, ctx.index.points)

    # K4: the K = 64 shortlist of each query's coarse vertex
    idx = ctx.index
    f, w = cp.refine_shortlist(q, nv, idx.cand, idx.cand_tri)
    f_p, w_p = cp.refine_shortlist_plain(q, nv, idx.cand, idx.cand_tri)
    _sync(torch)
    err, mism = _id_errors(f, f_p)
    records["refine_shortlist"] = (
        max(err, float((w - w_p).abs().max())), mism, *_paired_times(
            torch, lambda: cp.refine_shortlist(q, nv, idx.cand, idx.cand_tri),
            lambda: cp.refine_shortlist_plain(q, nv, idx.cand, idx.cand_tri)))
    for name, (err, mism, k_ms, p_ms) in records.items():
        tol = TOL if name in ("chol_solve", "tri_solve_lt") else 0
        print(f"[kernels] {name}: max_abs_err {err:.3g} (tolerance {tol}), "
              f"{mism} ids differ, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"{CMP_CHAINS} chains")
        if mism or (not tol and err):  # K1/K2 values were held to TOL above
            raise AssertionError(f"{name}: the kernel disagrees with its plain twin")
    return records


def _to_device(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(x, dev) for x in obj))
    if isinstance(obj, tuple):
        return tuple(_to_device(x, dev) for x in obj)
    return obj


def phase_check(torch, dev, data, setup):
    """8 chains, one step on the card and one on the CPU from the same carry
    with the same noise: same decisions (away from near-ties), same log
    posterior to rtol 1e-4."""
    from icp_proposal_tpu_torch.apps.femur import FemurData, make_icp_proposal_setup
    from icp_proposal_tpu_torch.convert import gpmm_from_arrays
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    ctx, mixture, evaluator = setup
    model = data.model
    cpu_model = gpmm_from_arrays(**{k: getattr(model, k).cpu().numpy()
                                    for k in model.__dataclass_fields__})
    cpu_data = FemurData(cpu_model, data.target, data.target_boundary_mask,
                         data.model_boundary_mask)
    cpu_setup = make_icp_proposal_setup(cpu_data)
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    cpu_step = mh.make_mh_step(cpu_model, cpu_setup[1], cpu_setup[2], store_params=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    carry = mh.init_carry(model, evaluator, init_state(model, 8), mixture)
    carry, _ = mh.run_chains(step, carry, 4, gen)  # chains drift apart
    compared = 0
    for _ in range(3):
        noise = mh.draw_noise(mixture, 8, gen)
        nxt, rec = step(carry, noise)
        _, rec_c = cpu_step(_to_device(carry, "cpu"), _to_device(noise, "cpu"))
        _sync(torch)
        rec = _to_device(rec, "cpu")
        if not torch.equal(rec.proposal_idx, rec_c.proposal_idx):
            raise AssertionError("check: proposal indices differ")
        clear = (rec.log_alpha - noise.log_u.cpu()).abs() > 1e-3
        if not torch.equal(rec.accepted[clear], rec_c.accepted[clear]):
            raise AssertionError("check: accept decisions differ from the CPU run")
        torch.testing.assert_close(rec.log_product, rec_c.log_product, rtol=1e-4,
                                   atol=0)
        compared += int(clear.sum())
        carry = nxt
    print(f"[check] card vs CPU plain twins, 8 chains x 3 steps: {compared} decisions "
          f"identical, log posterior within rtol 1e-4")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi()

    # 1. device
    from icp_proposal_tpu_torch import _build

    nvcc = _build.find_nvcc()
    nvcc_line = "missing"
    if nvcc:
        nvcc_line = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                   timeout=60).stdout.strip().splitlines()[-1]
    print(f"[device] {kind} x{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvcc: {nvcc_line}; python {sys.version.split()[0]}")
    print(f"[device] nvidia-smi: {smi}")
    _sync(torch)

    # 2. build
    t = time.perf_counter()
    path, log = _build.build_library()
    _build.load_library()
    print(f"[build] {path.name} in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    _sync(torch)

    # the stand-in workload and the flagship setup, on the card
    from icp_proposal_tpu_torch.apps.femur import (
        load_standin_femur_data,
        make_icp_proposal_setup,
    )
    from icp_proposal_tpu_torch.ops import chol_cuda, closest_point_cuda
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import init_state

    t = time.perf_counter()
    data = load_standin_femur_data(device=dev)
    setup = make_icp_proposal_setup(data)
    ctx, mixture, evaluator = setup
    _sync(torch)
    print(f"[setup] stand-in femur GPMM-100: rank {data.model.rank}, "
          f"{data.model.num_points} vertices; K={ctx.index.k} index; "
          f"{time.perf_counter() - t:.1f} s")

    # 3. kernels against plain twins
    records = phase_kernels(torch, dev, data, ctx)
    _sync(torch)

    # 4. main path
    wrappers = {"chol_solve": chol_cuda.chol_solve, "tri_solve_lt": chol_cuda.tri_solve_lt,
                "nearest_vertices": closest_point_cuda.nearest_vertices,
                "refine_shortlist": closest_point_cuda.refine_shortlist}
    step = mh.make_mh_step(data.model, mixture, evaluator)
    gen = torch.Generator(device=dev).manual_seed(0)
    carry = mh.init_carry(data.model, evaluator, init_state(data.model, N_CHAINS),
                          mixture)
    carry, _ = mh.run_chains(step, carry, WARMUP_STEPS, gen)
    _sync(torch)
    for fn in wrappers.values():
        fn.launches = 0
    nv = closest_point_cuda.nearest_vertices
    nv.per_chain_launches = 0
    t = time.perf_counter()
    carry, recs = mh.run_chains(step, carry, TIMED_STEPS, gen)
    _sync(torch)
    dt = time.perf_counter() - t
    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches["nearest_vertices[per_chain]"] = nv.per_chain_launches
    launches["nearest_vertices[shared]"] = (launches.pop("nearest_vertices")
                                            - nv.per_chain_launches)
    acc = float(torch.stack([r.accepted for r in recs]).float().mean())
    rate = N_CHAINS * TIMED_STEPS / dt
    print(f"[main] {N_CHAINS} chains x {TIMED_STEPS} steps in {dt:.3f} s: "
          f"{rate:.1f} samples/s, {1e3 * dt / TIMED_STEPS:.2f} ms/step, "
          f"acceptance {acc:.4f}; launches {launches}")
    for name, per_step in STEP_LAUNCHES.items():
        if launches[name] != per_step * TIMED_STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches, expected "
                                 f"{per_step} per step")
    if not torch.isfinite(carry.log_post).all():
        raise AssertionError("non-finite log_post after the main path")
    print(f"[main] log_post finite; mean {float(carry.log_post.mean()):.3f}")

    # 5. check against the plain twins on the CPU
    phase_check(torch, dev, data, setup)
    _sync(torch)

    sources = {"chol_solve": ("csrc/chol.cu", "icp_proposal_tpu/ops/chol_pallas.py:74"),
               "tri_solve_lt": ("csrc/chol.cu", "icp_proposal_tpu/ops/chol_pallas.py:329"),
               "nearest_vertices[shared]": (
                   "csrc/closest_point.cu",
                   "icp_proposal_tpu/ops/closest_point_pallas.py:335"),
               "nearest_vertices[per_chain]": (
                   "csrc/closest_point.cu",
                   "icp_proposal_tpu/ops/closest_point_pallas.py:335"),
               "refine_shortlist": ("csrc/closest_point.cu",
                                    "icp_proposal_tpu/ops/closest_point_pallas.py:613")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"icp_proposal_tpu_torch/{sources[name][0]}",
                "replaces": sources[name][1], "launches": launches[name],
                "max_abs_err": err, "id_mismatches": mism, "ms": k_ms, "plain_ms": p_ms}
               for name, (err, mism, k_ms, p_ms) in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(f"[device] nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
