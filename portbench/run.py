"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m portbench`` is the same.)  One process: the cell's inputs
from its configuration, the port's set-up, a warm-up of the cell's own
shapes, then ``--seconds`` of MH steps, each fed noise drawn from
``--seed`` on the card.  With ``--trace 1`` a stretch of about a second
inside the window runs under ``torch.profiler`` tracing device activity
alone, and the per-layer metrics are read from it; a shorter stretch
traced with the host's operations names the idle gaps of ``breakdown``.
After the window the reference judges a sample of the window's
chain-steps (``check.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted`` (chain-steps in the
window), ``failed`` (those with a non-finite candidate log posterior),
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each compared number beside its limit; the same numbers are the
last lines of standard error.
"""
from __future__ import annotations

import time

START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, flops, trace  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402
from portbench.manifest import ROOT, Manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "icp_proposal_tpu")
TRACE_TARGET_S = 1.0  # length of the traced stretch
TRACE_WARMUP_STEPS = 5  # steps under a profiler before each traced stretch
GIB = 2 ** 30


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Noise:
    """Every draw of a run from one generator seeded with ``--seed``: the
    chains' starting coefficients, then each step's z [B, C, r], component
    (by the mixture's weights) and log u."""

    def __init__(self, seed: int, device, chains: int, rank: int, weights,
                 init_scale: float):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.b, self.r = device, chains, rank
        w = torch.as_tensor(np.asarray(weights, np.float64) / np.sum(weights))
        self.cum = torch.cumsum(w, 0).to(torch.float32).to(device)
        self.c = len(weights)
        self.init = init_scale * torch.randn((chains, rank), generator=self.gen,
                                             device=device)

    def draw(self):
        z = torch.randn((self.b, self.c, self.r), generator=self.gen, device=self.device)
        u = torch.rand(self.b, generator=self.gen, device=self.device)
        idx = torch.searchsorted(self.cum, u, right=True).clamp_max(self.c - 1)
        log_u = torch.log(torch.rand(self.b, generator=self.gen, device=self.device))
        return z, idx, log_u


class Recorder:
    """Every step's record of the sampled chains, gathered once a segment
    on the device, and the window's counts of accepts and non-finite
    candidate log posteriors."""

    FIELDS = ("accepted", "log_product", "log_alpha", "coeffs", "pose")

    def __init__(self, rows: torch.Tensor, segment: int, device):
        self.rows, self.segment = rows, segment
        self.seg, self.parts = [], {k: [] for k in self.FIELDS}
        self.accepts = torch.zeros((), dtype=torch.int64, device=device)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, rec):
        self.seg.append(rec)
        if len(self.seg) >= self.segment:
            self.flush()

    def flush(self):
        if not self.seg:
            return
        stacked = {k: torch.stack([getattr(r, k) for r in self.seg]) for k in self.FIELDS}
        self.accepts += stacked["accepted"].sum()
        self.nonfinite += (~torch.isfinite(stacked["log_product"])).sum()
        for k, v in stacked.items():
            self.parts[k].append(v[:, self.rows])
        self.seg = []

    def reset_counts(self):
        self.accepts.zero_()
        self.nonfinite.zero_()

    def history(self) -> dict:
        return {k: torch.cat(v) for k, v in self.parts.items()}


class Marks:
    """Step ends: CUDA events recorded on the stream (no synchronize), or
    the host clock on the CPU, where every step is synchronous."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> np.ndarray:
        if self.cuda:
            return np.asarray([a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])])
        return 1e3 * np.diff(np.asarray(self.marks))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def smi_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def run_cell(man: Manifest, cell: dict, seed: int, seconds: float, traced: bool,
             device, start: float, wrap_step=None, system_class=None,
             max_steps: int | None = None, cache: dict | None = None) -> tuple[dict, list]:
    """One run of ``cell`` → (result object, lines for standard error).

    ``wrap_step``: a function of the system's step returning the step the
    window drives (a fault planted by the tests); ``system_class``: the
    system under test (default the port's, ``system.System``; the control
    puts the reference there); ``max_steps`` ends the window after that
    many steps; ``cache`` keeps the inputs and the system between runs of
    one process (the readings of many seeds)."""
    from portbench.reference.sampler import Reference, State
    from portbench.system import System

    config = man.config(cell["config"])
    b, r = int(cell["chains"]), int(config["rank"])
    cache = {} if cache is None else cache
    if "system" not in cache:
        cache["inputs"] = make_inputs(config, device)
        cache["system"] = (system_class or System)(cache["inputs"], config, cell, device)
    inputs, system = cache["inputs"], cache["system"]
    step = system.step if wrap_step is None else wrap_step(system.step)
    weights = [c["weight"] for c in cell["mixture"]]
    noise = Noise(seed, device, b, r, weights, math.sqrt(float(cell["init_variance"])))
    center = np.asarray(inputs["ref_points"], np.float32).mean(axis=0)
    init = {"scale": torch.ones(b, device=device),
            "rot": torch.zeros((b, 3), device=device),
            "trans": torch.zeros((b, 3), device=device),
            "center": torch.as_tensor(center, device=device).expand(b, 3).clone(),
            "coeffs": noise.init.clone()}
    carry = system.init_carry(init)
    chk = cell["check"]
    pick = torch.Generator().manual_seed(seed)
    rows = torch.randperm(b, generator=pick)[: int(chk["chains"])].sort().values
    rec = Recorder(rows.to(device), int(cell["segment_steps"]), device)

    def one(carry):
        z, idx, log_u = noise.draw()
        t = time.perf_counter()
        carry, out = step(carry, noise=system.noise(z, idx, log_u))
        return carry, out, time.perf_counter() - t

    for _ in range(int(cell["warmup_steps"])):  # the cell's own shapes, once built
        carry, out, _ = one(carry)
        rec.add(out)
    rec.flush()
    _sync(device)
    rec.reset_counts()
    warm = int(cell["warmup_steps"])

    marks = Marks(device)
    marks.mark()
    t0 = time.perf_counter()
    setup_s = time.monotonic() - start
    steps, host, prof_info = 0, [], None

    def advance(carry, n):
        for _ in range(n):
            carry, out, _ = one(carry)
            marks.mark()
            rec.add(out)
        return carry

    def events_of(prof):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]

    while True:
        if traced and prof_info is None and steps >= 3 and (
                time.perf_counter() - t0 >= min(2.0, 0.3 * seconds)):
            per = (time.perf_counter() - t0) / steps
            n_trace = int(min(200, max(5, math.ceil(TRACE_TARGET_S / per))))
            n_gaps = max(3, n_trace // 4)
            q0, q_steps = time.perf_counter(), steps
            device_only = [torch.profiler.ProfilerActivity.CUDA]
            # the profiler's start-up and its first steps stay outside the stretch
            with torch.profiler.profile(activities=device_only):
                carry = advance(carry, TRACE_WARMUP_STEPS)
                _sync(device)
            # the stretch: device activity alone, so the host runs as untraced;
            # it begins and ends synchronized, so every device op in it is its own
            prof = torch.profiler.profile(activities=device_only)
            prof.start()
            p0 = time.perf_counter()
            carry = advance(carry, n_trace)
            _sync(device)
            traced_s = time.perf_counter() - p0
            prof.stop()
            ops = trace.device_ops(events_of(prof))
            # a shorter stretch with the host's operations, only to name idle gaps
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            carry = advance(carry, TRACE_WARMUP_STEPS)
            _sync(device)
            with torch.profiler.record_function(trace.WINDOW):
                carry = advance(carry, n_gaps)
                _sync(device)
            prof.stop()
            _, _, gaps = trace.reduce_events(events_of(prof))
            del prof
            steps += 2 * TRACE_WARMUP_STEPS + n_trace + n_gaps
            prof_info = (ops, gaps, traced_s, n_trace, time.perf_counter() - q0,
                         steps - q_steps)
            continue
        carry, out, h = one(carry)
        marks.mark()
        rec.add(out)
        steps += 1
        host.append(h)
        if (time.perf_counter() - t0 >= seconds
                or (max_steps is not None and steps >= max_steps)):
            break
    rec.flush()
    _sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    accepts, nonfinite = int(rec.accepts), int(rec.nonfinite)
    hist = rec.history()
    del carry, out, system, step, rec, cache

    result = {"correct": False, "attempted": b * steps, "failed": nonfinite,
              "metrics": {}, "device": device_line(device, peak)}
    lines = [f"[portbench] {cell['name']} seed {seed}: {steps} steps of {b} chains in "
             f"{wall:.6f} s after {setup_s:.6f} s of set-up; acceptance "
             f"{accepts / max(1, b * steps):.6f}; card {result['device']['kind']}, "
             f"nvidia-smi {result['device']['power']}"]
    if not traced:
        ms = marks.intervals_ms()
        values = {"samples_per_s": b * steps / wall,
                  "step_ms_p95": float(np.percentile(ms, 95)),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in man.metrics_for(cell["name"], "end_to_end"):
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ops, gaps, traced_s, traced_steps, profiled_s, profiled_steps = prof_info
        view = trace.TraceView(
            ops=ops, window_s=traced_s, steps=traced_steps,
            host_s_per_step=float(np.mean(host)),
            step_s=(wall - profiled_s) / max(1, steps - profiled_steps), cell=cell,
            config=config, step_flops=flops.step_flops(cell, config),
            library_kernels=trace.library_kernel_names(
                man.root / "icp_proposal_tpu_torch" / "csrc"))
        for m in man.metrics_for(cell["name"], "per_layer"):
            value = man.reader(m["name"])(view)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = view.busy_s()
        result["device"]["window_s"] = traced_s
        lines.append(f"[portbench] traced stretch: {traced_steps} steps in {traced_s:.6f} s "
                     f"under the profiler (device activity only), {view.step_s:.6f} s a "
                     "step outside it")
        result["breakdown"] = {
            "device_ops": trace.top((n, e - s) for n, s, e in ops),
            "idle_gaps": trace.top(gaps)}

    # the reference judges a sample of the window's chain-steps
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    total = hist["accepted"].shape[0]
    n_rows = rows.shape[0]
    replay = Noise(seed, device, b, r, weights, math.sqrt(float(cell["init_variance"])))
    zs, idxs, logus = [], [], []
    for _ in range(total):
        z, idx, log_u = replay.draw()
        zs.append(z[rows.to(device)])
        idxs.append(idx[rows.to(device)])
        logus.append(log_u[rows.to(device)])
    nz = {"z": torch.stack(zs), "idx": torch.stack(idxs), "log_u": torch.stack(logus)}
    cand_t = torch.arange(warm, total).repeat_interleave(n_rows)
    cand_j = torch.arange(n_rows).repeat(total - warm)
    sel = torch.randperm(len(cand_t), generator=pick)[: int(chk["pairs"])]
    ref = Reference(inputs, {**cell, "index_k": config["index_k"]}, device)
    init_rows = State(**{k: v[rows.to(device)] for k, v in init.items()})
    numbers = check.judge(ref, init_rows, hist, nz, (cand_t[sel], cand_j[sel]), chk,
                          int(chk["batch"]))
    ok, rows_out = check.verdict(numbers, chk["limits"])
    result["correct"] = bool(ok)
    lines.append(f"[portbench] reference judged {numbers['diag']['pairs']} chain-steps of "
                 f"{n_rows} chains in {time.perf_counter() - t_ref:.3f} s; "
                 f"{json.dumps(numbers['diag'])}")
    for name, row in rows_out.items():
        lines.append(f"check {name} {row['value']!r} limit {row['limit']!r}")
    result["check"] = rows_out
    return result, lines


def device_line(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak,
                "power": "not read"}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak), "power": smi_power_limit()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    man = Manifest(ROOT)
    cell = man.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 3
    build = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    # one host thread: the set-up's host work on a shared machine runs
    # faster and steadier so, and the window launches from one thread anyway
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(0, device=device)  # the device's allocator exists from here
    torch.cuda.reset_peak_memory_stats(device)
    result, lines = run_cell(man, cell, args.seed, args.seconds, bool(args.trace),
                             device, START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; the port may load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
