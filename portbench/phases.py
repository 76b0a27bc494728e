"""A cell's step and set-up split by the program's spans, on the card:

    python3 portbench/phases.py --workload <cell> --seed <n> [--seconds 2]

One process, as a benchmark run builds it: the imports, the cell's inputs
(``make_inputs``), the port's set-up under ``profiling.tracing()`` (the
``setup.*`` spans), the warm-up, each timed.  Then, on the cell's own
shapes:

1. a stretch traced with device activity alone, tracing off, as the
   benchmark's per-layer stretch: device ms a step, and the per-layer
   readers of ``portbench/metrics`` that name kernels;
2. a stretch traced with the host's operations, tracing on: self device
   ms a step of every span (``spans.reduce_spans``) and idle gaps by span;
3. one step from the same carry and noise with tracing off and on, each
   under a device-only profiler: the kernels launched, in order, and every
   tensor of carry and record must be the same;
4. windows of ``--seconds`` without a profiler, tracing off, on, off, on,
   each from the same carry with noise from ``--seed``: samples/s and host
   ms a step in ``step()``, the cost of the spans when on.

Standard error gets one line a span; the last line of standard output is
one JSON object with every number.
"""
from __future__ import annotations

import time

START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import flops, spans, trace  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402
from portbench.manifest import ROOT, Manifest  # noqa: E402
from portbench.run import (  # noqa: E402
    TRACE_WARMUP_STEPS,
    Noise,
    _sync,
    device_line,
    forbidden_modules,
)
from portbench.system import System  # noqa: E402

IMPORTED = time.monotonic()  # Python, numpy, torch and the benchmark imported

STRETCH_S = 1.0  # length of each traced stretch
KERNEL_READERS = ("library_ms_per_step", "index_ms_per_step", "factor_ms_per_step",
                  "dense_cp_ms_per_step")


def events_of(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def same_bits(a, b) -> bool:
    """Two nests of tuples hold the same tensors, bit for bit."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                                b.reshape(-1).contiguous().view(torch.uint8)))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(same_bits(x, y) for x, y in zip(a, b)))
    return a == b


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0,
                   help="length of each untraced window of the on/off comparison")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("phases: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # as a benchmark run
    device = torch.device("cuda", 0)
    t = time.monotonic()
    torch.cuda.init()
    torch.empty(0, device=device)
    cuda_s = time.monotonic() - t
    t = time.monotonic()
    import icp_proposal_tpu_torch.apps.bfm  # noqa: F401  (the port's imports, timed)
    import icp_proposal_tpu_torch.apps.femur  # noqa: F401
    port_s = time.monotonic() - t
    man = Manifest(ROOT)
    result, lines = measure(man, man.workload(args.workload), args.seed, args.seconds,
                            device, START)
    result["setup"].update(python_torch_s=IMPORTED - START, cuda_init_s=cuda_s,
                           port_import_s=port_s)
    lines.insert(2, f"[phases] imports: Python, numpy, torch, portbench "
                    f"{IMPORTED - START:.6f} s; CUDA context {cuda_s:.6f} s; the port "
                    f"{port_s:.6f} s")
    found = forbidden_modules()
    if found:
        print(f"phases: the process loaded {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0 if result["same_kernels_on_off"] and result["same_results_on_off"] else 1


def measure(man: Manifest, cell: dict, seed: int, seconds: float, device,
            start: float) -> tuple[dict, list]:
    """One cell's split → (result object, lines for standard error);
    ``start`` is the process's start, the imports done."""
    from icp_proposal_tpu_torch import _build
    from icp_proposal_tpu_torch.utils import profiling

    imports_s = time.monotonic() - start
    config = man.config(cell["config"])
    b, r = int(cell["chains"]), int(config["rank"])
    t = time.monotonic()
    inputs = make_inputs(config, device)
    _sync(device)
    inputs_s = time.monotonic() - t

    weights = [c["weight"] for c in cell["mixture"]]
    init_scale = math.sqrt(float(cell["init_variance"]))
    noise = Noise(seed, device, b, r, weights, init_scale)
    center = np.asarray(inputs["ref_points"], np.float32).mean(axis=0)
    init = {"scale": torch.ones(b, device=device),
            "rot": torch.zeros((b, 3), device=device),
            "trans": torch.zeros((b, 3), device=device),
            "center": torch.as_tensor(center, device=device).expand(b, 3).clone(),
            "coeffs": noise.init.clone()}
    t = time.monotonic()
    profiling.spans()
    with profiling.tracing():
        system = System(inputs, config, cell, device)
        carry = system.init_carry(init)
    _sync(device)
    system_s = time.monotonic() - t
    kept = profiling.spans()
    setup_spans = spans.setup_seconds(kept)
    nested = {f"{sp.name} in {sp.parent}": (sp.end_ns - sp.start_ns) * 1e-9
              for sp in kept if sp.parent is not None and sp.name.startswith("setup.")}

    def one(carry, noise):
        z, idx, log_u = noise.draw()
        h = time.perf_counter()
        carry, out = system.step(carry, noise=system.noise(z, idx, log_u))
        return carry, out, time.perf_counter() - h

    t = time.monotonic()
    for _ in range(int(cell["warmup_steps"])):
        carry, _, _ = one(carry, noise)
    _sync(device)
    warmup_s = time.monotonic() - t
    setup_s = time.monotonic() - start

    def advance(carry, n):
        for _ in range(n):
            carry, _, _ = one(carry, noise)
        return carry

    # the steps a stretch of about STRETCH_S takes
    t = time.perf_counter()
    carry = advance(carry, 3)
    _sync(device)
    per = (time.perf_counter() - t) / 3
    n = int(min(200, max(5, math.ceil(STRETCH_S / per))))
    cpu, cuda = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
    device_only = [cuda if device.type == "cuda" else cpu]  # the CPU: a rehearsal
    both = [cpu, cuda] if device.type == "cuda" else [cpu]

    # 1. device activity alone, tracing off
    with torch.profiler.profile(activities=device_only):
        carry = advance(carry, TRACE_WARMUP_STEPS)
        _sync(device)
    prof = torch.profiler.profile(activities=device_only)
    prof.start()
    t = time.perf_counter()
    carry = advance(carry, n)
    _sync(device)
    stretch_s = time.perf_counter() - t
    prof.stop()
    ops = trace.device_ops(events_of(prof))
    view = trace.TraceView(
        ops=ops, window_s=stretch_s, steps=n, host_s_per_step=0.0, step_s=stretch_s / n,
        cell=cell, config=config, step_flops=flops.step_flops(cell, config),
        library_kernels=trace.library_kernel_names(man.root / "icp_proposal_tpu_torch" / "csrc"))
    device_ms = 1e3 * sum(e - s for _, s, e in ops) / n
    kernels = {m: man.reader(m)(view) for m in KERNEL_READERS}

    # 2. the host's operations, tracing on
    prof = torch.profiler.profile(activities=both)
    with profiling.tracing():
        prof.start()
        carry = advance(carry, TRACE_WARMUP_STEPS)
        _sync(device)
        with torch.profiler.record_function(trace.WINDOW):
            carry = advance(carry, n)
            _sync(device)
        prof.stop()
    profiling.spans()
    by_span = spans.reduce_spans(events_of(prof))
    del prof
    split = by_span.per_step_ms(n)
    attributed_ms = 1e3 * by_span.total_s() / n
    gaps = trace.top(by_span.gaps, n=20)

    # 3. one step, off and on, from the same carry and noise
    z, idx, log_u = noise.draw()
    runs = {}
    for on in (False, True):
        with torch.profiler.profile(activities=device_only) as prof1:
            with profiling.tracing(on):
                runs[on] = system.step(carry, noise=system.noise(z, idx, log_u))
            _sync(device)
        runs[on] = (runs[on], [name for name, _, _ in trace.device_ops(events_of(prof1))])
    profiling.spans()
    same_kernels = runs[False][1] == runs[True][1]
    same_results = same_bits(runs[False][0], runs[True][0])
    del runs

    # 4. untraced windows, tracing off and on
    windows = {False: [], True: []}
    for on in (False, True, False, True):
        w_noise = Noise(seed, device, b, r, weights, init_scale)
        w_carry, steps, host = carry, 0, []
        with profiling.tracing(on):
            _sync(device)
            t = time.perf_counter()
            while time.perf_counter() - t < seconds:
                w_carry, _, h = one(w_carry, w_noise)
                host.append(h)
                steps += 1
            _sync(device)
            wall = time.perf_counter() - t
        profiling.spans()
        windows[on].append({"samples_per_s": b * steps / wall,
                            "host_ms_per_step": 1e3 * statistics.fmean(host),
                            "steps": steps})
    del w_carry

    compiled = device.type == "cuda" and _build.load_library().compiled
    result = {
        "cell": cell["name"], "seed": seed, "device": device_line(device, 0),
        "setup": {"setup_s": setup_s, "imports_s": imports_s, "inputs_s": inputs_s,
                  "system_s": system_s, "program_setup_s": sum(setup_spans.values()),
                  "spans_s": setup_spans, "nested_s": nested, "warmup_s": warmup_s,
                  "kernels_compiled": compiled},
        "steps": n, "device_only_ms_per_step": device_ms, "kernel_readers": kernels,
        "attributed_ms_per_step": attributed_ms,
        "outside_share": split.get(spans.OUTSIDE, [0.0])[0] / attributed_ms
        if attributed_ms else None,
        "spans": split, "idle_gaps_by_span": gaps,
        "same_kernels_on_off": same_kernels, "same_results_on_off": same_results,
        "windows_off": windows[False], "windows_on": windows[True],
    }
    lines = [f"[phases] {cell['name']} seed {seed}: {result['device']['kind']}, "
             f"nvidia-smi {result['device']['power']}",
             f"[phases] set-up {setup_s:.6f} s: before the inputs {imports_s:.6f}, inputs "
             f"{inputs_s:.6f}, system and carry {system_s:.6f} (spans "
             f"{result['setup']['program_setup_s']:.6f}), warm-up {warmup_s:.6f}; "
             f"kernels compiled: {compiled}"]
    lines += [f"[phases] setup span {k} {v:.6f} s"
              for k, v in [*setup_spans.items(), *nested.items()]]
    lines.append(f"[phases] {n} steps: device-only {device_ms:.6f} ms a step, by span "
                 f"{attributed_ms:.6f}; readers {json.dumps(kernels)}")
    lines += [f"[phases] span {k} {ms:.6f} ms a step, {n_ops:.2f} ops a step"
              for k, (ms, n_ops) in split.items()]
    lines += [f"[phases] idle gap ending in {k} {1e3 * s / n:.6f} ms a step"
              for k, s in gaps]
    lines.append(f"[phases] one step off/on: same kernels {same_kernels}, same results "
                 f"{same_results}")
    lines += [f"[phases] window tracing {'on' if on else 'off'}: {json.dumps(w)}"
              for on in (False, True) for w in windows[on]]
    return result, lines


if __name__ == "__main__":
    sys.exit(main())
