"""Posterior parity at femur scale: long runs of three samplers.

Counterpart of the repository's ``tools/posterior_parity.py``, on the
femur flagship target:

  * ``rw-only``    — the random-walk shape proposal alone.  Symmetric, hence
                     an exact MH sampler: its long-run moments are the
                     ground-truth posterior.
  * ``icp-exact``  — the flagship 0.9·ICP + 0.1·RW mixture with the exact
                     transition density (½·log det M and the relaxation
                     Jacobian kept): also exact.
  * ``icp-parity`` — the same mixture with the reference's transition
                     density (``NonRigidIcpProposal.scala:71-85``), which
                     omits both terms: a biased invariant distribution.

Each run accumulates the moments of the held chain state over the second
half in float64 on the host, estimates each coefficient mean's Monte-Carlo
standard error from the ESS of thinned traces, and the comparisons give
z-scores of the posterior means against the random walk's:

    python3 -m icp_proposal_tpu_torch.tools.posterior_parity [--components 50]
        [--chains 64] [--steps 50000] [--device cpu] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from icp_proposal_tpu_torch.tools import add_common_args, femur_data, surface_avg_dist, write_json
from icp_proposal_tpu_torch.tools.mixing_sweep import FLAGSHIP, start_chains

RUNS = (("rw-only", dict(FLAGSHIP, icp_weight=0.0)),
        ("icp-exact", dict(FLAGSHIP)),
        ("icp-parity", dict(FLAGSHIP, parity=True)))


def np_ess(trace: np.ndarray, max_lag: int = 500) -> np.ndarray:
    """Geyer initial-positive-sequence ESS in numpy (FFT autocovariance).

    trace: [C, T, D] → ESS [D], every lag from one FFT on the host."""
    c, t, d = trace.shape
    x = trace - trace.mean(axis=1, keepdims=True)
    n_fft = 1
    while n_fft < 2 * t:
        n_fft *= 2
    f = np.fft.rfft(x, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :t].real
    acov /= np.arange(t, 0, -1)[None, :, None]  # unbiased normalization
    var = acov[:, 0].mean(axis=0)  # [D]
    max_lag = min(max_lag, t - 1)
    rho = acov[:, 1 : max_lag + 1].mean(axis=0) / np.maximum(var, 1e-20)  # [L, D]
    positive = np.cumprod(rho > 0, axis=0)
    tau = 1.0 + 2.0 * (rho * positive).sum(axis=0)
    return c * t / np.maximum(tau, 1.0)


def np_split_rhat(trace: np.ndarray) -> np.ndarray:
    """Split-R̂ in numpy: trace [C, T, D] → [D]."""
    c, t, d = trace.shape
    t2 = t // 2
    halves = np.concatenate([trace[:, :t2], trace[:, t2 : 2 * t2]], axis=0)
    n = t2
    cm = halves.mean(axis=1)
    cv = halves.var(axis=1, ddof=1)
    w = cv.mean(axis=0)
    b = n * cm.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * w + b / n
    return np.sqrt(var_hat / np.maximum(w, 1e-20))


def run_long(data, label, n_chains, n_steps, segment, thin, *, seed: int = 1024,
             build_index: bool = True, **kw) -> dict:
    """``n_steps`` steps of ``n_chains`` chains of one ``mixing_sweep._setup``
    configuration (``kw``), from the initial state, randomness from one
    generator seeded with ``seed``; records drained to the host every
    ``segment`` steps → the JAX tool's summary row.  Moments of the held
    state over the second half in float64; the first 8 coefficients thinned
    every ``thin`` steps for ESS, split-R̂ and the Monte-Carlo standard
    errors."""
    import torch

    from icp_proposal_tpu_torch.sampling import mh

    ctx, mixture, step, carry = start_chains(data, n_chains, build_index=build_index, **kw)
    gen = torch.Generator(device=carry.log_post.device).manual_seed(seed)
    half = n_steps // 2
    r = data.model.rank
    icp_comps = [i for i, name in enumerate(mixture.names) if "Icp" in name]

    # accumulated over post-burn-in steps (host, float64)
    s1 = np.zeros(r)
    s2 = np.zeros(r)
    n_acc_steps = acc_count = icp_sel = icp_acc = 0
    thin_trace = []  # [C, 8] rows of the thinned post-burn-in coefficient traces
    t0 = time.perf_counter()
    done = 0
    while done < n_steps:
        n = min(segment, n_steps - done)
        carry, rec = mh.run_chains(step, carry, n, gen)
        rec = mh.stack_records(rec)
        acc = rec.accepted.cpu().numpy()  # [C, n]
        pidx = rec.proposal_idx.cpu().numpy()
        # the post-step coefficients are the held chain state, candidate on
        # accept and the previous state on reject (ChainRecord)
        held = rec.coeffs.cpu().numpy().astype(np.float64)  # [C, n, r]
        del rec
        for i in icp_comps:
            sel = pidx == i
            icp_sel += int(sel.sum())
            icp_acc += int(acc[sel].sum())
        lo = max(half - done, 0)  # first post-burn-in step of the segment
        if lo < n:
            post = held[:, lo:]
            s1 += post.sum(axis=(0, 1))
            s2 += (post ** 2).sum(axis=(0, 1))
            n_acc_steps += n - lo
            first = lo + (-(done + lo - half)) % thin
            thin_trace.extend(held[:, t, :8].astype(np.float32) for t in range(first, n, thin))
        acc_count += int(acc.sum())
        done += n
        print(f"[{label}] {done}/{n_steps} ({time.perf_counter() - t0:.0f}s)",
              file=sys.stderr, flush=True)
    wall = time.perf_counter() - t0  # each segment's records were read back

    n_post = n_acc_steps * n_chains
    mean = s1 / n_post
    var = s2 / n_post - mean ** 2
    sd = np.sqrt(np.maximum(var, 0))

    trace = np.stack(thin_trace, axis=1)  # [C, T_thin, 8]
    ess8 = np_ess(trace, max_lag=min(500, trace.shape[1] - 1))
    rhat8 = np_split_rhat(trace)
    # MC standard error of the mean per coordinate: sd / sqrt(ESS_unthinned).
    # ESS was computed on the thinned trace; thinning by `thin` divides the
    # sample count but (at most) divides autocorrelation time equally, so
    # ESS_unthinned >= ESS_thinned — using ESS_thinned is conservative.
    mcse8 = sd[:8] / np.sqrt(np.maximum(ess8, 1.0))
    errs = surface_avg_dist(data.model, ctx, carry.state)

    out = {
        "label": label,
        "config": kw,
        "chains": n_chains,
        "steps": n_steps,
        "wall_s": round(wall, 1),
        "samples_per_sec": round(n_steps * n_chains / wall, 1),
        "acceptance_overall": acc_count / (n_steps * n_chains),
        "icp_acceptance": (icp_acc / icp_sel) if icp_sel else None,
        "posterior_mean_first8": mean[:8].tolist(),
        "posterior_sd_first8": sd[:8].tolist(),
        "posterior_mean_norm": float(np.linalg.norm(mean)),
        "mcse_first8": mcse8.tolist(),
        "ess_first8": ess8.tolist(),
        "rhat_first8": rhat8.tolist(),
        "final_avg_dist_mm_mean": float(errs.mean()),
        "final_avg_dist_mm_best": float(errs.min()),
    }
    print(json.dumps(out), flush=True)
    return out


def compare(a, b):
    """Pairwise agreement of two runs' posterior means, in units of their
    combined Monte-Carlo error."""
    ma, mb = np.array(a["posterior_mean_first8"]), np.array(b["posterior_mean_first8"])
    ea, eb = np.array(a["mcse_first8"]), np.array(b["mcse_first8"])
    z = np.abs(ma - mb) / np.sqrt(ea ** 2 + eb ** 2)
    return {"pair": f"{a['label']} vs {b['label']}",
            "mean_abs_diff_first8": np.abs(ma - mb).tolist(),
            "z_scores_first8": z.tolist(),
            "max_z": float(z.max())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, out="posterior_parity.json")
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--segment", type=int, default=5000)
    ap.add_argument("--thin", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1024)
    args = ap.parse_args(argv)

    data = femur_data(args.components, args.data_dir, args.device)
    common = dict(n_chains=args.chains, n_steps=args.steps, segment=args.segment,
                  thin=args.thin, seed=args.seed)
    results = [run_long(data, name, **common, **kw) for name, kw in RUNS]
    # the two exact samplers agree within MC error (max z ~ O(3)); the parity
    # density's distance from the random walk is its bias
    comparisons = [compare(results[0], results[1]), compare(results[0], results[2])]
    payload = {"runs": results, "comparisons": comparisons}
    write_json(args.out, payload)
    print(json.dumps(comparisons, indent=1))
    print(f"[posterior_parity] wrote {args.out}", file=sys.stderr)
    return payload


if __name__ == "__main__":
    main()
