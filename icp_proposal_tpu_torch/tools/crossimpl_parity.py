"""Cross-implementation posterior parity: the numpy sampler against the port.

Counterpart of the repository's ``tools/crossimpl_parity.py``.  A bug
shared by the port's correspondence kernels or factor assembly would be
invisible to a comparison of the port with itself.  This tool runs the
single-core numpy port of the reference hot loop
(``reference_baseline_port.PortSampler``: scipy cKDTree + numpy, no code
shared with the port) as a long-chain sampler and compares its posterior
coefficient moments with the port's parity-mode flagship chains on the
card, both targeting the same parity density (the same seeded point
subsets, noise frames, mixture weights and evaluator; reference semantics
of ``NonRigidIcpProposal.scala:53-85`` + ``SamplingRegistration.scala:37-94``).
The port's side takes the dense kernel K5 for every closest-point query
(no shortlist index; the numpy sampler is exact).

Decision rule: for each of the first N coefficients, z = (m̂_numpy −
m̂_port) / sqrt(SE²_numpy + SE²_port), SEs from between-chain variation;
max |z| < 3 ⇒ within Monte-Carlo error.  The JSON keeps the JAX tool's
keys: "port" is the numpy sampler, "jax" the chains it is checked against
(here the torch port's).

    python3 -m icp_proposal_tpu_torch.tools.crossimpl_parity [--components 50]
        [--steps 20000] [--port-chains 6] [--chains 64] [--procs 2]
        [--device cpu] [--out PATH]

The numpy chains' moments are cached per chain in ``--port-cache``; with
``--data-dir`` on the real femur the committed
``artifacts/crossimpl_port_moments.npz`` (real-femur chains) is read too,
never written.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np

from icp_proposal_tpu_torch.convert import gpmm_from_arrays
from icp_proposal_tpu_torch.tools import EVIDENCE_DIR, add_common_args, femur_data, write_json
from icp_proposal_tpu_torch.tools.mixing_sweep import FLAGSHIP, _setup, start_chains

PARITY = dict(FLAGSHIP, parity=True)  # the flagship recipe with the reference's density
REPO = Path(__file__).resolve().parents[2]
COMMITTED_CACHE = REPO / "artifacts" / "crossimpl_port_moments.npz"


def _run_port_chain(args):
    """Worker: one numpy chain on ``data`` → (chain-mean [r], chain-var [r],
    acceptance)."""
    data, steps, burn, thin, seed = args
    from icp_proposal_tpu_torch.tools.reference_baseline_port import femur_port_sampler

    sampler = femur_port_sampler(data=data)
    sampler.target_q.k = min(32, len(sampler.tcells))  # tighter exactness
    trace, acc, _ = sampler.run(steps, seed=seed, record_from=burn, record_every=thin)
    return trace.mean(axis=0), trace.var(axis=0, ddof=1), acc


def fingerprint(model) -> np.ndarray:
    """Column sums of the model's scaled basis [r], float64.  A stand-in's
    basis is computed in each process that builds it, and LAPACK may return
    another rotation of a degenerate eigenvalue pair's vectors under another
    BLAS thread count, so cached chains are reused only for the same basis
    (the committed real-femur cache: the statismo file fixes its basis)."""
    return model.sbasis.detach().cpu().numpy().astype(np.float64).sum(axis=(0, 1))


def _load_cache(paths, cfg4, fp) -> dict:
    """Cached numpy chains of the run's configuration ``cfg4`` on the basis
    ``fp``: seed → (mean [r], var [r], acceptance), the first file holding a
    seed winning."""
    chains = {}
    for path in paths:
        if not os.path.exists(path):
            continue
        z = np.load(path)
        same_basis = (Path(path) == COMMITTED_CACHE
                      or ("fingerprint" in z and np.allclose(z["fingerprint"], fp, rtol=1e-9)))
        if same_basis and "cfg4" in z and np.array_equal(z["cfg4"], cfg4):
            for j, s in enumerate(z["seeds"].tolist()):
                chains.setdefault(int(s), (z["means"][j], z["vars"][j], float(z["accs"][j])))
    return chains


def save_cache(path, cfg4, fp, chains: dict) -> None:
    """Write ``chains`` (seed → (mean, var, acceptance)) of configuration
    ``cfg4`` on the basis ``fp`` to ``path``."""
    seeds = sorted(chains)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, cfg4=cfg4, fingerprint=fp, seeds=np.asarray(seeds),
             means=np.stack([chains[s][0] for s in seeds]),
             vars=np.stack([chains[s][1] for s in seeds]),
             accs=np.asarray([chains[s][2] for s in seeds]))


def port_side(data, n_chains, steps, burn, thin, seed=99):
    """The port's parity-mode flagship chains (dense K5) from the initial
    state → (per-chain means [C, r], per-chain variances [C, r],
    acceptance), moments of the held state over steps ``burn::thin``."""
    import torch

    from icp_proposal_tpu_torch.sampling import mh

    _, _, step, carry = start_chains(data, n_chains, **PARITY, build_index=False)
    gen = torch.Generator(device=carry.log_post.device).manual_seed(seed)
    held, acc = [], []
    done = 0
    while done < steps:  # records drained to the host every 1,000 steps
        n = min(1000, steps - done)
        carry, records = mh.run_chains(step, carry, n, gen)
        records = mh.stack_records(records)
        held.append(records.coeffs.cpu().numpy())
        acc.append(records.accepted.cpu().numpy())
        done += n
    states = np.concatenate(held, axis=1)[:, burn::thin]  # [C, T', r] held states
    return (states.mean(axis=1), states.var(axis=1, ddof=1),
            float(np.concatenate(acc, axis=1).mean()))


def check_same_density(data):
    """Raise unless the numpy sampler observes the ids the port's parity
    setup does (ICP model and target subsets, evaluator subset)."""
    from icp_proposal_tpu_torch.tools.reference_baseline_port import femur_port_sampler

    _, mixture, evaluator = _setup(data, **PARITY, build_index=False)
    probe = femur_port_sampler(data=data)
    comps = [mixture.icp_components[i] for i in sorted(mixture.icp_components)]
    if frozenset(probe.icp_ids.tolist()) not in {frozenset(c.model_ids.tolist())
                                                 for c in comps}:
        raise AssertionError("ICP model ids differ")
    if frozenset(probe.tgt_ids.tolist()) not in {frozenset(c.target_ids.tolist())
                                                 for c in comps}:
        raise AssertionError("ICP target ids differ")
    if frozenset(probe.eval_ids.tolist()) != frozenset(
            np.asarray(evaluator.model_ids("distance")).tolist()):
        raise AssertionError("evaluator ids differ")


def main(argv=None) -> dict | None:
    from icp_proposal_tpu_torch.tools.reference_baseline_port import pinned_pool

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, out="posterior_parity_crossimpl.json")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--burn", type=int, default=2000)
    ap.add_argument("--thin", type=int, default=10)
    ap.add_argument("--port-chains", type=int, default=6,
                    help="chains of the numpy sampler (one process each, --procs at once)")
    ap.add_argument("--chains", type=int, default=64,
                    help="chains of the port's parity-mode sampler")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--n-check", type=int, default=10,
                    help="leading coefficients compared by z-score")
    ap.add_argument("--port-cache", default=str(EVIDENCE_DIR / "crossimpl_port_moments.npz"),
                    help="per-chain cache of the (expensive) numpy chains' moments; "
                         "chains of the same configuration and basis are reused")
    ap.add_argument("--port-only", action="store_true",
                    help="run only the numpy chains and write the cache")
    args = ap.parse_args(argv)
    if Path(args.port_cache).resolve().is_relative_to(REPO / "artifacts"):
        raise ValueError(f"--port-cache {args.port_cache} lies under artifacts/, which "
                         "holds the JAX package's evidence: name another path")

    # one host build of the model for both sides (see ``fingerprint``)
    host = femur_data(args.components, args.data_dir, device="cpu")
    fp = fingerprint(host.model)

    # ---------------- numpy side (worker processes, cached) ----------------
    cfg4 = np.asarray([args.components, args.steps, args.burn, args.thin])
    seeds_wanted = [1000 + i for i in range(args.port_chains)]
    cached = _load_cache([args.port_cache] + ([COMMITTED_CACHE] if args.data_dir else []),
                         cfg4, fp)
    if cached:
        print(f"[port] {len(cached)} cached chains of this configuration")
    missing = [s for s in seeds_wanted if s not in cached]
    t0 = time.perf_counter()
    if missing:
        work = [(host, args.steps, args.burn, args.thin, s) for s in missing]
        with pinned_pool(args.procs) as pool:
            for s, r in zip(missing, pool.map(_run_port_chain, work)):
                cached[s] = (r[0], r[1], float(r[2]))
    port_wall = time.perf_counter() - t0
    port_means = np.stack([cached[s][0] for s in seeds_wanted])
    port_vars = np.stack([cached[s][1] for s in seeds_wanted])
    port_acc = float(np.nanmean([cached[s][2] for s in seeds_wanted]))
    save_cache(args.port_cache, cfg4, fp, cached)
    print(f"[port] {args.port_chains} chains x {args.steps} steps ({len(missing)} newly "
          f"sampled, {port_wall:.0f}s), acceptance {port_acc:.3f}")
    if args.port_only:
        return None

    # ---------------- the port's side (parity mode, dense K5) --------------
    t0 = time.perf_counter()
    data = dataclasses.replace(host, model=gpmm_from_arrays(**vars(host.model),
                                                            device=args.device))
    check_same_density(data)
    jax_means, jax_vars, jax_acc = port_side(data, args.chains, args.steps, args.burn,
                                             args.thin)
    jax_wall = time.perf_counter() - t0
    device = data.model.device
    print(f"[port:{device.type}] {args.chains} chains x {args.steps} steps in "
          f"{jax_wall:.0f}s, acceptance {jax_acc:.3f}")

    # ---------------- comparison -------------------------------------------
    n = args.n_check
    m_port = port_means.mean(axis=0)
    m_jax = jax_means.mean(axis=0)
    se_port = port_means.std(axis=0, ddof=1) / np.sqrt(len(port_means))
    se_jax = jax_means.std(axis=0, ddof=1) / np.sqrt(len(jax_means))
    z = (m_port - m_jax) / np.sqrt(se_port**2 + se_jax**2 + 1e-30)
    sd_ratio = np.sqrt(port_vars.mean(axis=0) / np.maximum(jax_vars.mean(axis=0), 1e-30))

    # Welch t-test: with only a handful of numpy chains the normal-z reading
    # of the statistic is anticonservative (the between-chain variance is
    # itself noisy, df ≈ port_chains − 1); Welch-Satterthwaite df + t
    # p-values are the honest criterion
    from scipy import stats as sstats

    v1, n1 = se_port**2, len(port_means)
    v2, n2 = se_jax**2, len(jax_means)
    df = (v1 + v2) ** 2 / (v1**2 / (n1 - 1) + v2**2 / (n2 - 1) + 1e-300)
    p = 2.0 * sstats.t.sf(np.abs(z), df)
    # discrepancy in units the posterior itself defines
    post_sd = np.sqrt(port_vars.mean(axis=0))
    delta_in_sd = np.abs(m_port - m_jax) / np.maximum(post_sd, 1e-30)

    out = {
        "config": {
            "components": args.components, "steps": args.steps,
            "burn": args.burn, "thin": args.thin,
            "port_chains": args.port_chains, "jax_chains": args.chains,
            "jax_backend": device.type,
            "shortlist_disabled": "1",
            "density": "parity (reference semantics)",
        },
        "port": {
            "acceptance": port_acc,
            "mean_first": m_port[:n].tolist(),
            "se_first": se_port[:n].tolist(),
            "wall_s": round(port_wall, 1),
        },
        "jax": {
            "acceptance": jax_acc,
            "mean_first": m_jax[:n].tolist(),
            "se_first": se_jax[:n].tolist(),
            "wall_s": round(jax_wall, 1),
        },
        "z_first": z[:n].tolist(),
        "max_abs_z_first": float(np.max(np.abs(z[:n]))),
        "max_abs_z_all": float(np.max(np.abs(z))),
        "welch_df_first": df[:n].tolist(),
        "welch_p_first": p[:n].tolist(),
        "min_welch_p_first": float(np.min(p[:n])),
        # Bonferroni over the n compared coefficients
        "pass_welch_bonferroni_0p01": bool(np.min(p[:n]) * n > 0.01),
        "delta_in_posterior_sd_first": delta_in_sd[:n].tolist(),
        "max_delta_in_posterior_sd_first": float(np.max(delta_in_sd[:n])),
        "sd_ratio_first": sd_ratio[:n].tolist(),
        "pass_3sigma_first": bool(np.max(np.abs(z[:n])) < 3.0),
    }
    print(json.dumps({k: out[k] for k in
                      ("max_abs_z_first", "max_abs_z_all", "pass_3sigma_first",
                       "min_welch_p_first", "pass_welch_bonferroni_0p01",
                       "max_delta_in_posterior_sd_first")}))
    write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
