"""The posterior-evidence tools' chains, on the CPU: one step of the mixing
sweep's richest configuration against JAX's, the long-run samplers in
distribution on the sphere, and the converged run over gloo ranks.

* ``mixing_sweep._setup`` of ICP + MALA + random walk with adaptation, in
  both packages at the stand-in's full width (rank 101): one MH step of 4
  chains from JAX's carry with JAX's noise takes JAX's decisions
  (``tests/test_torch_mh.py``'s ``_step_parity``).
* ``posterior_parity.run_long`` on ``tests/test_mh.py``'s sphere (rank 6),
  16 chains × 1,000 steps (ICP step 0.5, walk σ = 0.3: ``CONFIG``): the two
  exact samplers (random walk alone, the ICP mixture) agree within max
  z < 4 of their Monte-Carlo errors, and the port's ICP mixture against
  JAX's own ``tools.posterior_parity.run_long`` from the same start, each
  with its own random stream: posterior means within 4 combined
  Monte-Carlo standard errors, acceptance (overall and ICP) within 0.05.
* ``converged_run`` over two gloo ranks on the CPU (child processes of
  ``tests/torch_ranks.py``) on the sharded-runner tests' sphere: the
  pooled R̂ of the post-burn-in round equals the R̂ of the traces gathered
  on rank 0 (rtol 1e-4), and every round's pooled R̂ equals the same run's
  in one process (rtol 1e-5: a chain takes the same steps however the
  batch is split).
"""
import numpy as np
import pytest
import torch_ranks
from test_torch_evidence import _sphere
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.tools import posterior_parity as pp

# the flagship's noise scales with a step of 0.5 and a walk of σ = 0.3: the
# sphere's posterior sd is ≈ 0.7, so the flagship's step 0.1 and σ = 0.1 do
# not mix in 1,000 steps (max R-hat 1.4 for the walk, 2–3 for the ICP
# mixture), these do (≈ 1.1)
CONFIG = dict(parity=False, step_length=0.5, noise_normal=5.0, tangential=10.0,
              rw_sigma=0.3)
N_CHAINS, N_STEPS, SEGMENT, THIN = 16, 1000, 500, 5


def test_setup_step_parity_full_width(monkeypatch):
    """One step of ``_setup``'s ICP 0.5 + MALA 0.4 + random walk 0.1
    configuration with adaptation (``icp0.5+mala0.4-adapt`` of the sweep's
    grid) from JAX's carry with JAX's noise: the same proposal index,
    decisions away from |log α − log u| ≤ 1e-3, log posterior rtol 1e-4,
    the adapted scales and MALA's gradient as ``_step_parity`` holds them."""
    from icp_proposal_tpu.apps import femur as jfemur
    from test_torch_mh import N_CHAINS as STEP_CHAINS
    from test_torch_mh import _step_parity
    from tools import mixing_sweep as jms

    from icp_proposal_tpu_torch.apps import femur as pfemur
    from icp_proposal_tpu_torch.tools import mixing_sweep as ms

    kw = dict(ms.grid())["icp0.5+mala0.4-adapt"]
    monkeypatch.setitem(jfemur.SETUPS, "sweep", jms._setup)
    monkeypatch.setitem(pfemur.SETUPS, "sweep",
                        lambda data, coarse="exact", **k: ms._setup(data, **k))
    compared, _ = _step_parity(monkeypatch, "sweep", "exact", 1, **kw)
    assert compared >= STEP_CHAINS - 1


@pytest.fixture(scope="module")
def long_runs():
    """The port's rw-only and icp-exact ``run_long`` and JAX's icp-exact on
    the sphere (``CONFIG``), N_CHAINS × N_STEPS from the initial state."""
    from icp_proposal_tpu.apps.femur import FemurData as JFemurData
    from tools import posterior_parity as jpp

    data, jm = _sphere(jax_model=True)
    jdata = JFemurData(model=jm, target=data.target, model_landmarks={},
                       target_landmarks={}, target_boundary_mask=data.target_boundary_mask,
                       model_boundary_mask=data.model_boundary_mask)
    common = dict(n_chains=N_CHAINS, n_steps=N_STEPS, segment=SEGMENT, thin=THIN)
    return {"rw-only": pp.run_long(data, "rw-only", **common, **CONFIG, icp_weight=0.0),
            "icp-exact": pp.run_long(data, "icp-exact", **common, **CONFIG),
            "jax icp-exact": jpp.run_long(jdata, "icp-exact", **common, **CONFIG)}


def test_exact_samplers_agree(long_runs):
    """The random walk and the ICP mixture, both exact MH: every posterior
    mean's z-score below 4 (``posterior_parity.compare``); both moved from
    the prior toward the target's α = (1.5, −1, …)."""
    cmp = pp.compare(long_runs["rw-only"], long_runs["icp-exact"])
    assert cmp["max_z"] < 4.0, cmp
    for run in ("rw-only", "icp-exact"):
        mean = long_runs[run]["posterior_mean_first8"]
        assert mean[0] > 0 > mean[1], (run, mean)


def test_icp_exact_matches_jax_in_distribution(long_runs):
    """The port's icp-exact against JAX's: posterior means within 4
    combined Monte-Carlo standard errors, acceptance overall and of the ICP
    components within 0.05."""
    port, jax_run = long_runs["icp-exact"], long_runs["jax icp-exact"]
    cmp = pp.compare(port, jax_run)
    assert cmp["max_z"] < 4.0, cmp
    for key in ("acceptance_overall", "icp_acceptance"):
        assert abs(port[key] - jax_run[key]) < 0.05, (key, port[key], jax_run[key])
    assert 0.0 < port["icp_acceptance"] < 1.0


def test_converged_run_over_gloo_ranks(tmp_path, monkeypatch):
    """``converged_run.main`` on two gloo ranks (8 chains, 2 rounds of 40
    random-walk steps on the sphere): the post-burn-in round's pooled R̂
    equals rank 0's R̂ of the gathered traces (rtol 1e-4), and every round's
    pooled R̂ equals the same run in this process with no group (rtol
    1e-5)."""
    from icp_proposal_tpu_torch.tools import converged_run

    argv = ["--device", "cpu", "--chains", "8", "--round-steps", "40", "--max-rounds", "2",
            "--segment-steps", "20", "--diag-max-lag", "20"]
    outs = torch_ranks.run("converged", 2, tmp_path,
                           {"argv": argv + ["--out", str(tmp_path / "ranks.json")]})
    np.testing.assert_array_equal(outs[0]["rhat"].numpy(), outs[1]["rhat"].numpy())
    rhat = outs[0]["rhat"].numpy()
    assert len(rhat) == 2 and "host_rhat" not in outs[1]
    np.testing.assert_allclose(rhat[1], float(outs[0]["host_rhat"]), rtol=1e-4)

    monkeypatch.setattr(converged_run, "femur_data", lambda *a, **k: torch_ranks.sphere_data())
    one = converged_run.main(argv + ["--out", str(tmp_path / "one.json")])
    assert one["diagnostics_via"] == "single_device_fast_path"
    np.testing.assert_allclose(rhat, [r["collective_split_rhat_max_first8"]
                                      for r in one["rounds"]], rtol=1e-5)


def acceptance_beside_jax(n_chains: int = 8, n_steps: int = 200) -> dict:
    """JAX's ``tools.mixing_sweep.run_config`` and the port's on this CPU at
    the stand-in femur's width (GPMM-50, rank 51; JAX on its plain CPU path,
    the port through its index and plain twins), the quick grid, each with
    its own random stream → label → the acceptance overall and by component
    of each package."""
    import contextlib
    import io

    from icp_proposal_tpu.apps.femur import FemurData as JFemurData
    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import boundary_vertex_mask, make_mesh
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm
    from tools import mixing_sweep as jms

    from icp_proposal_tpu_torch.apps.femur import STANDIN_DIR, load_standin_femur_data
    from icp_proposal_tpu_torch.tools import mixing_sweep as ms

    mp, mc = read_stl(STANDIN_DIR / "mean.stl")
    tp, tc = read_stl(STANDIN_DIR / "map.stl")
    jdata = JFemurData(model=build_femur_gpmm(mp, mc, 50), target=make_mesh(tp, tc),
                       model_landmarks={}, target_landmarks={},
                       target_boundary_mask=boundary_vertex_mask(tc, len(tp)),
                       model_boundary_mask=boundary_vertex_mask(mc, len(mp)))
    data = load_standin_femur_data(device="cpu", model_components=50)
    out = {}
    for label, kw in ms.grid(quick=True):
        with contextlib.redirect_stdout(io.StringIO()):
            runs = {"jax": jms.run_config(jdata, label, n_chains, n_steps, **kw),
                    "port": ms.run_config(data, label, n_chains, n_steps, **kw)}
        out[label] = {side: {"overall": r["acceptance_overall"],
                             **{name: c["acceptance"] for name, c in r["per_component"].items()}}
                      for side, r in runs.items()}
    return out


if __name__ == "__main__":
    # JAX's acceptance at the stand-in's width beside the port's, on this CPU:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_evidence_runs.py
    import json
    import sys

    sys.path.insert(0, str(torch_ranks.REPO))
    print(json.dumps({"chains": 8, "steps": 200, "acceptance": acceptance_beside_jax()},
                     indent=1))
