"""The port's pod-chains CLI and driver entries on the CPU.

``pod_chains`` runs once in one process and once under
``python -m torch.distributed.run --standalone --nproc-per-node 2`` (gloo;
``--standalone`` picks a free port, so parallel test workers do not
collide); each run is waited for with a 120 s limit and killed with its
process group after it.  Mirrors JAX's ``test_pod_chains_cli_tiny``
(``tests/test_config_and_tools.py``) and ``test_graft_entry_compiles``
(``tests/test_registration.py``).
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import graft_entry

REPO = Path(__file__).resolve().parents[1]
LIMIT = 120.0
# the keys of the JAX CLI's result line (icp_proposal_tpu/apps/pod_chains.py),
# --host-diagnostics included
JAX_KEYS = {"devices", "chains", "steps", "components", "setup", "samples_per_sec",
            "samples_per_sec_per_chip", "pooled_acceptance", "coeff_mean_norm",
            "rhat_max_first8", "ess_coeff0", "trace", "diagnostics_via",
            "host_rhat_max_first8", "host_ess_coeff0"}


def _run(cmd):
    """Run ``cmd`` in its own process group with one thread a process → the
    JSON of its last output line; kill the group at the limit."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{cmd} did not finish within {LIMIT} s")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


def test_pod_chains_cli_tiny():
    """8 chains × 30 steps of the stand-in GPMM-50 flagship: JAX's result
    keys, ``devices`` 1 then 2, the host's R̂/ESS of the gathered traces
    equal to the pooled ones, and the same chains either way."""
    args = ["-m", "icp_proposal_tpu_torch.apps.pod_chains", "--chains", "8", "--steps", "30",
            "--components", "50", "--device", "cpu", "--host-diagnostics"]
    one = _run([sys.executable, *args])
    two = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", *args])
    for stats, devices, via in ((one, 1, "single_device_fast_path"), (two, 2, "collectives")):
        assert set(stats) == JAX_KEYS
        assert stats["devices"] == devices and stats["chains"] == 8
        assert stats["diagnostics_via"] == via
        assert 0.0 < stats["pooled_acceptance"] < 1.0
        assert np.isfinite(stats["rhat_max_first8"])
        np.testing.assert_allclose(stats["host_rhat_max_first8"], stats["rhat_max_first8"],
                                   rtol=1e-4)
        np.testing.assert_allclose(stats["host_ess_coeff0"], stats["ess_coeff0"], rtol=1e-4)
    for key in ("pooled_acceptance", "coeff_mean_norm", "rhat_max_first8", "ess_coeff0"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, err_msg=key)


def test_graft_entry_runs(monkeypatch):
    """``entry(device="cpu")`` steps its 8 chains once; ``dryrun_multichip(2,
    device="cpu")`` runs 64 chains × 100 steps over two gloo ranks, each
    waited for at most 120 s."""
    fn, args = graft_entry.entry(device="cpu")
    carry, accepted, log_product = fn(*args)
    assert accepted.shape == (8,) and accepted.dtype == torch.bool
    assert torch.isfinite(log_product).all() and torch.isfinite(carry.log_post).all()
    monkeypatch.setattr(graft_entry, "DRYRUN_RANK_TIMEOUT", LIMIT)
    graft_entry.dryrun_multichip(2, device="cpu")
