"""Run a task of the port's CPU tests on gloo ranks, one child process each.

    run(task, world, tmp_path, inputs) → one dict of tensors per rank

Each rank runs ``python tests/torch_ranks.py TASK RANK WORLD INIT IN OUT``:
it blocks any import of ``jax`` or of the JAX package before it imports
anything, takes one PyTorch thread, joins a ``file://`` rendezvous in
``tmp_path`` through ``initialize_distributed(device="cpu")``, runs
``TASKS[task]`` on the inputs saved by the test and saves what it returns.
Every rank is waited for with its own limit (``RANK_TIMEOUT``); on a failure
or a timeout all are killed and the test fails with the rank's output.

The setups here (the JAX tests' sphere, the stand-in femur GPMM-50 flagship)
and the converged run on the sphere import the port only, so the test
process builds its unsharded references from the same functions.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120.0


def run(task: str, world: int, tmp_path, inputs: dict) -> list[dict]:
    from icp_proposal_tpu_torch.parallel.distributed import run_ranks

    tmp = Path(tmp_path) / f"{task}-{world}"
    tmp.mkdir(parents=True)
    torch.save(inputs, tmp / "in.pt")
    cmds = [[sys.executable, __file__, task, str(rank), str(world),
             f"file://{tmp}/rendezvous", str(tmp / "in.pt"), str(tmp / f"out{rank}.pt")]
            for rank in range(world)]
    try:
        run_ranks(cmds, RANK_TIMEOUT, tmp, cwd=REPO)
    except RuntimeError as e:
        raise AssertionError(str(e)) from None
    return [torch.load(tmp / f"out{rank}.pt") for rank in range(world)]


def local_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    from icp_proposal_tpu_torch.parallel.distributed import chain_share

    offset, n = chain_share(x.shape[0], rank, world)
    return x[offset:offset + n]


# ---------------------------------------------------------------------------
# setups: name → (model, mixture, evaluator)
# ---------------------------------------------------------------------------


def sphere_data():
    """The sphere of the JAX package's sharded-runner tests
    (``tests/test_registration.py``) as a ``FemurData``: icosphere of
    subdivision 1, radius 50, rank-4 synthetic GPMM (σ = 40, scale 4),
    target at α = e₀."""
    from icp_proposal_tpu_torch.apps.femur import FemurData
    from icp_proposal_tpu_torch.mesh import TriangleMesh, boundary_vertex_mask
    from icp_proposal_tpu_torch.models.gpmm import instance_points
    from icp_proposal_tpu_torch.models.synthetic import make_icosphere, make_synthetic_gpmm

    points, cells = make_icosphere(subdivisions=1, radius=50.0)
    model = make_synthetic_gpmm(points, cells, rank=4, sigma=40.0, scale=4.0, device="cpu")
    alpha = torch.zeros(4)
    alpha[0] = 1.0
    target = TriangleMesh(points=instance_points(model, alpha), cells=model.cells)
    mask = boundary_vertex_mask(np.asarray(cells), len(points))
    return FemurData(model, target, mask, mask)


def _sphere(specs):
    """``sphere_data`` with the mixture of ``specs`` and a 16-point
    Euclidean evaluator of σ = 1."""
    from icp_proposal_tpu_torch.sampling.context import build_target_context
    from icp_proposal_tpu_torch.sampling.evaluators import (
        IndependentPointsSpec,
        build_evaluator,
    )
    from icp_proposal_tpu_torch.sampling.proposals import MixtureProgram, nest

    data = sphere_data()
    model = data.model
    ctx = build_target_context(data.target, device="cpu")
    mixture = MixtureProgram(nest(*specs), model, ctx, data.model_boundary_mask)
    evaluator = build_evaluator(
        model, ctx, [IndependentPointsSpec(sigma=1.0, mode="model_to_target", n_points=16)])
    return model, mixture, evaluator


def sphere_icp():
    """0.8·model-direction ICP (12 points, step 0.2) + 0.2·random walk 0.2."""
    from icp_proposal_tpu_torch.sampling.proposals import IcpSpec, RandomShapeSpec

    return _sphere([(0.8, [(1.0, IcpSpec(direction="model", n_points=12, step_length=0.2))]),
                    (0.2, [(1.0, RandomShapeSpec(sigma=0.2))])])


def sphere_rw():
    """The random walk of σ = 0.35 alone."""
    from icp_proposal_tpu_torch.sampling.proposals import RandomShapeSpec

    return _sphere([(1.0, [(1.0, RandomShapeSpec(sigma=0.35))])])


def flagship50():
    """The flagship femur setup on the stand-in GPMM-50 (rank 51)."""
    from icp_proposal_tpu_torch.apps.femur import (
        load_standin_femur_data,
        make_icp_proposal_setup,
    )

    data = load_standin_femur_data(device="cpu", model_components=50)
    _, mixture, evaluator = make_icp_proposal_setup(data)
    return data.model, mixture, evaluator


SETUPS = {"sphere-icp": sphere_icp, "sphere-rw": sphere_rw, "flagship50": flagship50}


def initial_carry(setup, n_chains: int, coeffs=None, rows=slice(None)):
    """(step with stored coefficients, carry of chains ``rows`` of a batch of
    ``n_chains`` at the zero pose and ``coeffs`` [n_chains, r] (default 0))."""
    from icp_proposal_tpu_torch.sampling import mh
    from icp_proposal_tpu_torch.sampling.state import FitState, init_state

    model, mixture, evaluator = setup
    state = init_state(model, n_chains)
    if coeffs is not None:
        state = state._replace(coeffs=torch.as_tensor(coeffs, dtype=torch.float32))
    state = FitState(*(x[rows] for x in state))
    step = mh.make_mh_step(model, mixture, evaluator, store_params=True)
    return step, mh.init_carry(model, evaluator, state, mixture)


# ---------------------------------------------------------------------------
# tasks: (inputs, rank, world) → dict of tensors
# ---------------------------------------------------------------------------


def _stats_dict(stats) -> dict:
    return {k: v for k, v in stats._asdict().items() if v is not None}


def task_diagnostics(inp, rank, world):
    from icp_proposal_tpu_torch.sampling.diagnostics import pooled_ess, pooled_split_rhat

    x = local_rows(inp["traces"], rank, world)
    return {"rhat": pooled_split_rhat(x), "ess": pooled_ess(x[..., 0], max_lag=inp["max_lag"])}


def task_pooled_stats(inp, rank, world):
    from types import SimpleNamespace

    import torch.distributed as dist

    from icp_proposal_tpu_torch.parallel.runner import pooled_stats
    from icp_proposal_tpu_torch.sampling import mh

    rows = {k: local_rows(v, rank, world) for k, v in inp.items() if torch.is_tensor(v)}
    records = mh.ChainRecord(accepted=rows["accepted"], proposal_idx=None, log_product=None,
                             named=None, coeffs=rows["coeffs"])
    final = SimpleNamespace(state=SimpleNamespace(coeffs=rows["final_coeffs"]),
                            log_post=rows["log_post"])
    return _stats_dict(pooled_stats(final, records, inp["burn_in"], group=dist.group.WORLD))


def task_chains(inp, rank, world):
    """``run_sharded_chains`` of one setup over the ranks."""
    from icp_proposal_tpu_torch.parallel.distributed import chains_for_host
    from icp_proposal_tpu_torch.parallel.runner import make_chain_mesh, run_sharded_chains

    mesh = make_chain_mesh(["cpu"] * world)
    n = inp["n_chains"]
    rows = mesh.chain_rows(n)
    assert rows.stop - rows.start == chains_for_host(n)
    step, carry = initial_carry(SETUPS[inp["setup"]](), n, inp.get("coeffs"), rows)
    final, records, stats = run_sharded_chains(
        step, carry, inp["seed"], inp["n_steps"], mesh, burn_in=inp["burn_in"],
        diag_max_lag=inp["max_lag"])
    return {"accepted": records.accepted, "coeffs": records.coeffs,
            "final_coeffs": final.state.coeffs, **_stats_dict(stats)}


def task_converged(inp, rank, world):
    """``tools.converged_run.main(inp["argv"])`` on ``sphere_data`` over the
    ranks → its output's R-hats (rank 0 holds the host check's)."""
    from icp_proposal_tpu_torch.tools import converged_run

    converged_run.femur_data = lambda *a, **k: sphere_data()
    out = converged_run.main(inp["argv"])
    got = {"rhat": torch.tensor([r["collective_split_rhat_max_first8"]
                                 for r in out["rounds"]], dtype=torch.float64)}
    if "host_split_rhat_max_first8_postburn" in out:
        got["host_rhat"] = torch.tensor(out["host_split_rhat_max_first8_postburn"],
                                        dtype=torch.float64)
    return got


TASKS = {"diagnostics": task_diagnostics, "pooled_stats": task_pooled_stats,
         "chains": task_chains, "converged": task_converged}


def _main(task, rank, world, init, inp, out):
    torch.set_num_threads(1)
    from icp_proposal_tpu_torch.parallel.distributed import initialize_distributed

    import torch.distributed as dist

    initialize_distributed(init, int(world), int(rank), device="cpu")
    try:
        torch.save(TASKS[task](torch.load(inp), int(rank), int(world)), out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    class _Block:
        """Refuse any import of jax or of the JAX package."""

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "icp_proposal_tpu"):
                raise ImportError("blocked in a rank process: " + name)

    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, str(REPO))
    _main(*sys.argv[1:])
