"""The reference against the port's CPU path: a whole run of each cell's
setup at a tiny rank and a few chains, judged as on the card."""
import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.helpers import tiny_root

CASES = [  # cell, rank, chains, face subdivisions
    ("femur100.flagship.c4096", 11, 4, None),
    ("femur100.rw.c16384", 11, 6, None),
    ("femur100.hybrid.c2048", 11, 4, None),
    ("face200.partial.c2048", 8, 3, 2),
]


@pytest.mark.parametrize("name,rank,chains,subdiv", CASES, ids=[c[0] for c in CASES])
def test_reference_agrees_with_the_port(tmp_path, name, rank, chains, subdiv):
    man, cell = tiny_root(tmp_path, name, rank, chains, subdivisions=subdiv)
    result, lines = run_cell(man, cell, 2 ** 31 + 12345, 60.0, False,
                             torch.device("cpu"), time.monotonic(), max_steps=6)
    assert result["correct"], lines
    check = result["check"]
    assert check["lp_gap_p90"]["value"] < 1e-3
    assert check["log_alpha_gap_p90"]["value"] < 1e-3
    assert check["bad_step_share"]["value"] == 0
    assert result["attempted"] == 6 * chains and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in man.metrics_for(name, "end_to_end")}
    assert set(result["metrics"]) == {
        "samples_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "check"


def test_nearest_vertex_ties_at_rounding():
    from portbench.reference import geometry as g

    pts = torch.tensor([[0.0, 0, 0], [2, 0, 0], [5, 5, 5]], dtype=torch.float64)
    q = torch.tensor([[[1.0, 1e-9, 0], [0.2, 0, 0]]], dtype=torch.float64)
    first, second, tie = g.nearest_vertex(q, pts, second=True)
    assert tie.tolist() == [[True, False]]
    assert first.tolist() == [[0, 0]] and second.tolist() == [[1, 1]]
    assert g.nearest_vertex(q, pts).tolist() == [[0, 0]]
