"""The control on the card: the reference in the port's place, in float32
with TF32 products, must come out not correct under each cell's limits,
while the port at the same size comes out correct.  256 chains of each
cell's configuration, a dozen steps.  Needs the card; skips without one.

    python3 -m pytest portbench/tests -m cuda
"""
import copy
import time

import pytest
import torch

from portbench.control import ControlSystem
from portbench.manifest import ROOT, Manifest
from portbench.run import run_cell

MAN = Manifest(ROOT)
CELLS = [w["name"] for w in MAN.data["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_port_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 products exist only there")
    cell = copy.deepcopy(MAN.workload(name))
    cell["chains"] = 256
    cell["check"]["pairs"] = min(cell["check"]["pairs"], 12 * cell["check"]["chains"])
    dev = torch.device("cuda", 0)
    seed = 2 ** 31 + 4242
    port, _ = run_cell(MAN, cell, seed, 60.0, False, dev, time.monotonic(), max_steps=14)
    control, _ = run_cell(MAN, cell, seed, 600.0, False, dev, time.monotonic(),
                          system_class=ControlSystem, max_steps=14)
    assert port["correct"], port["check"]
    assert not control["correct"], control["check"]
