"""A run with the timed path broken underneath comes out not correct: the
step that returns its state unchanged, half of the batch left out, and a
decision altered where it is made.  The harness's look for a card is
skipped (``run_cell`` on the CPU); the rest of the run is the benchmark's."""
import time

import pytest
import torch

from portbench.run import run_cell
from portbench.tests.helpers import tiny_root


def unchanged(step):
    def broken(carry, noise):
        return carry, step(carry, noise=noise)[1]
    return broken


def _where(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def half_left_out(step):
    """The second half of the chains keeps its state and reports a
    rejection of nothing: as if the step had run on the first half."""
    def broken(carry, noise):
        new, rec = step(carry, noise=noise)
        b = rec.accepted.shape[0]
        keep = torch.arange(b, device=rec.accepted.device) < b // 2
        state = type(carry.state)(*(_where(keep, n, o) for n, o in
                                    zip(new.state, carry.state)))
        new = new._replace(state=state, log_post=_where(keep, new.log_post, carry.log_post),
                           named=_where(keep, new.named, carry.named),
                           icp_factors=tuple(
                               type(n)(*(_where(keep, x, y) for x, y in zip(n, o)))
                               if isinstance(n, tuple) else _where(keep, n, o)
                               for n, o in zip(new.icp_factors, carry.icp_factors)))
        rec = rec._replace(accepted=rec.accepted & keep,
                           log_product=_where(keep, rec.log_product, carry.log_post),
                           coeffs=state.coeffs,
                           pose=torch.cat([state.trans, state.rot, state.center], -1))
        return new, rec
    return broken


def decision_altered(step):
    """Every other chain's decision is reversed where it is made: the
    record and the carry follow the reversed decision."""
    def broken(carry, noise):
        new, rec = step(carry, noise=noise)
        flip = torch.arange(rec.accepted.shape[0], device=rec.accepted.device) % 2 == 0
        took = rec.accepted ^ flip
        # a chain whose decision is reversed keeps what it would have left
        state = type(carry.state)(*(_where(flip & rec.accepted, o, n)
                                    for n, o in zip(new.state, carry.state)))
        rec = rec._replace(accepted=took, coeffs=state.coeffs,
                           pose=torch.cat([state.trans, state.rot, state.center], -1))
        return new._replace(state=state), rec
    return broken


CELLS = [  # cell, rank, chains, face subdivisions
    ("femur100.rw.c16384", 11, 8, None),
    ("femur100.flagship.c4096", 11, 8, None),
    ("face200.partial.c2048", 8, 6, 2),
]


@pytest.fixture(scope="module", params=CELLS, ids=[c[0] for c in CELLS])
def cell(request, tmp_path_factory):
    name, rank, chains, subdiv = request.param
    return tiny_root(tmp_path_factory.mktemp("faults"), name, rank, chains, pairs=48,
                     subdivisions=subdiv)


def run(cell, wrap):
    man, c = cell
    return run_cell(man, c, 2 ** 31 + 777, 60.0, False, torch.device("cpu"),
                    time.monotonic(), wrap_step=wrap, max_steps=8)[0]


def test_sound_run_is_correct(cell):
    assert run(cell, None)["correct"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, decision_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(cell, fault):
    result = run(cell, fault)
    assert not result["correct"], result["check"]
