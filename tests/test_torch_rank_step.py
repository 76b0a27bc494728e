"""The port's flagship MH step against the JAX package's on the stand-in
GPMM-400 (rank 401), the widest round femur model the stand-in mesh takes:
at GPMM-405 both packages' setups refuse (811 ICP ids for 812 points).

Rank 401 is past the tiled K6's 320, so on the card the step's factors go
to the streamed K6 (and its draws to K7's row kernel, r ≤ 512).  Here the
port runs its plain twins; JAX runs its closest-point kernels in interpret
mode and its Cholesky factor and solve through its XLA route, since
``tests/test_torch_chol_rank.py`` holds the interpret-mode blocked kernels
at these ranks.  4 chains × 2 steps from JAX's carry with JAX's noise:
the same proposal index, the same decision wherever |log α − log u| >
1e-3, log posterior within rtol 1e-4 (``test_torch_mh._step_parity``).
"""
from test_torch_mh import N_CHAINS, _step_parity
from torch_threads import one_torch_thread  # noqa: F401

COMPONENTS, N_STEPS = 400, 2


def test_flagship_step_parity_gpmm400(monkeypatch):
    compared, accepted = _step_parity(monkeypatch, "flagship", "exact", N_STEPS,
                                      components=COMPONENTS, chol_pallas=False)
    assert compared >= N_CHAINS * N_STEPS - 1  # near-ties are rare
    assert accepted > 0  # from the mean shape the proposals are taken
