"""K6 ``chol_solve_blocked`` and K7 ``tri_solve_lt_blocked``: the port's
plain twins against the JAX package's blocked Pallas kernels (interpret
mode), the routing rule against the reference's, and the CUDA kernels
against the plain twins where a card is present.

Tolerance: rtol 1e-4, atol 1e-4 on L, x and log det, as for K1/K2 — float32
factorizations that sum in different orders.  The interpret-mode blocked
kernel always works on 128 chains of lanes, so the cases keep to 2–3 chains
of real data.
"""
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.ops import chol_cuda

TOL = dict(rtol=1e-4, atol=1e-4)


def _spd_batch(rng, b, r):
    a = rng.randn(b, r, r).astype(np.float32) * (0.4 / np.sqrt(r))
    return (np.einsum("bij,bkj->bik", a, a) + np.eye(r, dtype=np.float32)).astype(
        np.float32)


def _pallas_blocked(m, rhs):
    import jax.numpy as jnp
    from icp_proposal_tpu.ops.chol_pallas import _chol_blocked_call

    l_t, x_t, ld = _chol_blocked_call(jnp.moveaxis(jnp.asarray(m), 0, 2),
                                      jnp.moveaxis(jnp.asarray(rhs), 0, 1),
                                      interpret=True)
    return (np.moveaxis(np.asarray(l_t), 2, 0), np.moveaxis(np.asarray(x_t), 1, 0),
            np.asarray(ld))


@pytest.mark.parametrize("r", [44, 200, 201])
def test_chol_solve_blocked_plain_matches_pallas(r, monkeypatch):
    """r = 44 with the panel width pinned to 16 (three panels, identity
    padding to 48); r = 200 (panel 40, no padding); r = 201 (padded to
    208).  One chain is not SPD."""
    import icp_proposal_tpu.ops.chol_pallas as jcp

    if r == 44:
        monkeypatch.setattr(jcp, "_pick_nb", lambda r, bl=128: 16)
    rng = np.random.RandomState(r)
    b, bad, pivot = 3, 1, 5
    m = _spd_batch(rng, b, r)
    m[bad, pivot, pivot] = -1.0
    rhs = rng.randn(b, r).astype(np.float32)
    l_ref, x_ref, ld_ref = _pallas_blocked(m, rhs)
    l, x, ld = (t.numpy() for t in chol_cuda.chol_solve_blocked(
        torch.as_tensor(m), torch.as_tensor(rhs)))
    good = np.arange(b) != bad
    np.testing.assert_allclose(l[good], l_ref[good], **TOL)
    np.testing.assert_allclose(x[good], x_ref[good], **TOL)
    np.testing.assert_allclose(ld[good], ld_ref[good], **TOL)
    assert np.all(np.triu(l[good], 1) == 0)
    for xb, ldb in ((x, ld), (x_ref, ld_ref)):  # the non-SPD chain is NaN in both
        assert np.isnan(xb[bad]).all() and np.isnan(ldb[bad])


@pytest.mark.parametrize("r", [44, 200, 201])
def test_tri_solve_lt_blocked_plain_matches_pallas(r, monkeypatch):
    import jax.numpy as jnp
    import icp_proposal_tpu.ops.chol_pallas as jcp

    if r == 44:
        monkeypatch.setattr(jcp, "_pick_nb", lambda r, bl=128: 16)
    rng = np.random.RandomState(10 + r)
    b = 2
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(
        np.float32)
    z = rng.randn(b, r).astype(np.float32)
    x_ref = np.moveaxis(np.asarray(jcp._tri_lt_blocked_call(
        jnp.moveaxis(jnp.asarray(chol), 0, 2), jnp.moveaxis(jnp.asarray(z), 0, 1),
        interpret=True)), 1, 0)
    x = chol_cuda.tri_solve_lt_blocked(torch.as_tensor(chol), torch.as_tensor(z))
    np.testing.assert_allclose(x.numpy(), x_ref, **TOL)


def test_routing_rule_is_the_reference_rule():
    """Blocked exactly where the reference's ``_pick_bl(ceil8(r))`` is None:
    rank 101 stays monolithic, 105 and up (rank 200) go blocked, up to
    2,048, past the reference's blocked kernels' 1,224 and the port's
    tiled and row kernels' 320 and 512."""
    from icp_proposal_tpu.ops.chol_pallas import _pick_bl

    for r in range(8, 2049):
        assert chol_cuda.uses_blocked(r) == (_pick_bl(-(-r // 8) * 8) is None), r
    assert not chol_cuda.uses_blocked(101) and not chol_cuda.uses_blocked(104)
    assert chol_cuda.uses_blocked(105) and chol_cuda.uses_blocked(200)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [200, 201])
def test_cuda_blocked_kernels_match_plain(cuda, r):
    """K6 and K7 on the card against the plain twins; ``chol_solve`` and
    ``tri_solve_lt`` route rank 200 and 201 to them."""
    rng = np.random.RandomState(r)
    b = 64
    m = _spd_batch(rng, b, r)
    m[5, 70, 70] = -1e3
    rhs = rng.randn(b, r).astype(np.float32)
    z = rng.randn(b, r).astype(np.float32)
    mg, rg, zg = (torch.as_tensor(a, device=cuda) for a in (m, rhs, z))
    n1, n6 = chol_cuda.chol_solve.launches, chol_cuda.chol_solve_blocked.launches
    l, x, ld = chol_cuda.chol_solve(mg, rg)
    torch.cuda.synchronize()
    assert chol_cuda.chol_solve.launches == n1
    assert chol_cuda.chol_solve_blocked.launches == n6 + 1
    l_p, x_p, ld_p = chol_cuda.chol_solve_plain(mg, rg)
    good = torch.arange(b, device=cuda) != 5
    torch.testing.assert_close(l[good], l_p[good], **TOL)
    torch.testing.assert_close(x[good], x_p[good], **TOL)
    torch.testing.assert_close(ld[good], ld_p[good], **TOL)
    assert torch.isnan(x[5]).all() and torch.isnan(ld[5])
    assert torch.equal(torch.triu(l[good], 1), torch.zeros_like(l[good]))
    lg, zgg = l[good].contiguous(), zg[good].contiguous()
    n7 = chol_cuda.tri_solve_lt_blocked.launches
    xt = chol_cuda.tri_solve_lt(lg, zgg)
    torch.cuda.synchronize()
    assert chol_cuda.tri_solve_lt_blocked.launches == n7 + 1
    torch.testing.assert_close(xt, chol_cuda.tri_solve_lt_plain(lg, zgg), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [105, 200, 201, 256])
def test_cuda_tri_solve_lt_blocked_ranks(cuda, r):
    """K7 against its twin at the smallest blocked rank, the face model's
    rank, one past it and the most its 8-register form holds (32 · 8)."""
    rng = np.random.RandomState(100 + r)
    b = 96
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(np.float32)
    z = rng.randn(b, r).astype(np.float32)
    lg, zg = torch.as_tensor(chol, device=cuda), torch.as_tensor(z, device=cuda)
    n7 = chol_cuda.tri_solve_lt_blocked.launches
    x = chol_cuda.tri_solve_lt_blocked(lg, zg)
    torch.cuda.synchronize()
    assert chol_cuda.tri_solve_lt_blocked.launches == n7 + 1
    torch.testing.assert_close(x, chol_cuda.tri_solve_lt_plain(lg, zg), **TOL)


@pytest.mark.cuda
def test_cuda_tri_solve_lt_blocked_nan_diagonal(cuda):
    """A NaN pivot Lⱼⱼ (what K6 leaves for a non-SPD chain) makes xⱼ and
    every x before it NaN, in K7 as in the twin; x after it and the other
    chains stay finite and agree."""
    rng = np.random.RandomState(3)
    b, r, j = 8, 200, 120
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(np.float32)
    chol[2, j, j] = np.nan
    z = rng.randn(b, r).astype(np.float32)
    lg, zg = torch.as_tensor(chol, device=cuda), torch.as_tensor(z, device=cuda)
    x = chol_cuda.tri_solve_lt_blocked(lg, zg)
    x_p = chol_cuda.tri_solve_lt_plain(lg, zg)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(x), torch.isnan(x_p))
    assert torch.isnan(x[2, :j + 1]).all() and torch.isfinite(x[2, j + 1:]).all()
    fin = torch.isfinite(x_p)
    torch.testing.assert_close(x[fin], x_p[fin], **TOL)
