"""K1 ``chol_solve`` and K2 ``tri_solve_lt``: the port's plain twins against
the JAX package's Pallas kernels (interpret mode), and the CUDA kernels
against the plain twins where a card is present (``-k cuda``; the JAX
package is imported only by the tests that need it, so the file also
collects on a machine without JAX).

Tolerance: rtol 1e-4, atol 1e-4 on L, x and log det — float32 factorizations
that sum in different orders (the Pallas kernel updates full rows, LAPACK
works in blocks) at condition numbers of at most ~20.
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


def _pallas_chol(m, rhs):
    import jax.numpy as jnp
    from icp_proposal_tpu.ops.chol_pallas import _chol_call

    l_t, x_t, ld = _chol_call(jnp.moveaxis(jnp.asarray(m), 0, 2),
                              jnp.moveaxis(jnp.asarray(rhs), 0, 1), interpret=True)
    return (np.moveaxis(np.asarray(l_t), 2, 0), np.moveaxis(np.asarray(x_t), 1, 0),
            np.asarray(ld))


@pytest.mark.parametrize("r", [8, 101])
def test_chol_solve_plain_matches_pallas(r):
    rng = np.random.RandomState(r)
    b, bad, pivot = 5, 2, 3
    m = _spd_batch(rng, b, r)
    m[bad, pivot, pivot] = -1.0  # non-SPD: the pivot at column 3 goes ≤ 0
    rhs = rng.randn(b, r).astype(np.float32)
    l_ref, x_ref, ld_ref = _pallas_chol(m, rhs)
    l, x, ld = (t.numpy() for t in chol_cuda.chol_solve(torch.as_tensor(m),
                                                         torch.as_tensor(rhs)))
    good = np.arange(b) != bad
    np.testing.assert_allclose(l[good], l_ref[good], **TOL)
    np.testing.assert_allclose(x[good], x_ref[good], **TOL)
    np.testing.assert_allclose(ld[good], ld_ref[good], **TOL)
    assert np.all(np.triu(l[good], 1) == 0)
    # the non-SPD chain is NaN in both: the solve, the log det, and the
    # factor from the failing pivot's column on
    for lb, xb, ldb in ((l, x, ld), (l_ref, x_ref, ld_ref)):
        assert np.isnan(xb[bad]).all() and np.isnan(ldb[bad])
        assert np.isnan(np.tril(lb[bad])[pivot:, pivot:].diagonal()).all()


# K2's ranks: around the 32-row blocks of the row kernel and up to the
# monolithic limit (``uses_blocked`` sends r ≥ 105 to K7)
TRI_RANKS = [8, 31, 32, 33, 101, 104]


@pytest.mark.parametrize("r", TRI_RANKS)
def test_tri_solve_lt_plain_matches_pallas(r):
    import jax.numpy as jnp
    from icp_proposal_tpu.ops.chol_pallas import _tri_lt_call

    rng = np.random.RandomState(10 + r)
    b = 5
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(
        np.float32)
    z = rng.randn(b, r).astype(np.float32)
    x_ref = np.moveaxis(np.asarray(_tri_lt_call(
        jnp.moveaxis(jnp.asarray(chol), 0, 2), jnp.moveaxis(jnp.asarray(z), 0, 1),
        interpret=True)), 1, 0)
    x = chol_cuda.tri_solve_lt(torch.as_tensor(chol), torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(x, x_ref, **TOL)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    m = torch.eye(4).expand(2, 4, 4).contiguous()
    rhs = torch.zeros(2, 4)
    if bad == "dtype":
        m = m.double()
    elif bad == "shape":
        rhs = torch.zeros(2, 5)
    elif bad == "contiguity":
        m = m.transpose(1, 2).contiguous().transpose(1, 2)  # same shape, strided
    else:
        m, rhs = m.to("meta"), rhs.to("meta")
    with pytest.raises(ValueError):
        chol_cuda.chol_solve(m, rhs)
    with pytest.raises(ValueError):
        chol_cuda.tri_solve_lt(m, rhs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_chol_kernels_match_plain(cuda):
    """K1 and K2 on the card at the main path's width (r = 101)."""
    rng = np.random.RandomState(0)
    b, r = 64, 101
    m = _spd_batch(rng, b, r)
    m[5, 40, 40] = -1e3
    rhs = rng.randn(b, r).astype(np.float32)
    z = rng.randn(b, r).astype(np.float32)
    mg, rg, zg = (torch.as_tensor(a, device=cuda) for a in (m, rhs, z))
    n0 = chol_cuda.chol_solve.launches
    l, x, ld = chol_cuda.chol_solve(mg, rg)
    torch.cuda.synchronize()
    assert chol_cuda.chol_solve.launches == n0 + 1
    l_p, x_p, ld_p = chol_cuda.chol_solve_plain(mg, rg)
    good = torch.arange(b, device=cuda) != 5
    torch.testing.assert_close(l[good], l_p[good], **TOL)
    torch.testing.assert_close(x[good], x_p[good], **TOL)
    torch.testing.assert_close(ld[good], ld_p[good], **TOL)
    assert torch.isnan(x[5]).all() and torch.isnan(ld[5])
    xt = chol_cuda.tri_solve_lt(l[good].contiguous(), zg[good].contiguous())
    xt_p = chol_cuda.tri_solve_lt_plain(l[good].contiguous(), zg[good].contiguous())
    torch.testing.assert_close(xt, xt_p, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("r", TRI_RANKS)
def test_cuda_tri_solve_lt_row_kernel(cuda, r):
    """K2 launches the row-streaming kernel at every monolithic rank (its own
    counter moves, K7's does not) and agrees with the twin; a NaN pivot at
    j = r // 2 in chain 3 makes x NaN exactly where the twin's is (entries
    j and below), the rest finite.  37 chains: the last block holds one."""
    rng = np.random.RandomState(100 + r)
    b, bad, j = 37, 3, r // 2
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(np.float32)
    chol[bad, j, j] = np.nan
    z = rng.randn(b, r).astype(np.float32)
    lg, zg = torch.as_tensor(chol, device=cuda), torch.as_tensor(z, device=cuda)
    n2, n7 = chol_cuda.tri_solve_lt.launches, chol_cuda.tri_solve_lt_blocked.launches
    x = chol_cuda.tri_solve_lt(lg, zg)
    torch.cuda.synchronize()
    assert (chol_cuda.tri_solve_lt.launches, chol_cuda.tri_solve_lt_blocked.launches) == (
        n2 + 1, n7)
    x_p = chol_cuda.tri_solve_lt_plain(lg, zg)
    assert torch.equal(torch.isnan(x), torch.isnan(x_p))
    assert torch.isnan(x[bad, :j + 1]).all() and torch.isfinite(x[bad, j + 1:]).all()
    good = torch.arange(b, device=cuda) != bad
    assert torch.isfinite(x[good]).all()
    torch.testing.assert_close(x[good], x_p[good], **TOL)
