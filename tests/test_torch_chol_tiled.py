"""K1 ``chol_solve`` and K6 ``chol_solve_blocked``: the tiled right-looking
kernel both launch (``chol_solve_tiled_kernel`` in ``csrc/chol.cu``, 4 and 8
warps per chain).

On the CPU: a float32 replay of the kernel's tile schedule (identity padding
to 16⌈r/16⌉, packed lower tiles, diagonal-tile factor, the solve of the
tiles below, the trailing update, log det in pivot order, both
substitutions) held to the plain twin, and the wrapper's constants held to
the source's.  On the card (marker ``cuda``): both kernels against the twin
from r = 8 to the limit r = 320, non-SPD pivots inside a tile and on a tile
boundary, K7 fed the NaN factor, the rank limit, the launch's shared memory
and the launch counters.

Tolerance: rtol 1e-4, atol 1e-4 on L, x and log det, as for K1/K2 — float32
factorizations that sum in different orders.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.ops import chol_cuda

TOL = dict(rtol=1e-4, atol=1e-4)
T = chol_cuda.TILE
SRC = Path(chol_cuda.__file__).resolve().parents[1] / "csrc" / "chol.cu"


def _spd_batch(rng, b, r):
    a = rng.randn(b, r, r).astype(np.float32) * (0.4 / np.sqrt(r))
    return (np.einsum("bij,bkj->bik", a, a) + np.eye(r, dtype=np.float32)).astype(
        np.float32)


def _off(i, j):
    return i * (i + 1) // 2 + j


def replay_tiled(m: torch.Tensor, rhs: torch.Tensor):
    """The kernel's schedule in float32 torch, batched over chains → (L, x,
    log det), the kernel's contract."""
    b, r = m.shape[0], m.shape[1]
    nt = -(-r // T)
    rp = nt * T
    a = torch.eye(rp).repeat(b, 1, 1)
    a[:, :r, :r] = torch.tril(m)  # only the lower triangle is read
    tiles = torch.zeros(b, nt * (nt + 1) // 2, T, T)
    for i in range(nt):
        for j in range(i + 1):
            tiles[:, _off(i, j)] = a[:, i * T:(i + 1) * T, j * T:(j + 1) * T]
    logsum = torch.zeros(b)
    ild = torch.zeros(b, rp)
    nan = torch.tensor(float("nan"))
    for k in range(nt):
        # (a) the diagonal tile, 16 pivot steps; entries above stay as they were
        d = tiles[:, _off(k, k)].clone()
        for j in range(T):
            piv = d[:, j, j]
            piv = torch.where(piv > 0, piv, nan)
            s = torch.sqrt(piv)
            inv = 1.0 / s
            logsum = logsum + torch.log(piv)
            ild[:, k * T + j] = inv
            d[:, j + 1:, j] *= inv[:, None]
            d[:, j, j] = s
            col = d[:, j + 1:, j]
            d[:, j + 1:, j + 1:] -= torch.tril(col[:, :, None] * col[:, None, :])
        tiles[:, _off(k, k)] = d
        # (b) X·L_KKᵀ = A_IK for the tiles below, a column at a time
        for i in range(k + 1, nt):
            x = tiles[:, _off(i, k)].clone()
            for c in range(T):
                x[:, :, c] *= 1.0 / d[:, c, c][:, None]
                x[:, :, c + 1:] -= x[:, :, c:c + 1] * d[:, None, c + 1:, c]
            tiles[:, _off(i, k)] = x
        # (c) the trailing update
        for i in range(k + 1, nt):
            for j in range(k + 1, i + 1):
                tiles[:, _off(i, j)] -= tiles[:, _off(i, k)] @ tiles[:, _off(j, k)].mT
    full = torch.zeros(b, rp, rp)
    for i in range(nt):
        for j in range(i + 1):
            full[:, i * T:(i + 1) * T, j * T:(j + 1) * T] = tiles[:, _off(i, j)]
    lower = torch.ones(r, r, dtype=torch.bool).tril()
    chol = torch.where(lower, full[:, :r, :r], torch.zeros(()))
    res = rhs.clone()
    for j in range(r):  # L y = rhs
        res[:, j] = res[:, j] * ild[:, j]
        res[:, j + 1:] -= chol[:, j + 1:, j] * res[:, j:j + 1]
    for j in range(r - 1, -1, -1):  # Lᵀ x = y
        res[:, j] = res[:, j] * ild[:, j]
        res[:, :j] -= chol[:, j, :j] * res[:, j:j + 1]
    return chol.contiguous(), res, logsum


def _check_nan_factor(chol, x, ld, chol_spd, j):
    """The non-SPD chain: x and log det NaN; L NaN exactly on and below the
    diagonal from column j on, zeros above the diagonal, and its columns
    before j equal to the factor of the matrix before its pivot j was
    spoiled (column k of L depends on M's columns ≤ k only)."""
    r = chol.shape[-1]
    assert torch.isnan(x).all() and torch.isnan(ld)
    lower = torch.ones(r, r, dtype=torch.bool, device=chol.device).tril()
    cols = torch.arange(r, device=chol.device)[None, :] >= j
    assert torch.equal(torch.isnan(chol), lower & cols)
    assert torch.equal(chol[~lower], torch.zeros_like(chol[~lower]))
    torch.testing.assert_close(chol[:, :j], chol_spd[:, :j], **TOL)


# the spoiled pivot of each rank: inside a tile, on a tile's first and last
# column, in the padded last tile
PIVOT = {12: 5, 51: 16, 101: 70, 104: 15, 105: 100, 200: 70, 201: 192}


@pytest.mark.parametrize("r", sorted(PIVOT))
def test_tiled_schedule_replay_matches_plain(r):
    """The replay against ``chol_solve_plain`` on 3 chains, chain 1 not SPD
    from pivot ``PIVOT[r]`` on."""
    rng = np.random.RandomState(r)
    b, bad, j = 3, 1, PIVOT[r]
    m_spd = _spd_batch(rng, b, r)
    m = m_spd.copy()
    m[bad, j, j] = -1.0
    rhs = torch.as_tensor(rng.randn(b, r).astype(np.float32))
    m, m_spd = torch.as_tensor(m), torch.as_tensor(m_spd)
    chol, x, ld = replay_tiled(m, rhs)
    chol_p, x_p, ld_p = chol_cuda.chol_solve_plain(m, rhs)
    good = torch.arange(b) != bad
    for got, want in ((chol, chol_p), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[good], want[good], **TOL)
    assert torch.equal(torch.triu(chol[good], 1), torch.zeros_like(chol[good]))
    _check_nan_factor(chol[bad], x[bad], ld[bad],
                      chol_cuda.chol_solve_plain(m_spd, rhs)[0][bad], j)


def test_tiled_constants_match_the_kernel():
    """The wrapper's tile edge, rank limit and warps are the kernel's
    ``constexpr`` constants: r ≤ MAX_RANK is what the kernel's substitution
    registers (MAX_RANK / 32 residual entries a lane) and a block's 227 KB
    hold, and the warps are those the counters and the launch line report."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SRC.read_text()))
    assert int(consts["kTile"]) == chol_cuda.TILE
    assert int(consts["kMaxRank"]) == chol_cuda.MAX_RANK
    assert int(consts["kK1Warps"]) == chol_cuda.K1_WARPS
    assert int(consts["kK6Warps"]) == chol_cuda.K6_WARPS
    assert chol_cuda.MAX_RANK % 32 == 0


# --------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


KERNELS = {"K1": lambda m, rhs: chol_cuda.chol_solve(m, rhs, blocked=False),
           "K6": chol_cuda.chol_solve_blocked}
COUNTERS = {"K1": chol_cuda.chol_solve, "K6": chol_cuda.chol_solve_blocked}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("r", [8, 51, 101, 104, 105, 200, 201, 256, 320])
def test_cuda_tiled_kernels_match_plain(cuda, kernel, r):
    """K1 (4 warps) and K6 (8 warps) against the twin, one chain not SPD;
    M's upper triangle is junk, which the kernels must not read."""
    rng = np.random.RandomState(r)
    b = 48
    m = _spd_batch(rng, b, r)
    m[5, r // 2, r // 2] = -1e3
    rhs = rng.randn(b, r).astype(np.float32)
    mg, rg = torch.as_tensor(m, device=cuda), torch.as_tensor(rhs, device=cuda)
    junk = mg + torch.triu(torch.full_like(mg, float("nan")), 1)
    n0 = COUNTERS[kernel].launches
    chol, x, ld = KERNELS[kernel](junk, rg)
    torch.cuda.synchronize()
    assert COUNTERS[kernel].launches == n0 + 1
    chol_p, x_p, ld_p = chol_cuda.chol_solve_plain(mg, rg)
    good = torch.arange(b, device=cuda) != 5
    for got, want in ((chol, chol_p), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[good], want[good], **TOL)
    assert torch.equal(torch.triu(chol, 1), torch.zeros_like(chol))
    assert torch.isnan(x[5]).all() and torch.isnan(ld[5])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, r", [("K1", 101), ("K6", 200)])
@pytest.mark.parametrize("j", [15, 16, 70])
def test_cuda_tiled_nan_pivot(cuda, kernel, r, j):
    """A pivot ≤ 0 inside a tile (j = 70) and on a tile boundary (j = 15,
    16): NaN exactly where the earlier kernels put it; then K7 (or K2) fed
    that factor gives NaN where its twin does."""
    rng = np.random.RandomState(j)
    b, bad = 16, 3
    m_spd = _spd_batch(rng, b, r)
    m = m_spd.copy()
    m[bad, j, j] = -1.0
    rhs = rng.randn(b, r).astype(np.float32)
    mg, sg, rg = (torch.as_tensor(a, device=cuda) for a in (m, m_spd, rhs))
    chol, x, ld = KERNELS[kernel](mg, rg)
    torch.cuda.synchronize()
    _check_nan_factor(chol[bad], x[bad], ld[bad], chol_cuda.chol_solve_plain(sg, rg)[0][bad],
                      j)
    good = torch.arange(b, device=cuda) != bad
    torch.testing.assert_close(ld[good], chol_cuda.chol_solve_plain(mg, rg)[2][good], **TOL)
    z = torch.as_tensor(rng.randn(b, r).astype(np.float32), device=cuda)
    xt = chol_cuda.tri_solve_lt(chol, z)
    xt_p = chol_cuda.tri_solve_lt_plain(chol, z)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(xt), torch.isnan(xt_p))
    assert torch.isnan(xt[bad]).any()
    fin = torch.isfinite(xt_p)
    torch.testing.assert_close(xt[fin], xt_p[fin], **TOL)


@pytest.mark.cuda
def test_cuda_tiled_rank_limit_and_routing(cuda):
    """r = 321 raises for K1 forced before any launch; ``chol_solve``
    routes r = 104 to K1, r = 105 and 320 to the tiled K6 and r = 321 to the
    streamed K6, and each counter moves once a call."""
    m = torch.eye(321, device=cuda).expand(2, -1, -1).contiguous()
    rhs = torch.zeros(2, 321, device=cuda)

    def counts():
        return (chol_cuda.chol_solve.launches, chol_cuda.chol_solve_blocked.launches,
                chol_cuda.chol_solve_streamed.launches)

    n1, n6, ns = counts()
    with pytest.raises(ValueError, match="320"):
        KERNELS["K1"](m, rhs)
    assert counts() == (n1, n6, ns)
    for r, want in ((104, (n1 + 1, n6, ns)), (105, (n1 + 1, n6 + 1, ns)),
                    (320, (n1 + 1, n6 + 2, ns)), (321, (n1 + 1, n6 + 2, ns + 1))):
        mr = torch.eye(r, device=cuda).expand(2, -1, -1).contiguous()
        chol, x, ld = chol_cuda.chol_solve(mr, torch.ones(2, r, device=cuda))
        torch.cuda.synchronize()
        assert counts() == want
        assert torch.equal(chol, mr) and torch.equal(ld, torch.zeros_like(ld))
        assert torch.equal(x, torch.ones_like(x))


@pytest.mark.cuda
def test_cuda_tiled_launch_fits(cuda):
    """The shared memory the launch sizes fits a block up to r = MAX_RANK
    for both warp counts and at least one chain fits an SM; at r = 200 K6
    holds 91 packed tiles, its 8 scratch tiles and two pivot vectors."""
    for warps in (chol_cuda.K1_WARPS, chol_cuda.K6_WARPS):
        for r in (1, 16, 17, 101, 200, chol_cuda.MAX_RANK):
            assert 0 < chol_cuda.tiled_smem_bytes(r, warps) <= chol_cuda.MAX_SMEM_BYTES
            assert chol_cuda.tiled_ctas_per_sm(r, warps) >= 1
        with pytest.raises(ValueError, match="320"):
            chol_cuda.tiled_smem_bytes(chol_cuda.MAX_RANK + 1, warps)
    assert chol_cuda.tiled_smem_bytes(200, chol_cuda.K6_WARPS) == \
        ((91 + 8) * T * T + 2 * 13 * T) * 4
