"""K6 and K7 past the tiled and row kernels' ranks: ``chol_solve_streamed``
(r > 320) and ``tri_solve_lt_streamed`` (r > 512) in ``csrc/chol.cu``.

The JAX package serves every rank: its blocked Pallas kernels wherever
``pallas_chol_supported(r)`` holds (r ≤ 1,224), XLA's cholesky and
solve_triangular above.  On the CPU: the plain twins against the blocked
kernels in interpret mode at r = 321, 513, 601 (the factor; 1,224 too for
the solve) and against the XLA route at r = 1,300; a float32 replay of the
streamed factor's schedule (panels of 64 columns, the right-hand side as
row r, row tiles of 64, 32 and 16 rows, the update's depth split among
groups of a tile's threads and their sums added in group order, the 64×64
diagonal block factored as K1's 16×16 tiles with identity past the matrix,
the rows below solved against it, log det in pivot order, then the blocked
dot-form back substitution) and of the streamed solve, held to the plain
twins with non-SPD pivots in the first, a middle and the last panel, at
ranks on the panels' edges (r ≡ 0, 1, 63 mod 64); the row-tile rule; the
wrapper's constants against the source's.  On the card (marker ``cuda``):
both kernels against the twins from r = 321 to 2,048 (the panels' edges
included, with 16- and 4-byte copies), at 4,096 and at the limit
``STREAM_MAX_RANK``, NaN pivots included, and past it.

Tolerance: rtol 1e-4, atol 1e-4 on L, x and log det, as for K1/K2 — float32
factorizations that sum in different orders.  The interpret-mode blocked
kernels always work on 128 chains of lanes, so those cases keep to 2–3
chains of real data.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_chol_blocked import _pallas_blocked
from test_torch_chol_tiled import _check_nan_factor, replay_tiled
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.ops import chol_cuda

TOL = dict(rtol=1e-4, atol=1e-4)
SRC = Path(chol_cuda.__file__).resolve().parents[1] / "csrc" / "chol.cu"
P = chol_cuda.PANEL


def _spd_batch(rng, b, r):
    """SPD M = I + AAᵀ, A's entries N(0, 0.16/r), as the other chol tests
    draw them (matmul, not einsum: einsum takes seconds at these ranks)."""
    a = rng.randn(b, r, r).astype(np.float32) * (0.4 / np.sqrt(r))
    return (a @ a.transpose(0, 2, 1) + np.eye(r, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("r", [321, 513, 601])
def test_chol_plain_matches_pallas_blocked_at_rank(r):
    """Past the tiled kernel's 320, the row kernel's 512 and 600; chain 1
    not SPD."""
    rng = np.random.RandomState(r)
    b, bad, pivot = 3, 1, r // 3
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


@pytest.mark.parametrize("r", [321, 513, 601, 1224])
def test_tri_lt_plain_matches_pallas_blocked_at_rank(r):
    """Up to 1,224, the largest rank ``pallas_chol_supported`` takes."""
    import jax.numpy as jnp
    from icp_proposal_tpu.ops import chol_pallas as jcp

    assert jcp.pallas_chol_supported(r)
    rng = np.random.RandomState(10 + r)
    b = 2
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(np.float32)
    z = rng.randn(b, r).astype(np.float32)
    x_ref = np.moveaxis(np.asarray(jcp._tri_lt_blocked_call(
        jnp.moveaxis(jnp.asarray(chol), 0, 2), jnp.moveaxis(jnp.asarray(z), 0, 1),
        interpret=True)), 1, 0)
    x = chol_cuda.tri_solve_lt_blocked(torch.as_tensor(chol), torch.as_tensor(z))
    np.testing.assert_allclose(x.numpy(), x_ref, **TOL)


def test_plain_matches_the_xla_route_past_the_blocked_kernels(monkeypatch):
    """r = 1,300: the reference's kernels are forced on, yet
    ``pallas_chol_supported`` is False, so its vmapped ``chol_solve`` and
    ``tri_solve_lt`` take XLA's cholesky and solve_triangular."""
    import jax
    import jax.numpy as jnp
    from icp_proposal_tpu.ops import chol_pallas as jcp

    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    r, b = 1300, 2
    assert not jcp.pallas_chol_supported(r)
    rng = np.random.RandomState(r)
    m = _spd_batch(rng, b, r)
    rhs = rng.randn(b, r).astype(np.float32)
    z = rng.randn(b, r).astype(np.float32)
    l_ref, x_ref, ld_ref = (np.asarray(a) for a in jax.vmap(jcp.chol_solve)(
        jnp.asarray(m), jnp.asarray(rhs)))
    l, x, ld = (t.numpy() for t in chol_cuda.chol_solve(torch.as_tensor(m),
                                                         torch.as_tensor(rhs)))
    np.testing.assert_allclose(l, l_ref, **TOL)
    np.testing.assert_allclose(x, x_ref, **TOL)
    np.testing.assert_allclose(ld, ld_ref, **TOL)
    xt_ref = np.asarray(jax.vmap(jcp.tri_solve_lt)(jnp.asarray(l_ref), jnp.asarray(z)))
    xt = chol_cuda.tri_solve_lt(torch.as_tensor(l), torch.as_tensor(z))
    np.testing.assert_allclose(xt.numpy(), xt_ref, **TOL)


def replay_solve_lt(chol: torch.Tensor, v: torch.Tensor, guard: bool) -> torch.Tensor:
    """The streamed kernels' back substitution Lᵀx = v in float32, batched
    over chains: blocks of 32 columns from the last up, the sum over the
    rows below the block first, then the block's triangle a step at a time.
    ``guard`` divides by max(Lⱼⱼ, 1e-30) with NaN kept (K7)."""
    r = chol.shape[-1]
    vec = v.clone()
    for c0 in range(32 * ((r - 1) // 32), -1, -32):
        ws = min(32, r - c0)
        below = (chol[:, c0 + 32:, c0:c0 + ws] * vec[:, c0 + 32:, None]).sum(1)
        res = vec[:, c0:c0 + ws] - below
        for jj in range(ws - 1, -1, -1):
            d = chol[:, c0 + jj, c0 + jj]
            if guard:
                d = torch.where(torch.isnan(d), d, torch.clamp_min(d, 1e-30))
            xj = res[:, jj] / d
            res[:, :jj] -= chol[:, c0 + jj, c0:c0 + jj] * xj[:, None]
            res[:, jj] = xj
        vec[:, c0:c0 + ws] = res
    return vec


def replay_streamed(m: torch.Tensor, rhs: torch.Tensor):
    """The streamed K6's schedule in float32 torch, batched over chains →
    (L, x, log det), the kernel's contract.  Row r of the panel matrix is
    the right-hand side, so its row of L is y = L⁻¹·rhs."""
    b, r = m.shape[0], m.shape[1]
    a = torch.zeros(b, r + 1, r)
    a[:, :r] = torch.tril(m)  # only the lower triangle is read
    a[:, r] = rhs
    lmat = torch.zeros(b, r + 1, r)
    logsum = torch.zeros(b)
    # the float4 chunk of its stage each finished column falls in
    chunk = (torch.arange(r) % chol_cuda.STREAM_SLICE) // 4
    for j0 in range(0, r, P):
        w = min(P, r - j0)
        for p0, h in chol_cuda.streamed_row_tiles(r + 1 - j0):
            i0, i1 = j0 + p0, min(j0 + p0 + h, r + 1)
            # the update over the finished columns: the tile's groups take
            # chunk g·(4/G)…(g+1)·(4/G) − 1 of every stage, group 0 from M,
            # and their sums go to group 0's in group order
            groups = chol_cuda.STREAM_TILE_ROWS // h
            acc = a[:, i0:i1, j0:j0 + w]
            for g in range(groups):
                kg = torch.nonzero(chunk[:j0] // (4 // groups) == g)[:, 0]
                part = lmat[:, i0:i1, kg] @ lmat[:, j0:j0 + w, kg].mT
                acc = acc - part if g == 0 else acc + -part
            if p0 == 0:  # the diagonal block, identity past r, as K1's tiles
                blk = torch.eye(P).repeat(b, 1, 1)
                blk[:, :w, :w] = torch.tril(acc[:, :w])
                dfac = replay_tiled(blk, torch.zeros(b, P))[0]
                ild = 1.0 / torch.diagonal(dfac, dim1=-2, dim2=-1)
                logd = torch.log(torch.diagonal(dfac, dim1=-2, dim2=-1) ** 2)
                for j in range(w):
                    logsum = logsum + logd[:, j]
                lmat[:, j0:j0 + w, j0:j0 + w] = dfac[:, :w, :w]
                acc = acc[:, w:]
                i0 += w
            # the rows below: X·L_ddᵀ = A with the unscaled column c taken
            # off the later ones against L[col][c]/√d_c, the scale last
            x = acc.clone()
            for c in range(w):
                lc = dfac[:, c + 1:w, c] * ild[:, c:c + 1]
                x[:, :, c + 1:] -= x[:, :, c:c + 1] * lc[:, None, :]
            lmat[:, i0:i1, j0:j0 + w] = x * ild[:, None, :w]
    chol = lmat[:, :r].contiguous()
    return chol, replay_solve_lt(chol, lmat[:, r], guard=False), logsum


@pytest.mark.parametrize("r", [321, 383, 384, 401, 600, 1224])
def test_streamed_schedule_replay_matches_plain(r):
    """The replay against ``chol_solve_plain`` on 4 chains: chain 0 SPD,
    chains 1–3 not SPD from a pivot in the first panel, a middle one and
    the last one."""
    rng = np.random.RandomState(r)
    n_panels = -(-r // P)
    pivots = {1: 5, 2: P * (n_panels // 2) + 7, 3: r - 1}
    assert pivots[3] // P == n_panels - 1
    m_spd = _spd_batch(rng, 4, r)
    m = m_spd.copy()
    for chain, j in pivots.items():
        m[chain, j, j] = -1.0
    rhs = torch.as_tensor(rng.randn(4, r).astype(np.float32))
    m, m_spd = torch.as_tensor(m), torch.as_tensor(m_spd)
    chol, x, ld = replay_streamed(m, rhs)
    chol_p, x_p, ld_p = chol_cuda.chol_solve_plain(m[:1], rhs[:1])
    for got, want in ((chol, chol_p), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[:1], want, **TOL)
    assert torch.equal(torch.triu(chol[0], 1), torch.zeros_like(chol[0]))
    chol_spd = chol_cuda.chol_solve_plain(m_spd, rhs)[0]
    for chain, j in pivots.items():
        _check_nan_factor(chol[chain], x[chain], ld[chain], chol_spd[chain], j)


@pytest.mark.parametrize("r", [513, 600, 1224, 2048])
def test_streamed_solve_replay_matches_plain(r):
    """The streamed K7's solve against ``tri_solve_lt_plain`` on 3 chains,
    chain 2 with a NaN pivot Lⱼⱼ (what K6 leaves for a non-SPD chain): x
    NaN at j and before it, as in the twin."""
    rng = np.random.RandomState(r)
    b, j = 3, r // 2 + 3
    chol = np.linalg.cholesky(_spd_batch(rng, b, r).astype(np.float64)).astype(np.float32)
    chol[2, j, j] = np.nan
    z = rng.randn(b, r).astype(np.float32)
    lg, zg = torch.as_tensor(chol), torch.as_tensor(z)
    x = replay_solve_lt(lg, zg, guard=True)
    x_p = chol_cuda.tri_solve_lt_plain(lg, zg)
    assert torch.equal(torch.isnan(x), torch.isnan(x_p))
    assert torch.isnan(x[2, :j + 1]).all() and torch.isfinite(x[2, j + 1:]).all()
    fin = torch.isfinite(x_p)
    torch.testing.assert_close(x[fin], x_p[fin], **TOL)


def test_streamed_constants_match_the_kernel():
    """The wrapper's panel width, stage depth and largest row tile (the
    replay's), row-kernel limit and streamed limit are the kernel's
    ``constexpr`` constants."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SRC.read_text()))
    assert int(consts["kPanel"]) == chol_cuda.PANEL == 64
    assert int(consts["kSlice"]) == chol_cuda.STREAM_SLICE == 16  # four float4 chunks
    assert int(consts["kTileRows"]) == chol_cuda.STREAM_TILE_ROWS == 64
    assert int(consts["kRowsMaxRank"]) == chol_cuda.ROWS_MAX_RANK
    assert int(consts["kStreamMaxRank"]) == chol_cuda.STREAM_MAX_RANK
    assert chol_cuda.MAX_RANK < chol_cuda.ROWS_MAX_RANK < chol_cuda.STREAM_MAX_RANK


@pytest.mark.parametrize("n", [2, 16, 17, 18, 32, 33, 48, 49, 64, 65, 81, 97, 113, 402, 601])
def test_streamed_row_tiles(n):
    """A panel's row tiles cover its n rows in order and waste fewer than
    16 (fewer than 32 where n is 33–48: the first tile holds the diagonal
    block's min(64, n − 1) rows)."""
    tiles = chol_cuda.streamed_row_tiles(n)
    assert [p0 for p0, _ in tiles] == [sum(h for _, h in tiles[:t]) for t in range(len(tiles))]
    end = tiles[-1][0] + tiles[-1][1]
    assert n <= end < n + (32 if 32 < n <= 48 else 16)
    assert tiles[0][1] >= min(chol_cuda.PANEL, n - 1)
    assert all(h in (16, 32, 64) for _, h in tiles)


# --------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [321, 352, 383, 384, 385, 401, 513, 600, 639, 640, 641, 1024,
                               1224, 2048])
def test_cuda_streamed_kernels_match_plain(cuda, r):
    """K6 (``chol_solve`` routes past 320 to the streamed factor) and K7
    (past 512 to the streamed solve) against the twins, M's upper triangle
    junk, chains 1 and 2 not SPD from a pivot in the first and the last
    panel; then K7 fed that factor gives NaN where its twin does."""
    rng = np.random.RandomState(r)
    b = 8
    m_spd = _spd_batch(rng, b, r)
    m = m_spd.copy()
    bad = {1: 3, 2: r - 1}  # the first and the last panel
    for chain, j in bad.items():
        m[chain, j, j] = -1.0
    rhs = rng.randn(b, r).astype(np.float32)
    mg, sg, rg = (torch.as_tensor(a, device=cuda) for a in (m, m_spd, rhs))
    junk = mg + torch.triu(torch.full_like(mg, float("nan")), 1)
    n = (chol_cuda.chol_solve_blocked.launches, chol_cuda.chol_solve_streamed.launches)
    chol, x, ld = chol_cuda.chol_solve(junk, rg)
    torch.cuda.synchronize()
    assert (chol_cuda.chol_solve_blocked.launches,
            chol_cuda.chol_solve_streamed.launches) == (n[0], n[1] + 1)
    chol_p, x_p, ld_p = chol_cuda.chol_solve_plain(mg, rg)
    good = torch.ones(b, dtype=torch.bool, device=cuda)
    good[list(bad)] = False
    for got, want in ((chol, chol_p), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[good], want[good], **TOL)
    assert torch.equal(torch.triu(chol, 1), torch.zeros_like(chol))
    chol_spd = chol_cuda.chol_solve_plain(sg, rg)[0]
    for chain, j in bad.items():
        _check_nan_factor(chol[chain], x[chain], ld[chain], chol_spd[chain], j)
    z = torch.as_tensor(rng.randn(b, r).astype(np.float32), device=cuda)
    streamed = r > chol_cuda.ROWS_MAX_RANK
    counter = chol_cuda.tri_solve_lt_streamed if streamed else chol_cuda.tri_solve_lt_blocked
    n7 = counter.launches
    xt = chol_cuda.tri_solve_lt(chol, z)
    torch.cuda.synchronize()
    assert counter.launches == n7 + 1
    xt_p = chol_cuda.tri_solve_lt_plain(chol, z)
    assert torch.equal(torch.isnan(xt), torch.isnan(xt_p))
    fin = torch.isfinite(xt_p)
    torch.testing.assert_close(xt[fin], xt_p[fin], **TOL)


def _per_chain(twin, *args):
    """``twin`` on each chain alone, concatenated over chains."""
    outs = [twin(*(a[i:i + 1] for a in args)) for i in range(args[0].shape[0])]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(torch.cat(parts) for parts in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [4096, chol_cuda.STREAM_MAX_RANK])
def test_cuda_streamed_kernels_at_large_rank(cuda, r):
    """Both streamed kernels at 4,096 and at their limit ``STREAM_MAX_RANK``
    (the largest shared-memory vector and panel loop they take) on 2
    chains, chain 1 not SPD from a pivot in a middle panel, against the
    twins.  M is drawn on the card from a seeded generator (the host's
    matmul takes minutes at the limit); the twins run a chain at a time,
    since ``cholesky_solve`` on two chains of 16,384² raises on the card."""
    gen = torch.Generator(device=cuda).manual_seed(r)
    b, j = 2, r // 2 + 5
    a = torch.randn(b, r, r, generator=gen, device=cuda) * (0.4 / r ** 0.5)
    m_spd = a @ a.mT + torch.eye(r, device=cuda)
    del a
    m = m_spd.clone()
    m[1, j, j] = -1.0
    rhs = torch.randn(b, r, generator=gen, device=cuda)
    n6 = chol_cuda.chol_solve_streamed.launches
    chol, x, ld = chol_cuda.chol_solve(m, rhs)
    torch.cuda.synchronize()
    assert chol_cuda.chol_solve_streamed.launches == n6 + 1
    del m
    chol_spd, x_p, ld_p = _per_chain(chol_cuda.chol_solve_plain, m_spd, rhs)
    del m_spd
    for got, want in ((chol, chol_spd), (x, x_p), (ld, ld_p)):
        torch.testing.assert_close(got[:1], want[:1], **TOL)
    assert not torch.triu(chol[0], 1).any()
    _check_nan_factor(chol[1], x[1], ld[1], chol_spd[1], j)
    del chol_spd
    z = torch.randn(b, r, generator=gen, device=cuda)
    n7 = chol_cuda.tri_solve_lt_streamed.launches
    xt = chol_cuda.tri_solve_lt(chol, z)
    torch.cuda.synchronize()
    assert chol_cuda.tri_solve_lt_streamed.launches == n7 + 1
    xt_p = _per_chain(chol_cuda.tri_solve_lt_plain, chol, z)
    assert torch.equal(torch.isnan(xt), torch.isnan(xt_p))
    assert torch.isnan(xt[1]).all() and torch.isfinite(xt[0]).all()
    fin = torch.isfinite(xt_p)
    torch.testing.assert_close(xt[fin], xt_p[fin], **TOL)


@pytest.mark.cuda
def test_cuda_streamed_rank_limit(cuda):
    """Past ``STREAM_MAX_RANK`` both streamed kernels raise, naming the
    limit, before any launch."""
    r = chol_cuda.STREAM_MAX_RANK + 1
    m = torch.empty(1, r, r, device=cuda)
    v = torch.zeros(1, r, device=cuda)
    n6, n7 = chol_cuda.chol_solve_streamed.launches, chol_cuda.tri_solve_lt_streamed.launches
    with pytest.raises(ValueError, match=str(chol_cuda.STREAM_MAX_RANK)):
        chol_cuda.chol_solve(m, v)
    with pytest.raises(ValueError, match=str(chol_cuda.STREAM_MAX_RANK)):
        chol_cuda.tri_solve_lt(m, v)
    assert (chol_cuda.chol_solve_streamed.launches,
            chol_cuda.tri_solve_lt_streamed.launches) == (n6, n7)
