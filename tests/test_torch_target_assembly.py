"""The ICP target direction's assembly kernel (``ops/assemble_cuda``): its
plain twin against a float64 reference written out here, which steps reach
it through ``models/gpmm.posterior_factors_anisotropic``, its two readers
and their manifest entries; on the card, the kernel against the float64
twin and the launches of a step.
"""
import dataclasses

import chip_smoke
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch.models import gpmm as gp
from icp_proposal_tpu_torch.models.synthetic import make_icosphere, make_synthetic_gpmm
from icp_proposal_tpu_torch.ops import assemble_cuda as ac
from portbench import flops, trace
from portbench.inputs import make_inputs
from portbench.manifest import ROOT, Manifest
from portbench.run import Noise
from portbench.system import System
from portbench.tests.helpers import tiny_root

CPU = torch.device("cpu")
MAN = Manifest(ROOT)
CELLS = ("femur100.flagship.c4096", "femur400.flagship.c2048")
METRICS = ("target_assembly_ms_per_step", "target_assembly_roofline")
SIGMA_N, SIGMA_T = chip_smoke.ASSEMBLY_SIGMAS  # the flagship's ICP noise
SEED = 2 ** 31 + 26_026


def _model(rank: int):
    pts, cells = make_icosphere(3 if rank > 40 else 2)
    return make_synthetic_gpmm(pts, cells, rank=rank, device="cpu")


def _observations(model, bsz: int, m: int, seed: int, dtype=torch.float32):
    """ids [B, m] int32 drawn from a few vertices (so ids repeat), target
    points near them, unit normals [B, V, 3] and a boundary flag on about a
    third of the vertices."""
    gen = torch.Generator().manual_seed(seed)
    v = model.num_points
    pool = torch.randperm(v, generator=gen)[: max(4, m // 3)]
    ids = pool[torch.randint(0, len(pool), (bsz, m), generator=gen)].to(torch.int32)
    tp = (model.ref_points[ids.long()] + torch.randn((bsz, m, 3), generator=gen)).to(dtype)
    nrm = torch.nn.functional.normalize(torch.randn((bsz, v, 3), generator=gen,
                                                    dtype=torch.float64), dim=-1).to(dtype)
    boundary = torch.rand(v, generator=gen) < 0.35
    boundary[pool[0]] = True  # a masked observation in every chain, almost surely
    return ids, tp, nrm, boundary


def _as64(model):
    return dataclasses.replace(
        model, ref_points=model.ref_points.double(), mean_disp=model.mean_disp.double(),
        sbasis=model.sbasis.double())


def _reference_system(model, ids, tp, nrm, boundary):
    """M and rhs in float64 from the model's rows, one observation at a
    time, each with its precision as an explicit 3 × 3 matrix
    P = c·I + (a−c)·nnᵀ: M = I + Σᵢ wᵢ·QᵢᵀPᵢQᵢ and
    rhs = Σᵢ wᵢ·QᵢᵀPᵢ((tᵢ − refᵢ) − μᵢ), wᵢ 0 at a boundary vertex."""
    a, c = 1.0 / SIGMA_N ** 2, 1.0 / SIGMA_T ** 2
    r = model.rank
    m_mat = torch.eye(r, dtype=torch.float64).repeat(ids.shape[0], 1, 1)
    rhs = torch.zeros((ids.shape[0], r), dtype=torch.float64)
    for b, chain in enumerate(ids.tolist()):
        for i, v in enumerate(chain):
            if boundary is not None and bool(boundary[v]):
                continue
            n = nrm[b, v]
            p = c * torch.eye(3, dtype=torch.float64) + (a - c) * torch.outer(n, n)
            q = model.sbasis[v]  # [3, r]
            m_mat[b] += q.T @ p @ q
            rhs[b] += q.T @ p @ ((tp[b, i] - model.ref_points[v]) - model.mean_disp[v])
    return m_mat, rhs


@pytest.mark.parametrize("rank", [11, 101])
@pytest.mark.parametrize("aware", [True, False], ids=["boundary_aware", "plain"])
def test_twin_equals_posterior_factors_anisotropic_in_float64(rank, aware):
    """The plain twin, the target system's one plain form, against the
    reference above."""
    model = _as64(_model(rank))
    ids, tp, nrm, boundary = _observations(model, 3, 2 * rank, rank, torch.float64)
    bnd = boundary if aware else None
    tables = ac.target_tables(model, bnd)
    assert tables.q.shape[2] % 4 == 0 and tables.q.dtype == torch.float64
    assert torch.equal(tables.q[..., rank:], torch.zeros_like(tables.q[..., rank:]))
    m_mat, rhs = ac.target_assembly_plain(tables, ids, tp, nrm, SIGMA_N, SIGMA_T)
    want_m, want_rhs = _reference_system(model, ids, tp, nrm, bnd)
    torch.testing.assert_close(torch.tril(m_mat), torch.tril(want_m), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rhs, want_rhs, rtol=1e-12, atol=1e-12)
    w = tables.vtab[ids.long(), 3]
    assert bool((w == 0).any()) == aware and bool((w == 1).any())


def test_dispatch_on_the_cpu_is_the_twin_and_counts_nothing():
    model = _model(11)
    ids, tp, nrm, boundary = _observations(model, 2, 22, 5)
    tables = ac.target_tables(model, boundary)
    before = ac.target_assembly.launches
    got = ac.target_assembly(tables, ids, tp, nrm, SIGMA_N, SIGMA_T)
    want = ac.target_assembly_plain(tables, ids, tp, nrm, SIGMA_N, SIGMA_T)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ac.target_assembly.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    model = _model(11)
    ids, tp, nrm, boundary = _observations(model, 2, 8, 6)
    tables = ac.target_tables(model, boundary)
    with pytest.raises(ValueError):
        ac._check(tables, ids.long(), tp, nrm)
    with pytest.raises(ValueError):
        ac._check(tables, ids, tp[:, :4], nrm)
    with pytest.raises(ValueError):
        ac._check(tables._replace(rank=13), ids, tp, nrm)
    with pytest.raises(ValueError):
        ac._check(tables, ids, tp, nrm.transpose(0, 1).contiguous().transpose(0, 1))
    assert ac._check(tables, ids, tp, nrm) == (2, 8)
    with pytest.raises(RuntimeError):
        ac.target_assembly(tables, ids, tp.requires_grad_(), nrm, SIGMA_N, SIGMA_T)


# ---------------------------------------------------------------------------
# which steps call it


def _tiny_system(tmp, name, rank, chains, subdiv=None, device=CPU):
    man, cell = tiny_root(tmp, name, rank, chains, subdivisions=subdiv)
    config = man.config(cell["config"])
    return _system(cell, config, chains, device)


def _system(cell, config, chains, device):
    inputs = make_inputs(config, device)
    system = System(inputs, config, cell, device)
    rank = int(config["rank"])
    noise = Noise(SEED, device, chains, rank, [c["weight"] for c in cell["mixture"]], 0.3)
    center = torch.as_tensor(inputs["ref_points"], dtype=torch.float32).mean(0).to(device)
    carry = system.init_carry({
        "scale": torch.ones(chains, device=device),
        "rot": torch.zeros((chains, 3), device=device),
        "trans": torch.zeros((chains, 3), device=device),
        "center": center.expand(chains, 3).clone(), "coeffs": noise.init.clone()})
    return system, noise, carry


def _spy(monkeypatch):
    """Counts of the target direction's entry and of the assembly it calls."""
    calls = {"posterior_factors_anisotropic": 0, "target_assembly": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(gp, name, count(name, getattr(gp, name)))
    return calls


@pytest.mark.parametrize("name,rank,chains,subdiv,want", [
    ("femur100.flagship.c4096", 11, 3, None, 1),
    ("face200.partial.c2048", 8, 3, 2, 0),
    ("femur100.rw.c16384", 11, 3, None, 0),
], ids=["flagship", "partial", "rw"])
def test_only_the_target_direction_calls_the_assembly(tmp_path, monkeypatch, name, rank,
                                                      chains, subdiv, want):
    system, noise, carry = _tiny_system(tmp_path, name, rank, chains, subdiv)
    calls = _spy(monkeypatch)
    system.step(carry, noise=system.noise(*noise.draw()))
    assert calls == {"posterior_factors_anisotropic": want, "target_assembly": want}


# ---------------------------------------------------------------------------
# the readers and their manifest entries


def _view(ops, cell, steps=4):
    man_cell = MAN.workload(cell)
    return trace.TraceView(ops=ops, window_s=1.0, steps=steps, host_s_per_step=0.01,
                           step_s=0.1, cell=man_cell, config=MAN.config(man_cell["config"]),
                           step_flops=1e12)


KERNEL = "void target_assembly_kernel<8>(AsmParams)"
OTHERS = [("chol_solve_streamed_kernel(float const*)", 0.0, 0.5),
          ("sm80_xmma_gemm_f32f32_f32f32_f32_nt", 0.5, 0.9),
          ("assemble_anisotropic_kernel", 0.9, 1.0)]


def _closed_form(chains, m, r, v):
    return max(chains * 3 * m * r * (r + 1) / 2 * 2 / 67e12,
               (4 * v * 3 * r + chains * m * 32 + 4 * chains * (r * (r + 1) / 2 + r)) / 3.35e12)


@pytest.mark.parametrize("cell,chains,m,r,bound_ms", [
    ("femur400.flagship.c2048", 2048, 802, 401, 11.855),
    ("femur100.flagship.c4096", 4096, 202, 101, 0.3817),
])
def test_readers_match_the_kernel_and_bound_it_by_the_cells_shapes(cell, chains, m, r,
                                                                   bound_ms):
    read_ms, read_share = (MAN.reader(name) for name in METRICS)
    view = _view(OTHERS + [(KERNEL, 1.0, 1.02), ("target_assembly_kernel<4>", 2.0, 2.02)],
                 cell, steps=2)
    assert read_ms(view) == pytest.approx(20.0)
    bound = _closed_form(chains, m, r, 1622)
    assert 1e3 * bound == pytest.approx(bound_ms, rel=1e-3)
    assert read_share(view) == pytest.approx(100.0 * 2 * bound / 0.04)
    share = read_share(_view([(KERNEL, 0.0, bound / 0.5)], cell))
    assert share == pytest.approx(50.0)
    # the reader's own bound, from the cell's target component
    module = read_share.__globals__
    assert module["bound_s"](chains, m, r, 1622) == pytest.approx(bound)
    assert module["PEAK_FP32_FLOPS"] == flops.PEAK_FP32_FLOPS


@pytest.mark.parametrize("name", METRICS)
def test_readers_without_launches(name):
    read = MAN.reader(name)
    assert read(_view(OTHERS, CELLS[0])) is None
    assert read(_view([], CELLS[1])) is None


def test_manifest_finds_the_metrics_in_accepted_cells_alone():
    cells = {w["name"] for w in MAN.data["workloads"]}
    per_layer = {m["name"]: m for m in MAN.data["per_layer"]}
    assert [m["name"] for m in MAN.data["per_layer"][-2:]] == list(METRICS)
    for name in METRICS:
        m = per_layer[name]
        assert m["workloads"] == list(CELLS) and set(m["workloads"]) <= cells
        assert m["layer"] == "target assembly" and m["moves"] == "samples_per_s"
        assert m["source"] == "device_trace" and callable(MAN.reader(name))
    assert per_layer["target_assembly_roofline"]["unit"] == "%"
    for cell in cells:
        names = {m["name"] for m in MAN.metrics_for(cell, "per_layer")}
        assert (set(METRICS) <= names) == (cell in CELLS)
        if cell in CELLS:
            target = [c for c in MAN.workload(cell)["mixture"]
                      if c["kind"] == "icp" and c["direction"] == "target"]
            assert len(target) == 1


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r", [51, 101, 201, 401])
@pytest.mark.parametrize("bsz", [1, 3, 2048])
def test_cuda_kernel_matches_the_float64_twin(cuda, r, bsz):
    """The lower triangle of M and rhs within float32's rounding of the sum
    (the kernel adds the 3m terms in its own order, each product rounded
    once; ``chip_smoke.assembly_error_share``).  A second launch gives the
    same bits."""
    m = 2 * r if bsz < 2048 else 2 * r - 3  # ragged: m not a multiple of a stage
    tables, ids, tp, nrm = chip_smoke.assembly_inputs(torch, cuda, r * 7 + bsz, bsz, m, r, 300)
    before = ac.target_assembly.launches
    got = ac.target_assembly(tables, ids, tp, nrm, SIGMA_N, SIGMA_T)
    again_m, again_rhs = ac.target_assembly(tables, ids, tp, nrm, SIGMA_N, SIGMA_T)
    torch.cuda.synchronize()
    assert ac.target_assembly.launches == before + 2
    lower = torch.tril(torch.ones((r, r), dtype=torch.bool, device=cuda))
    assert torch.equal(got[0][:, lower], again_m[:, lower]) and torch.equal(got[1], again_rhs)
    step = 64 if r > 200 else 512
    for lo in range(0, bsz, step):
        share = chip_smoke.assembly_error_share(torch, tables, ids, tp, nrm, got, lo,
                                                min(bsz, lo + step))
        assert share <= 1.0, share
    masked = tables.vtab[ids.long(), 3] == 0
    assert bool(masked.any()) and bool((~masked).any())


def _card_step(dev, cell_name, chains):
    from icp_proposal_tpu_torch.ops import chol_cuda

    cell = dict(MAN.workload(cell_name), chains=chains)
    config = MAN.config(cell["config"])
    system, noise, carry = _system(cell, config, chains, dev)
    fns = {"target_assembly": ac.target_assembly, "chol_solve": chol_cuda.chol_solve,
           "chol_solve_streamed": chol_cuda.chol_solve_streamed}
    before = {k: f.launches for k, f in fns.items()}
    system.step(carry, noise=system.noise(*noise.draw()))
    torch.cuda.synchronize()
    return {k: f.launches - before[k] for k, f in fns.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,factor", [("femur100.flagship.c4096", "chol_solve"),
                                         ("femur400.flagship.c2048", "chol_solve_streamed")])
def test_cuda_flagship_step_launches_the_kernel_once(cuda, cell, factor):
    launched = _card_step(cuda, cell, 256)
    assert launched["target_assembly"] == 1 and launched[factor] == 2


@pytest.mark.cuda
def test_cuda_face_step_launches_it_never(cuda, tmp_path):
    system, noise, carry = _tiny_system(tmp_path, "face200.partial.c2048", 8, 16, 2, cuda)
    before = ac.target_assembly.launches
    system.step(carry, noise=system.noise(*noise.draw()))
    torch.cuda.synchronize()
    assert ac.target_assembly.launches == before
