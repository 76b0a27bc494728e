"""The port's MH step against the JAX package's, at the full stand-in width.

The stand-in femur workload (GPMM-100 built on artifacts/posterior/mean.stl,
rank 101; target artifacts/posterior/map.stl) is built once by the JAX
package; the port starts from the same arrays through ``convert.py``.  The
JAX step runs its Pallas kernels in interpret mode (ICP_TPU_FORCE_PALLAS=1,
ICP_TPU_FORCE_CHOL_PALLAS=1, shortlist index on; ICP_TPU_COARSE_MXU=1 for
the port's coarse="dot"), the port its plain twins.  Each port step starts
from the JAX carry and takes the JAX step's own noise.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_native import use_native_index
from torch_threads import one_torch_thread  # noqa: F401

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.apps import femur as pfemur
from icp_proposal_tpu_torch.sampling import mh as pmh

REPO = Path(__file__).resolve().parents[1]
STANDIN = REPO / "artifacts" / "posterior"
N_CHAINS, N_STEPS = 4, 5


def _jax_standin(monkeypatch, setup="flagship", coarse="exact", **setup_kw):
    """A JAX setup of the stand-in (flagship, parity or rw, with ``setup_kw``
    passed on), kernels forced on; coarse="dot" opts in to the dot-form
    coarse kernel."""
    monkeypatch.setenv("ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    # JAX builds its shortlist index with its native builder, its default,
    # which the port's index equals
    use_native_index(monkeypatch)
    monkeypatch.setenv("ICP_TPU_COARSE_MXU", "1" if coarse == "dot" else "0")
    from icp_proposal_tpu.apps import femur as jfemur
    from icp_proposal_tpu.io.stl import read_stl
    from icp_proposal_tpu.mesh import boundary_vertex_mask, make_mesh
    from icp_proposal_tpu.models.build_femur import build_femur_gpmm

    mp, mc = read_stl(STANDIN / "mean.stl")
    tp, tc = read_stl(STANDIN / "map.stl")
    data = jfemur.FemurData(
        model=build_femur_gpmm(mp, mc, 100), target=make_mesh(tp, tc),
        model_landmarks={}, target_landmarks={},
        target_boundary_mask=boundary_vertex_mask(tc, len(tp)),
        model_boundary_mask=boundary_vertex_mask(mc, len(mp)),
    )
    return data, jfemur.SETUPS[setup](data, **setup_kw)


def _port_standin(jdata, fuse=True, setup="flagship", coarse="exact", **setup_kw):
    model = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                        jdata.model._asdict().items()}, device="cpu")
    data = pfemur.FemurData(
        model=model, target=jdata.target,
        target_boundary_mask=jdata.target_boundary_mask,
        model_boundary_mask=jdata.model_boundary_mask)
    ctx, mixture, evaluator = pfemur.SETUPS[setup](data, coarse=coarse, **setup_kw)
    step = pmh.make_mh_step(model, mixture, evaluator, store_params=True, fuse=fuse)
    return model, ctx, mixture, evaluator, step


def _port_carry(jc):
    st = jc.state
    state = convert.state_from_arrays(
        *(np.asarray(x) for x in (st.scale, st.rot, st.trans, st.center, st.coeffs)),
        device="cpu")
    anchors = [tuple(np.asarray(a) for a in f) if isinstance(f, tuple) else np.asarray(f)
               for f in jc.icp_factors]
    adapt = [None if x is None else np.asarray(x) for x in (jc.adapt_log_scales,
                                                            jc.step_idx)]
    return convert.carry_from_arrays(
        state, np.asarray(jc.log_post), np.asarray(jc.named), anchors, *adapt,
        device="cpu")


def _assert_gradients_match(got, want):
    """MALA gradients: rtol 1e-4 where |g| > 1, atol 1e-4 below; the
    entries zeroed as non-finite are the same ones."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got == 0, want == 0)
    big = np.abs(want) > 1
    np.testing.assert_allclose(got[big], want[big], rtol=1e-4, atol=0)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0, atol=1e-4)


def _step_parity(monkeypatch, setup, coarse, n_steps, **setup_kw):
    """n_steps of N_CHAINS chains of one setup (``setup_kw`` passed to both
    packages' setup functions) in both packages from the
    same carry with the same noise: same proposal index, same accept
    decision wherever |log α − log u| > 1e-3, log_post to rtol 1e-4; with
    scale adaptation the step counts exactly and the log-scales to atol
    1e-6 where the accept probability is clipped at 1, elsewhere plus the
    change that log α's 1e-3 slack makes to the update; with MALA
    components the gradient at each JAX carry's state against
    ``jax.vmap(jax.grad(log π))`` (``_assert_gradients_match``) →
    (decisions compared, steps accepted)."""
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.proposals import MalaComponent as JMala
    from icp_proposal_tpu.sampling.state import init_state as jinit_state

    jdata, (jctx, jmix, jev) = _jax_standin(monkeypatch, setup, coarse, **setup_kw)
    model, ctx, mixture, evaluator, step = _port_standin(jdata, setup=setup,
                                                         coarse=coarse, **setup_kw)
    r = model.rank
    assert r == 101
    assert mixture.names == jmix.names
    assert getattr(mixture, "parity", False) == getattr(jmix, "parity", False)
    assert (None if mixture.adapt is None else vars(mixture.adapt)) == (
        None if jmix.adapt is None else vars(jmix.adapt))
    # the port builds the same context and index as the reference
    np.testing.assert_array_equal(ctx.cells.numpy(), jctx.cells)
    np.testing.assert_array_equal(ctx.index.cand.numpy(), jctx.index.cand)
    assert ctx.index.coarse == coarse

    jstep = jmh.make_mh_step(jdata.model, jmix, jev, store_params=True)
    carry0 = jax.jit(lambda s: jmh.init_carry(jdata.model, jev, s, jmix))(
        jinit_state(jdata.model))
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (N_CHAINS,) + x.shape),
                          carry0)
    jstep_b = jax.jit(jax.vmap(jstep))
    # JAX's MALA anchor: jax.grad of its bound log π, non-finite entries 0
    mala = {i: jax.jit(jax.vmap(lambda st, c=c: c.factors(st, None, None)))
            for i, c in jmix.icp_components.items() if isinstance(c, JMala)}

    def noise_of(key):  # the draws of mh.py:156 and proposals.py:585-598
        k_prop, k_sel, k_acc = jax.random.split(key, 3)
        ks = jax.random.split(k_prop, mixture.num_components)
        z = jnp.stack([jax.random.normal(k, (r,), jnp.float32) for k in ks])
        idx = jax.random.categorical(k_sel, jnp.asarray(jmix.log_weights))
        return z, idx, jnp.log(jax.random.uniform(k_acc))

    noise_b = jax.jit(jax.vmap(noise_of))
    compared = accepted = 0
    for s in range(n_steps):
        keys = jax.random.split(jax.random.PRNGKey(100 + s), N_CHAINS)
        jnext, jrec = jstep_b(jcarry, keys)
        z, idx, log_u = (np.array(a) for a in noise_b(keys))
        noise = pmh.StepNoise(z=torch.as_tensor(z), idx=torch.as_tensor(idx).long(),
                              log_u=torch.as_tensor(log_u))
        pcarry = _port_carry(jcarry)
        pnext, prec = step(pcarry, noise)

        np.testing.assert_array_equal(prec.proposal_idx.numpy(),
                                      np.asarray(jrec.proposal_idx))
        clear = np.abs(prec.log_alpha.numpy() - log_u) > 1e-3
        np.testing.assert_array_equal(prec.accepted.numpy()[clear],
                                      np.asarray(jrec.accepted)[clear])
        np.testing.assert_allclose(prec.log_product.numpy(),
                                   np.asarray(jrec.log_product), rtol=1e-4)
        np.testing.assert_allclose(pnext.log_post.numpy()[clear],
                                   np.asarray(jnext.log_post)[clear], rtol=1e-4)
        if mixture.adapt is not None:
            # atol 1e-6, plus what the decisions' own 1e-3 slack on log α
            # moves the update γ·min(1, e^{log α}) by; 0 where the accept
            # probability is clipped at 1
            cfg = mixture.adapt
            p_acc = np.exp(np.minimum(prec.log_alpha.numpy(), 0.0))
            gamma = cfg.rate / (1.0 + pcarry.step_idx.numpy()) ** cfg.decay
            slack = 1e-6 + gamma * np.where(p_acc < 1.0, p_acc * np.expm1(1e-3), 0.0)
            diff = np.abs(pnext.adapt_log_scales.numpy()
                          - np.asarray(jnext.adapt_log_scales))
            assert np.all(diff <= slack[:, None]), (diff, slack)
            np.testing.assert_array_equal(pnext.step_idx.numpy(),
                                          np.asarray(jnext.step_idx))
        for i, jgrad in mala.items():
            _assert_gradients_match(mixture.icp_components[i].factors(pcarry.state),
                                    jgrad(jcarry.state))
        compared += int(clear.sum())
        accepted += int(np.asarray(jrec.accepted).sum())
        jcarry = jnext
    return compared, accepted


def test_one_step_parity_full_width(monkeypatch):
    """Rank 101, 4 chains, 5 steps of the flagship setup: same proposal
    index, same accept decision wherever |log α − log u| > 1e-3, log_post to
    rtol 1e-4."""
    compared, accepted = _step_parity(monkeypatch, "flagship", "exact", N_STEPS)
    assert compared >= N_CHAINS * N_STEPS - 2  # near-ties are rare
    assert 0 < accepted < N_CHAINS * N_STEPS  # both decisions were exercised


@pytest.mark.parametrize("setup, coarse", [("parity", "exact"), ("rw", "exact"),
                                           ("flagship", "dot")])
def test_one_step_parity_full_width_setups(monkeypatch, setup, coarse):
    """As ``test_one_step_parity_full_width`` for the reference's parity
    density (independent ICP subsets), the random walk, and the flagship
    with the dot-form coarse pass (JAX: ICP_TPU_COARSE_MXU=1), 4 chains ×
    2 steps each."""
    compared, _ = _step_parity(monkeypatch, setup, coarse, 2)
    assert compared >= N_CHAINS * 2 - 1


def test_one_step_parity_random_walk_options(monkeypatch):
    """The random walk with two step sizes (two mixture components) and an
    evaluator σ of 3, passed to both packages' ``make_random_walk_setup``:
    one step of 4 chains agrees as above."""
    compared, _ = _step_parity(monkeypatch, "rw", "exact", 1, shape_steps=(0.05, 0.2),
                               sigma_eval=3.0)
    assert compared >= N_CHAINS - 1


@pytest.mark.parametrize("name", ["femur.make_random_walk_setup",
                                  "bfm.make_bfm_fitting_setup",
                                  "femur.make_icp_proposal_setup",
                                  "femur.make_hybrid_setup",
                                  "femur.make_mala_setup",
                                  "femur.make_random_walk_adapt_setup",
                                  "bfm.run_bfm_fitting",
                                  "registration.icp_fitting.icp_surface_fitting",
                                  "femur.run_deterministic_icp",
                                  "femur.load_femur_data",
                                  "femur_experiments.run_std_icp_vs_chain_comparison",
                                  "femur_experiments.run_random_init_comparison",
                                  "align_shapes.align_shapes", "bfm.align_scan",
                                  "bfm.prepare_bfm_dataset", "bfm.load_bfm_data",
                                  "models.build_face.build_face_gpmm",
                                  "ops.decimate.decimate", "ops.decimate.decimate_gpmm",
                                  "io.ply.read_ply", "io.ply.write_ply",
                                  "io.scalar_field.write_scalar_field_ply",
                                  "utils.config.build_from_config",
                                  "analysis.replay.replay_states",
                                  "analysis.replay.replay_meshes",
                                  "analysis.replay.posterior_analysis",
                                  "analysis.posterior_variability.variability_map_total",
                                  "analysis.posterior_variability.variability_map_normal",
                                  "parallel.runner.run_sharded_chains",
                                  "parallel.runner.make_chain_mesh",
                                  "parallel.distributed.chains_for_host",
                                  "parallel.distributed.initialize_distributed",
                                  "sampling.diagnostics.pooled_split_rhat",
                                  "sampling.diagnostics.pooled_ess"])
def test_setup_signatures_match_the_reference(name):
    """A caller with the reference's signature can call the port's setup
    functions and entry points: the same parameter names, order and
    defaults, with the coarse pass (``coarse``), the device (``device``),
    the workload (``data``) and the injected randomness (``generator``,
    ``flips``, ``draws``) as the port's only extras.  One rename: the pooled
    diagnostics take a process ``group`` where JAX takes a mesh
    ``axis_name`` (both default None).  A bare module name is one of
    ``apps``."""
    import importlib
    import inspect

    mod, fn = name.rsplit(".", 1)
    mod = mod if "." in mod else f"apps.{mod}"
    ref = inspect.signature(getattr(importlib.import_module(
        f"icp_proposal_tpu.{mod}"), fn)).parameters
    port = inspect.signature(getattr(importlib.import_module(
        f"icp_proposal_tpu_torch.{mod}"), fn)).parameters
    if fn.startswith("pooled_"):
        ref = {("group" if p == "axis_name" else p): v.replace(name="group")
               if p == "axis_name" else v for p, v in ref.items()}
    extras = {"coarse", "device", "data", "generator", "flips", "draws"} - set(ref)
    assert set(port) - set(ref) <= extras
    assert [p for p in port if p not in extras] == list(ref)
    for p in ref:
        assert port[p].default == ref[p].default, p
        assert port[p].kind == ref[p].kind, p


def test_recommended_setup_and_adapt(monkeypatch):
    """``recommended_setup()`` names the reference's recommendation;
    ``SETUPS`` has the reference's six keys and each builds on the stand-in;
    ``rw-adapt`` and ``make_random_walk_setup(adapt=True)`` build a mixture
    whose ``adapt`` equals the reference's ``AdaptConfig()`` and whose
    ``adaptable`` and ``adapt_targets`` equal the reference's."""
    from icp_proposal_tpu.apps import femur as jfemur
    from icp_proposal_tpu_torch.sampling.proposals import MixtureProgram

    assert pfemur.recommended_setup() == jfemur.recommended_setup() == "rw"
    assert sorted(pfemur.SETUPS) == sorted(jfemur.SETUPS)
    jdata, (_, jmix, _) = _jax_standin(monkeypatch, "rw-adapt")
    data = pfemur.FemurData(
        model=convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                          jdata.model._asdict().items()}, device="cpu"),
        target=jdata.target, target_boundary_mask=jdata.target_boundary_mask,
        model_boundary_mask=jdata.model_boundary_mask)
    built = {name: setup(data) for name, setup in pfemur.SETUPS.items()}
    for name, (ctx, mixture, evaluator) in built.items():
        assert isinstance(mixture, MixtureProgram), name
        assert evaluator.ctx is ctx and mixture.ctx is ctx, name
    for mixture in (built["rw-adapt"][1],
                    pfemur.make_random_walk_setup(data, adapt=True)[1]):
        assert vars(mixture.adapt) == vars(jmix.adapt)
        np.testing.assert_array_equal(mixture.adaptable, jmix.adaptable)
        np.testing.assert_array_equal(mixture.adapt_targets, jmix.adapt_targets)
    assert built["rw"][1].adapt is None
    assert built["hybrid"][1].adapt is not None and built["mala"][1].adapt is not None


def test_context_switches():
    """build_target_context takes the reference's switches and the coarse
    pass, decided once: no index (dense K5), no Morton sort, the shortlist
    width, coarse="dot"; an unknown coarse pass raises."""
    from icp_proposal_tpu_torch.io.stl import read_stl
    from icp_proposal_tpu_torch.mesh import make_mesh
    from icp_proposal_tpu_torch.sampling.context import build_target_context

    tp, tc = read_stl(STANDIN / "map.stl")
    mesh = make_mesh(tp, tc)
    plain = build_target_context(mesh, morton_faces=False, build_index=False,
                                 device="cpu")
    assert plain.index is None
    np.testing.assert_array_equal(plain.cells.numpy(), tc)
    dot = build_target_context(mesh, index_k=8, coarse="dot", device="cpu")
    assert dot.index.coarse == "dot" and dot.index.k == 8
    assert dot.index.points_aug.shape == (len(tp), 4)
    assert not np.array_equal(dot.cells.numpy(), tc)  # Morton order
    assert build_target_context(mesh, index_k=8, device="cpu").index.coarse == "exact"
    with pytest.raises(ValueError, match="coarse"):
        build_target_context(mesh, coarse="mxu", device="cpu")


def test_step_without_index_takes_the_dense_path():
    """A context built with build_index=False sends the flagship step's
    closest-point queries to the dense kernel K5 (its plain version here);
    near the surface the shortlist index is exact, so one step through
    either context gives the same candidate log posterior and decisions."""
    import dataclasses

    from icp_proposal_tpu_torch.sampling.evaluators import proximity_and_independent
    from icp_proposal_tpu_torch.sampling.proposals import MixtureProgram
    from icp_proposal_tpu_torch.sampling.state import init_state

    data = pfemur.load_standin_femur_data(device="cpu")
    ctx, mixture, evaluator = pfemur.make_icp_proposal_setup(data)
    dense = dataclasses.replace(ctx, index=None)
    d_eval = proximity_and_independent(data.model, dense, mode="model_to_target",
                                       sigma=2.0, n_points=4 * data.model.rank)
    d_mix = MixtureProgram(list(zip(mixture.weights, mixture.specs)), data.model, dense,
                           data.model_boundary_mask,
                           icp_model_ids=d_eval.model_ids("distance")[::2])
    out = []
    for mix, ev in ((mixture, evaluator), (d_mix, d_eval)):
        step = pmh.make_mh_step(data.model, mix, ev, store_params=True)
        carry = pmh.init_carry(data.model, ev, init_state(data.model, 2), mix)
        out.append(step(carry, generator=torch.Generator().manual_seed(4))[1])
    (rec_i, rec_d) = out
    assert torch.equal(rec_i.proposal_idx, rec_d.proposal_idx)
    assert torch.equal(rec_i.accepted, rec_d.accepted)
    torch.testing.assert_close(rec_d.log_product, rec_i.log_product, rtol=1e-6, atol=0)


def test_fused_step_matches_unfused():
    """One fused closest-point pass gives bitwise the same chain as the
    separate ICP and evaluator passes."""
    data = pfemur.load_standin_femur_data(device="cpu")
    ctx, mixture, evaluator = pfemur.make_icp_proposal_setup(data)
    plan = pmh._fusion_plan(mixture, evaluator)
    assert plan is not None and len(plan.icp_maps) == 1  # model direction only
    from icp_proposal_tpu_torch.sampling.state import init_state

    carry0 = pmh.init_carry(data.model, evaluator, init_state(data.model, 3),
                            mixture)
    out = []
    for fuse in (True, False):
        step = pmh.make_mh_step(data.model, mixture, evaluator, store_params=True,
                                fuse=fuse)
        carry, records = pmh.run_chains(step, carry0, 6,
                                        torch.Generator().manual_seed(3))
        out.append((carry, records))
    (cf, rf), (cu, ru) = out
    for a, b in zip(rf, ru):
        assert torch.equal(a.accepted, b.accepted)
        assert torch.equal(a.log_product, b.log_product)
        assert torch.equal(a.coeffs, b.coeffs)
    assert torch.equal(cf.log_post, cu.log_post)


def test_port_runs_without_jax(tmp_path):
    """With any import of jax or of the JAX package blocked: importing every
    module of the port (loggers, diagnostics, metrics, winding numbers,
    ``runfitting``, MALA, adaptation, ``run_bfm_fitting``, the deterministic
    ICP, the experiment harnesses and the real-femur loaders included),
    running a CPU step of the femur flagship, hybrid, MALA and adaptive
    random-walk setups and of the BFM partial setup, a short CPU
    registration run with coarse="dot", a short ``run_bfm_fitting``, a
    2-iteration ``run_deterministic_icp`` and a 2-init paper harness on a
    small sphere, a small ``build_face_gpmm`` (decimation included), a step
    of ``build_from_config(RunConfig())``, a ``posterior_analysis``, a
    statismo round trip (with ``h5py`` blocked too: the H100 host has none),
    and the evidence tools' ``validate_index`` sweep and a ``posterior_parity``
    long run on the sphere (with the repository's JAX ``tools`` package
    blocked too: the port keeps copies of what it needs) leaves jax, the JAX
    package and ``tools`` out of sys.modules."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'icp_proposal_tpu', 'h5py', 'tools'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib, pkgutil, torch\n"
        "torch.set_num_threads(1)\n"
        "import icp_proposal_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from icp_proposal_tpu_torch.apps.bfm import load_synthetic_face_data, "
        "make_bfm_fitting_setup\n"
        "from icp_proposal_tpu_torch.apps.bfm import run_bfm_fitting\n"
        "from icp_proposal_tpu_torch.apps.femur import SETUPS, load_standin_femur_data\n"
        "from icp_proposal_tpu_torch.apps.femur import run_icp_proposal_registration\n"
        "from icp_proposal_tpu_torch.sampling import mh\n"
        "from icp_proposal_tpu_torch.sampling.state import init_state\n"
        "femur, face = load_standin_femur_data(device='cpu'), "
        "load_synthetic_face_data(8, 2, device='cpu')\n"
        "for data, setup in [(femur, SETUPS[s]) for s in "
        "('flagship', 'hybrid', 'mala', 'rw-adapt')] + [\n"
        "        (face, lambda d: make_bfm_fitting_setup(d, partial=True))]:\n"
        "    ctx, mix, ev = setup(data)\n"
        "    step = mh.make_mh_step(data.model, mix, ev)\n"
        "    carry = mh.init_carry(data.model, ev, init_state(data.model, 2), mix)\n"
        "    carry, rec = step(carry, generator=torch.Generator().manual_seed(0))\n"
        "    assert torch.isfinite(carry.log_post).all()\n"
        "res, _ = run_icp_proposal_registration(2, n_chains=2, setup='flagship', "
        "coarse='dot', accept_info_interval=1, verbose=False, device='cpu')\n"
        "assert len(res.json_records) == 2\n"
        "res, _ = run_bfm_fitting(face, partial=True, num_samples=2, n_chains=2, "
        "verbose=False, device='cpu')\n"
        "assert len(res.json_records) == 2\n"
        "from icp_proposal_tpu_torch.apps.femur import FemurData, run_deterministic_icp\n"
        "from icp_proposal_tpu_torch.apps.femur_experiments import "
        "run_std_icp_vs_chain_comparison\n"
        "from icp_proposal_tpu_torch.mesh import TriangleMesh\n"
        "from icp_proposal_tpu_torch.models.gpmm import instance_points\n"
        "from icp_proposal_tpu_torch.models.synthetic import make_icosphere, "
        "make_synthetic_gpmm\n"
        "pts, cells = make_icosphere(1, 50.0)\n"
        "sm = make_synthetic_gpmm(pts, cells, rank=4, device='cpu')\n"
        "tgt = TriangleMesh(instance_points(sm, torch.full((4,), 0.5)), sm.cells)\n"
        "none = torch.zeros(len(pts), dtype=torch.bool)\n"
        "coeffs, _, _, nonfinite = run_deterministic_icp(2, verbose=False, "
        "data=FemurData(sm, tgt, none, none), device='cpu')\n"
        "assert coeffs.shape == (4,) and torch.isfinite(coeffs).all()\n"
        "log = run_std_icp_vs_chain_comparison(sm, [tgt], ['t'], none, sys.argv[1], "
        "n_inits=2, n_samples=3, verbose=False)\n"
        "assert len(log.load_log()) == 2\n"
        "from icp_proposal_tpu_torch.analysis.replay import posterior_analysis\n"
        "from icp_proposal_tpu_torch.models.build_face import build_face_gpmm\n"
        "from icp_proposal_tpu_torch.models.synthetic import make_open_patch\n"
        "from icp_proposal_tpu_torch.utils.config import RunConfig, build_from_config\n"
        "fm = build_face_gpmm(*make_open_patch(2, 0.1, 0.6), num_components=4, "
        "num_sample_points=16, decimate_to=60, device='cpu')\n"
        "assert fm.num_points == 60 and fm.rank == 4\n"
        "ctx, mix, ev = build_from_config(RunConfig(), sm, tgt, none, none)\n"
        "step = mh.make_mh_step(sm, mix, ev)\n"
        "carry = mh.init_carry(sm, ev, init_state(sm, 2), mix)\n"
        "carry, rec = step(carry, generator=torch.Generator().manual_seed(0))\n"
        "recs = [dict(status=True, rigid=[0.0] * 9, coeff=[0.1 * i] * 4, "
        "logvalue={'product': float(i)}) for i in range(3)]\n"
        "out = posterior_analysis(sm, recs, burn_in=0, take_every_n=1)\n"
        "assert out['num_samples'] == 3 and out['variability_total'].shape == (len(pts),)\n"
        "from icp_proposal_tpu_torch.io.statismo import read_statismo_gpmm, "
        "write_statismo_gpmm\n"
        "write_statismo_gpmm(sys.argv[1] + '.h5', fm)\n"
        "back = read_statismo_gpmm(sys.argv[1] + '.h5', device='cpu')\n"
        "assert torch.equal(back.basis, fm.basis) and torch.equal(back.cells, fm.cells)\n"
        "from icp_proposal_tpu_torch.tools import posterior_parity, validate_index\n"
        "sphere = FemurData(sm, tgt, none, none)\n"
        "rows = validate_index.run(sphere, ks=(8,), verbose=False)\n"
        "assert [r['k'] for r in rows] == [8] * 4\n"
        "run = posterior_parity.run_long(sphere, 'icp-exact', 2, 8, 4, 1, parity=False, "
        "step_length=0.1, noise_normal=5.0, tangential=10.0)\n"
        "assert len(run['mcse_first8']) == 4 and run['icp_acceptance'] is not None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'icp_proposal_tpu', "
        "'tools')]\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "experiments.json")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc → the build raises and writes nothing; nothing falls back."""
    from icp_proposal_tpu_torch import _build

    if _build.find_nvcc() is None:  # as on a machine without the toolkit
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_library(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library(tmp_path)
    assert list(tmp_path.iterdir()) == []
