"""The port's MH step against the JAX package's, at the full stand-in width.

The stand-in femur workload (GPMM-100 built on artifacts/posterior/mean.stl,
rank 101; target artifacts/posterior/map.stl) is built once by the JAX
package; the port starts from the same arrays through ``convert.py``.  The
JAX step runs its Pallas kernels in interpret mode (ICP_TPU_FORCE_PALLAS=1,
ICP_TPU_FORCE_CHOL_PALLAS=1, shortlist index on), the port its plain twins.
Each port step starts from the JAX carry and takes the JAX step's own noise.
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

from icp_proposal_tpu_torch import convert
from icp_proposal_tpu_torch.apps import femur as pfemur
from icp_proposal_tpu_torch.sampling import mh as pmh

REPO = Path(__file__).resolve().parents[1]
STANDIN = REPO / "artifacts" / "posterior"
N_CHAINS, N_STEPS = 4, 5


def _jax_standin(monkeypatch):
    """The JAX flagship setup on the stand-in, kernels forced on."""
    monkeypatch.setenv("ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("ICP_TPU_FORCE_CHOL_PALLAS", "1")
    monkeypatch.setenv("ICP_TPU_NO_NATIVE", "1")
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
    return data, jfemur.make_icp_proposal_setup(data)


def _port_standin(jdata, fuse=True):
    model = convert.gpmm_from_arrays(**{k: np.asarray(v) for k, v in
                                        jdata.model._asdict().items()}, device="cpu")
    data = pfemur.FemurData(
        model=model, target=jdata.target,
        target_boundary_mask=jdata.target_boundary_mask,
        model_boundary_mask=jdata.model_boundary_mask)
    ctx, mixture, evaluator = pfemur.make_icp_proposal_setup(data)
    step = pmh.make_mh_step(model, mixture, evaluator, store_params=True, fuse=fuse)
    return model, ctx, mixture, evaluator, step


def _port_carry(jc):
    st = jc.state
    state = convert.state_from_arrays(
        *(np.asarray(x) for x in (st.scale, st.rot, st.trans, st.center, st.coeffs)),
        device="cpu")
    return convert.carry_from_arrays(
        state, np.asarray(jc.log_post), np.asarray(jc.named),
        [tuple(np.asarray(a) for a in f) for f in jc.icp_factors], device="cpu")


def test_one_step_parity_full_width(monkeypatch):
    """Rank 101, 4 chains, 5 steps: same proposal index, same accept
    decision wherever |log α − log u| > 1e-3, log_post to rtol 1e-4."""
    from icp_proposal_tpu.sampling import mh as jmh
    from icp_proposal_tpu.sampling.state import init_state as jinit_state

    jdata, (jctx, jmix, jev) = _jax_standin(monkeypatch)
    model, ctx, mixture, evaluator, step = _port_standin(jdata)
    r = model.rank
    assert r == 101
    # the port builds the same context and index as the reference
    np.testing.assert_array_equal(ctx.cells.numpy(), jctx.cells)
    np.testing.assert_array_equal(ctx.index.cand.numpy(), jctx.index.cand)

    jstep = jmh.make_mh_step(jdata.model, jmix, jev, store_params=True)
    carry0 = jax.jit(lambda s: jmh.init_carry(jdata.model, jev, s, jmix))(
        jinit_state(jdata.model))
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (N_CHAINS,) + x.shape),
                          carry0)
    jstep_b = jax.jit(jax.vmap(jstep))

    def noise_of(key):  # the draws of mh.py:156 and proposals.py:585-598
        k_prop, k_sel, k_acc = jax.random.split(key, 3)
        ks = jax.random.split(k_prop, mixture.num_components)
        z = jnp.stack([jax.random.normal(k, (r,), jnp.float32) for k in ks])
        idx = jax.random.categorical(k_sel, jnp.asarray(jmix.log_weights))
        return z, idx, jnp.log(jax.random.uniform(k_acc))

    noise_b = jax.jit(jax.vmap(noise_of))
    compared = accepted = 0
    for s in range(N_STEPS):
        keys = jax.random.split(jax.random.PRNGKey(100 + s), N_CHAINS)
        jnext, jrec = jstep_b(jcarry, keys)
        z, idx, log_u = (np.array(a) for a in noise_b(keys))
        noise = pmh.StepNoise(z=torch.as_tensor(z), idx=torch.as_tensor(idx).long(),
                              log_u=torch.as_tensor(log_u))
        pnext, prec = step(_port_carry(jcarry), noise)

        np.testing.assert_array_equal(prec.proposal_idx.numpy(),
                                      np.asarray(jrec.proposal_idx))
        clear = np.abs(prec.log_alpha.numpy() - log_u) > 1e-3
        np.testing.assert_array_equal(prec.accepted.numpy()[clear],
                                      np.asarray(jrec.accepted)[clear])
        np.testing.assert_allclose(prec.log_product.numpy(),
                                   np.asarray(jrec.log_product), rtol=1e-4)
        np.testing.assert_allclose(pnext.log_post.numpy()[clear],
                                   np.asarray(jnext.log_post)[clear], rtol=1e-4)
        compared += int(clear.sum())
        accepted += int(np.asarray(jrec.accepted).sum())
        jcarry = jnext
    assert compared >= N_CHAINS * N_STEPS - 2  # near-ties are rare
    assert 0 < accepted < N_CHAINS * N_STEPS  # both decisions were exercised


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


def test_port_runs_without_jax():
    """Importing every module of the port and running a CPU step of the
    femur and the BFM partial setups leaves jax and the JAX package out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import icp_proposal_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from icp_proposal_tpu_torch.apps.bfm import load_synthetic_face_data, "
        "make_bfm_fitting_setup\n"
        "from icp_proposal_tpu_torch.apps.femur import load_standin_femur_data, "
        "make_icp_proposal_setup\n"
        "from icp_proposal_tpu_torch.sampling import mh\n"
        "from icp_proposal_tpu_torch.sampling.state import init_state\n"
        "for data, setup in ((load_standin_femur_data(device='cpu'), "
        "make_icp_proposal_setup),\n"
        "                    (load_synthetic_face_data(8, 2, device='cpu'), "
        "lambda d: make_bfm_fitting_setup(d, partial=True))):\n"
        "    ctx, mix, ev = setup(data)\n"
        "    step = mh.make_mh_step(data.model, mix, ev)\n"
        "    carry = mh.init_carry(data.model, ev, init_state(data.model, 2), mix)\n"
        "    carry, rec = step(carry, generator=torch.Generator().manual_seed(0))\n"
        "    assert torch.isfinite(carry.log_post).all()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'icp_proposal_tpu' or m.startswith('icp_proposal_tpu.')]\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
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
