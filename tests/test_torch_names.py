"""The port's public names against the JAX package's, by ``ast``.

For every module of ``icp_proposal_tpu/``, the module at the same path in
``icp_proposal_tpu_torch/`` must define each public top-level name (function,
class, assignment), each public member of each class (and ``__call__``),
and each parameter of each such function and method.  Only the
differences below may remain, each with its reason; they are the ones
``ROADMAP.md`` names under "The final name diff".  A difference that
disappears must leave this list too, so the list stays the diff.
"""
import ast
import sys
from pathlib import Path

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "icp_proposal_tpu", REPO / "icp_proposal_tpu_torch"

_KEY = "key → generator: the port draws from a torch.Generator (or takes the drawn noise)"
_TRI = "triangles/tri → the mesh: the port takes the surface's points and cells"
ALLOWED = {
    # the Pallas modules
    "module ops/chol_pallas.py":
        "the Pallas kernels K1, K2, K6, K7: csrc/chol.cu and ops/chol_cuda.py",
    "module ops/closest_point_pallas.py":
        "the Pallas kernels K3, K4, K5, K8: csrc/closest_point.cu and "
        "ops/closest_point_cuda.py",
    # the ICP_TPU_* toggles
    "name ops/closest_point.py pallas_enabled":
        "an ICP_TPU_* toggle read at trace time: the port takes explicit arguments",
    "name ops/surface_index.py shortlist_enabled":
        "an ICP_TPU_* toggle read at trace time: the port takes explicit arguments",
    # XLA-only helpers
    "name utils/profiling.py enable_compilation_cache": "XLA's compilation cache",
    "name utils/profiling.py xla_trace": "an XLA profiler trace",
    "name parallel/distributed.py raise_cpu_collective_timeouts":
        "XLA's CPU rendezvous limits: the port passes timeout= to init_process_group",
    "name utils/profiling.py ThroughputCounter": "no caller in either package",
    "name native/__init__.py load":
        "the JAX package's loader of its host library: the port builds K9/K10 with "
        "the other kernels (_build.py)",
    "name mesh.py centroid":
        "sampling/state.init_state computes the centroid on the host, as the reference does",
    "member ops/surface_index.py SurfaceIndex.cand_tri":
        "K4 reads corners by face id from SurfaceIndex.faces; cand_tri is faces[cand, :9]",
    # key → generator
    "param models/gpmm.py sample_posterior_coeffs(key)": _KEY,
    "param ops/metrics.py dice_coefficient(key)": _KEY,
    "param ops/surface_sampling.py sample_points_on_surface(key)": _KEY,
    "param registration/sampling_registration.py SamplingRegistration.runfitting(key)":
        _KEY + " seeded with seed",
    "param sampling/mh.py run_chain(key)": _KEY,
    "param sampling/mh.py run_chains(keys)": _KEY,
    "param sampling/mh.py run_chains(carries)":
        "one carry holds every chain on the batch axis; nothing is vmapped",
    "param sampling/proposals.py IcpComponent.propose(key)": _KEY,
    "param sampling/proposals.py MalaComponent.propose(key)": _KEY,
    "param sampling/proposals.py MixtureProgram.propose_all(key)": _KEY,
    # triangles/tri arguments, where the port takes the mesh
    "param ops/closest_point.py surface_distances(triangles)": _TRI,
    "param ops/closest_point.py surface_distances_auto(triangles)": _TRI,
    "param ops/closest_point.py closest_points_on_surface(triangles)": _TRI,
    "param ops/surface_index.py closest_auto(tri)": _TRI,
    "param ops/surface_index.py distances_auto(tri)": _TRI,
    # the ICP target direction's entry takes what its kernel reads
    "param models/gpmm.py posterior_factors_anisotropic(gpmm)":
        "the kernel's input: target_tables(gpmm, boundary), the padded basis and a row "
        "per vertex, built once at set-up",
    "param models/gpmm.py posterior_factors_anisotropic(obs_disp)":
        "the kernel's input: target_points, the pose-inverted points (the displacement "
        "from the tables' reference point is taken inside)",
    "param models/gpmm.py posterior_factors_anisotropic(mask)":
        "per-vertex weights in the tables (0 on the model boundary) in place of a "
        "per-observation mask",
    # the other parameter differences
    "param models/gpmm.py make_gpmm(morton_faces)":
        "no caller in either package passes it: every model's faces are in Morton order",
    "param registration/sampling_registration.py SamplingRegistration.runfitting"
    "(segment_size)":
        "no caller in either package passes it: segments are min(num_samples, "
        "accept_info_interval) steps, JAX's default",
    "param ops/surface_index.py build_surface_index(chunk)":
        "chunk bounds the JAX package's numpy fallback build; the port builds with K9 "
        "on the card (its twin on the CPU) in one pass",
    "param sampling/diagnostics.py pooled_split_rhat(axis_name)":
        "a torch.distributed process group (group=) instead of a mesh axis name",
    "param sampling/diagnostics.py pooled_ess(axis_name)":
        "a torch.distributed process group (group=) instead of a mesh axis name",
}


def _params(fn):
    return [a.arg for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs]


def _public(name):
    return not name.startswith("_") or name == "__call__"


def _definitions(path):
    """Top-level name → params (a function), {member: params or None} (a
    class) or None (an assignment)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            members = {}
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members[b.name] = _params(b)
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    members[b.target.id] = None
                elif isinstance(b, ast.Assign):
                    members.update((t.id, None) for t in b.targets
                                   if isinstance(t, ast.Name))
            out[node.name] = members
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update((t.id, None) for t in targets if isinstance(t, ast.Name))
    return out


def _missing_params(where, name, ref, port):
    if isinstance(ref, list) and isinstance(port, list):
        return {f"param {where} {name}({p})" for p in ref if p not in port}
    return set()


def name_diff():
    """Every public name, member and parameter of the JAX package that the
    port lacks at the same module path."""
    diff = set()
    for src in sorted(JAX.rglob("*.py")):
        rel = src.relative_to(JAX).as_posix()
        dst = PORT / rel
        if not dst.exists():
            diff.add(f"module {rel}")
            continue
        ref, port = _definitions(src), _definitions(dst)
        for name, info in ref.items():
            if not _public(name):
                continue
            if name not in port:
                diff.add(f"name {rel} {name}")
            elif isinstance(info, dict) and isinstance(port[name], dict):
                for member, params in info.items():
                    if not _public(member):
                        continue
                    if member not in port[name]:
                        diff.add(f"member {rel} {name}.{member}")
                    else:
                        diff |= _missing_params(rel, f"{name}.{member}", params,
                                                port[name][member])
            else:
                diff |= _missing_params(rel, name, info, port[name])
    return diff


def test_public_names_match_the_reference():
    """The port has every public name, member and parameter of the JAX
    package except the listed differences, and each listed difference is
    still one."""
    diff = name_diff()
    assert diff - set(ALLOWED) == set(), "names the port lacks without a reason"
    assert set(ALLOWED) - diff == set(), "listed differences that are gone"
    assert all(reason for reason in ALLOWED.values())


FORBIDDEN_IN_SAMPLING = ("icp_proposal_tpu_torch.ops.assemble_cuda",
                         "icp_proposal_tpu_torch.ops.chol_cuda")


def _imports(path, package):
    """The dotted names a module imports, relative imports resolved
    against its package, and for ``from a import b`` also ``a.b``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parent = parts[: len(parts) - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            names.add(base)
            names.update(f"{base}.{a.name}" for a in node.names)
    return names


def _reaches_into_ops(path, package):
    forbidden = tuple(f + "." for f in FORBIDDEN_IN_SAMPLING)
    return sorted(n for n in _imports(path, package) if (n + ".").startswith(forbidden))


def test_sampling_builds_no_posterior_system_itself(tmp_path):
    """No module under ``sampling/`` imports ``ops/assemble_cuda`` or
    ``ops/chol_cuda``: ``models/gpmm`` turns the ICP observations into
    posterior factors.  The check sees each form of such an import."""
    package = "icp_proposal_tpu_torch.sampling"
    for src in sorted((PORT / "sampling").rglob("*.py")):
        assert _reaches_into_ops(src, package) == [], src.name
    forms = ["from icp_proposal_tpu_torch.ops.chol_cuda import chol_solve",
             "from icp_proposal_tpu_torch.ops import assemble_cuda",
             "import icp_proposal_tpu_torch.ops.chol_cuda as cc",
             "from ..ops.assemble_cuda import target_assembly",
             "from ..ops import chol_cuda"]
    for k, line in enumerate(forms):
        path = tmp_path / f"m{k}.py"
        path.write_text(line + "\n")
        assert _reaches_into_ops(path, package), line
    path.write_text("from icp_proposal_tpu_torch.ops.closest_point_cuda import "
                    "nearest_vertices\nfrom ..models import gpmm\n")
    assert _reaches_into_ops(path, package) == []


def test_name_diff_sees_a_missing_name(tmp_path, monkeypatch):
    """The diff finds a public name, a member and a parameter the port
    lacks: a copy of one JAX module beside a port module without them."""
    jax_pkg, port_pkg = tmp_path / "jax", tmp_path / "port"
    jax_pkg.mkdir()
    port_pkg.mkdir()
    (jax_pkg / "m.py").write_text(
        "class A:\n    x: int\n    def f(self, a, b=1):\n        pass\n"
        "def g(key, n):\n    pass\n")
    (port_pkg / "m.py").write_text(
        "class A:\n    def f(self, a):\n        pass\n"
        "def g(generator, n):\n    pass\n")
    (jax_pkg / "gone.py").write_text("")
    monkeypatch.setattr(sys.modules[__name__], "JAX", jax_pkg)
    monkeypatch.setattr(sys.modules[__name__], "PORT", port_pkg)
    assert name_diff() == {"member m.py A.x", "param m.py A.f(b)", "param m.py g(key)",
                           "module gone.py"}


def test_added_names_match_the_reference(tmp_path):
    """The names the diff found missing, now in the port, behave as JAX's:
    ``TriangleMesh.num_points``, ``num_cells``, ``with_points`` and
    ``triangles``, ``Gpmm.reference_mesh`` and ``mean_mesh``,
    ``face_normals(normalize=)`` and ``sample_to_state(center_default=)``."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from icp_proposal_tpu import mesh as jmesh
    from icp_proposal_tpu.models import gpmm as jgp
    from icp_proposal_tpu.models.synthetic import make_icosphere
    from icp_proposal_tpu.sampling import loggers as jloggers
    from icp_proposal_tpu_torch import mesh as pmesh
    from icp_proposal_tpu_torch.models import gpmm as pgp
    from icp_proposal_tpu_torch.sampling import loggers as ploggers

    points, cells = make_icosphere(subdivisions=1, radius=50.0)
    rng = np.random.RandomState(0)
    arrays = dict(ref_points=points, cells=cells,
                  mean_disp=rng.randn(*points.shape).astype(np.float32),
                  basis=rng.randn(len(points), 3, 4).astype(np.float32),
                  variance=np.arange(4, 0, -1).astype(np.float32))
    jm, pm = jgp.make_gpmm(**arrays), pgp.make_gpmm(**arrays, device="cpu")
    for name in ("reference_mesh", "mean_mesh"):
        got, want = getattr(pm, name)(), getattr(jm, name)()
        np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
        np.testing.assert_array_equal(got.cells.numpy(), np.asarray(want.cells))

    jm_ = jmesh.make_mesh(points, cells)
    for pm_ in (pmesh.make_mesh(points, cells),
                pmesh.TriangleMesh(torch.as_tensor(points), torch.as_tensor(cells))):
        assert (pm_.num_points, pm_.num_cells) == (jm_.num_points, jm_.num_cells)
        np.testing.assert_array_equal(np.asarray(pm_.triangles()),
                                      np.asarray(jm_.triangles()))
        moved = pm_.with_points(pm_.points + 1)
        assert moved.cells is pm_.cells
        np.testing.assert_array_equal(np.asarray(moved.points), points + 1)
    for normalize in (True, False):
        np.testing.assert_allclose(
            pmesh.face_normals(torch.as_tensor(points), torch.as_tensor(cells).long(),
                               normalize=normalize).numpy(),
            np.asarray(jmesh.face_normals(jnp.asarray(points), jnp.asarray(cells),
                                          normalize=normalize)),
            rtol=1e-5, atol=1e-5)

    record = {"rigid": list(range(9)), "coeff": [0.5, -1.0]}
    want = jloggers.sample_to_state(record, center_default=np.ones(3))
    got = ploggers.sample_to_state(record, center_default=np.ones(3), device="cpu")
    for field in ("trans", "rot", "center", "coeffs"):
        np.testing.assert_array_equal(getattr(got, field)[0].numpy(),
                                      np.asarray(getattr(want, field)))
