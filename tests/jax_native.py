"""The JAX package's native shortlist-index builder, built for the tests.

``icp_proposal_tpu/native/point_tri.cpp`` is the JAX package's default
index builder: ``ops/surface_index.build_surface_index`` uses it whenever
its library loads.  Its loader (``icp_proposal_tpu.native.load``) compiles
the tracked library in place when that looks older than the source, so the
tests never call it.  They compile the source with ``g++`` into a directory
of their own and hand the library to the JAX package as
``icp_proposal_tpu.native._lib``, which ``load()`` returns before it reads
the environment.

Two builds: ``LOADER_FLAGS`` are the loader's own (``-march=native`` lets
GCC contract a·b + c into an FMA); with ``NO_CONTRACTION`` added every
product and sum rounds on its own, as the port's K9/K10 and their twin do,
and d² and ids agree bitwise.  ``use_native_index(monkeypatch)`` injects
the second build in this process; a child process gets its path from
``child_env()`` and calls ``inject_from_env()``.
"""
import atexit
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "icp_proposal_tpu" / "native" / "point_tri.cpp"
LOADER_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp")
NO_CONTRACTION = ("-ffp-contract=off",)
ENV = "ICP_TEST_NATIVE_LIB"

_D = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int32)


def compile_native(out_dir: Path, flags=LOADER_FLAGS + NO_CONTRACTION,
                   name: str = "point_tri") -> Path:
    """point_tri.cpp built with ``g++ flags`` into ``out_dir/lib<name>.so``;
    skip the calling test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is missing: the JAX package's native builder cannot be built")
    out = Path(out_dir) / f"lib{name}.so"
    proc = subprocess.run([gxx, *flags, str(SRC), "-o", str(out)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return out


def bind(path) -> ctypes.CDLL:
    """The library with the argument types the JAX loader declares."""
    lib = ctypes.CDLL(str(path))
    lib.icp_shortlist_topk.argtypes = [_D, _D, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, _I32, _D]
    lib.icp_shortlist_topk.restype = None
    lib.icp_point_tri_d2.argtypes = [_D, _D, ctypes.c_int64, ctypes.c_int64, _D]
    lib.icp_point_tri_d2.restype = None
    return lib


def shortlist_topk(lib, queries, tri, k):
    """native's top-k on float64 numpy arrays → (idx [N, k'], d2 [N, k']),
    k' = min(k, F), as the JAX package's ``native.shortlist_topk`` calls it."""
    q = np.ascontiguousarray(queries, np.float64)
    t = np.ascontiguousarray(tri, np.float64)
    n, f = q.shape[0], t.shape[0]
    k = min(k, f)
    idx, d2 = np.empty((n, k), np.int32), np.empty((n, k), np.float64)
    lib.icp_shortlist_topk(q.ctypes.data_as(_D), t.ctypes.data_as(_D), n, f, k,
                           idx.ctypes.data_as(_I32), d2.ctypes.data_as(_D))
    return idx, d2


def point_tri_d2(lib, queries, tri):
    q = np.ascontiguousarray(queries, np.float64)
    t = np.ascontiguousarray(tri, np.float64)
    out = np.empty((q.shape[0], t.shape[0]), np.float64)
    lib.icp_point_tri_d2(q.ctypes.data_as(_D), t.ctypes.data_as(_D), q.shape[0],
                         t.shape[0], out.ctypes.data_as(_D))
    return out


@functools.cache
def default_build() -> Path:
    """point_tri.cpp built with the loader's flags and -ffp-contract=off,
    once a test process, into a temporary directory removed at exit."""
    out = Path(tempfile.mkdtemp(prefix="jax_native_"))
    atexit.register(shutil.rmtree, out, ignore_errors=True)
    return compile_native(out)


def use_native_index(monkeypatch):
    """The JAX package builds its shortlist index with its native builder,
    its default (the build without contraction), whatever ran before."""
    monkeypatch.setattr("icp_proposal_tpu.native._lib", bind(default_build()))


def child_env() -> dict:
    """What a child process's environment adds for ``inject_from_env``."""
    return {ENV: str(default_build())}


def inject_from_env():
    """In a child process: the library at ``$ICP_TEST_NATIVE_LIB`` becomes the
    JAX package's index builder."""
    import icp_proposal_tpu.native as jnative

    jnative._lib = bind(os.environ[ENV])
