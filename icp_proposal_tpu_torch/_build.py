"""Build, load and launch the port's CUDA kernels.

Each source in ``csrc/`` compiles with its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -c -o <src>.o csrc/<src>.cu          (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/icp_kernels/libicp_kernels_<hash>.so *.o

``-fmad=false`` keeps every product and sum rounding on its own, as the
plain PyTorch twins do; the closest-point tie rules compare float32 values
for equality.  The library is named by a hash of the sources and flags, so
an edited source builds anew.  The build happens at first use and raises,
with the compiler's output, when ``nvcc`` is missing or fails: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from icp_proposal_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "icp_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # pointers..., ints..., floats..., stream
    "icp_chol_solve": [_P, _P, _P, _P, _P, _I, _I, _P],
    "icp_tri_solve_lt_rows": [_P, _P, _P, _I, _I, _P],
    "icp_nearest_vertices": [_P, _P, _P, _I, _I, _I, _I, _P],
    "icp_refine_shortlist": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "icp_surface_distances": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _P],
    "icp_chol_solve_blocked": [_P, _P, _P, _P, _P, _I, _I, _P],
    "icp_chol_solve_streamed": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "icp_tri_solve_lt_streamed": [_P, _P, _P, _I, _I, _P],
    "icp_coarse_nearest_dot": [_P, _P, _P, _I, _I, _I, _P],
    "icp_shortlist_topk": [_P, _P, _P, _P, _I, _I, _I, _P],
    "icp_point_tri_d2": [_P, _P, _P, _I, _I, _P],
    "icp_target_assembly": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    # (r, warps): no stream, not a launch
    "icp_chol_tiled_smem_bytes": [_I, _I],
    "icp_chol_tiled_ctas_per_sm": [_I, _I],
    # (r): no stream, not a launch
    "icp_chol_streamed_smem_bytes": [_I],
    "icp_chol_streamed_ws_floats": [_I],
    "icp_chol_streamed_ctas_per_sm": [_I],
    # (r, m, int[6] out): no stream, not a launch
    "icp_target_assembly_config": [_I, _I, _P],
    # (batch, p, v, per_chain, dot, int[5] out): no stream, not a launch
    "icp_nearest_vertices_config": [_I, _I, _I, _I, _I, _P],
    # (n_queries, int[5] out): no stream, not a launch
    "icp_refine_shortlist_config": [_I, _P],
}


def find_nvcc() -> str | None:
    """``nvcc`` on PATH, else under the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    return None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(build_dir: Path = BUILD_DIR, extra_flags: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir) / f"libicp_kernels_{h.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR, extra_flags: tuple = ()) -> tuple[Path, str]:
    """Compile the kernels unless this source hash is already built;
    ``extra_flags`` (such as ``-D`` overrides of launch choices) go to every
    compile after ``NVCC_FLAGS``.
    → (library path, compiler output; empty when nothing was compiled)."""
    out = library_path(build_dir, extra_flags)
    if out.exists():
        return out, ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "building the CUDA kernels needs nvcc (CUDA toolkit), which was "
            "not found on PATH or under CUDA_HOME"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        texts = [proc.communicate()[0] for _, proc in procs]  # all run to their end
        log = "".join(texts)
        for (cmd, proc), text in zip(procs, texts):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        tmp = os.path.join(work, out.name)
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library, built or found at the first call (the set-up
    span ``setup.kernels``); ``compiled`` on it says whether nvcc ran."""
    with span("setup.kernels"):
        path, log = build_library()
        lib = bind_library(path)
    lib.compiled = bool(log)
    return lib


def bind_library(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.icp_error_string.argtypes = [ctypes.c_int]
    lib.icp_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise on a
    non-zero ``cudaGetLastError()``."""
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.icp_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple) -> None:
    """Raise unless ``t`` has ``dtype``, is contiguous and matches ``shape``
    (None entries match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != n for s, n in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on; only ``cpu`` (plain twin) and
    ``cuda`` (kernel) are taken.  The kernels have no backward, so a tensor
    that requires grad while grad mode is on raises, on the card and on the
    CPU alike: callers stop the gradient at a kernel's inputs and recompute
    the winner from the live tensors (``surface_index.index_closest``)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("a kernel input requires grad, but the kernels have no "
                           "backward: pass it detached and recompute what must be "
                           "differentiated")
    return dev
