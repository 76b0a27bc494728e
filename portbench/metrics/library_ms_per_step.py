"""Device ms a step of every operation that is not a kernel of the port's
CUDA library (cuBLAS, elementwise, gathers, reductions, copies): the
posterior assembly, the decode, the densities and the evaluator's
arithmetic.  The library's kernels are the ``__global__`` functions of
``icp_proposal_tpu_torch/csrc``."""


def read(view):
    if not view.ops:
        return None
    secs = sum(e - s for name, s, e in view.ops
               if not any(k in name for k in view.library_kernels))
    return 1e3 * secs / view.steps
