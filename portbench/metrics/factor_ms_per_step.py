"""Device ms a step of the factor and solve K1/K6 (``ops/chol_cuda``:
``chol_solve_tiled_kernel``, ``chol_solve_streamed_kernel``)."""

NAMES = ("chol_solve_tiled_kernel", "chol_solve_streamed_kernel")


def read(view):
    secs, count = view.seconds_of(NAMES)
    return 1e3 * secs / view.steps if count else None
