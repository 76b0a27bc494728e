"""Device ms a step of the streamed factor and solve K6
(``ops/chol_cuda.chol_solve_streamed``: ``chol_solve_streamed_kernel``),
which serves ranks past the tiled kernel's 320."""

NAMES = ("chol_solve_streamed_kernel",)


def read(view):
    secs, count = view.seconds_of(NAMES)
    return 1e3 * secs / view.steps if count else None
