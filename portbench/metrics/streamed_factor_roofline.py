"""The least time of the traced streamed factor-and-solve launches
(``chol_solve_streamed_kernel``) over their measured time, in percent.  A
launch's least time is ``portbench.flops.factor_bound_s`` of the cell's
chains and rank: B·r³/3 FLOPs at the FP32 peak or M and the right-hand
side read once and L, α̂ and log det written once at the memory bandwidth,
the larger."""
from portbench.flops import factor_bound_s

NAMES = ("chol_solve_streamed_kernel",)


def read(view):
    secs, count = view.seconds_of(NAMES)
    if not count or secs <= 0:
        return None
    bound = count * factor_bound_s(int(view.cell["chains"]), int(view.config["rank"]))
    return 100.0 * bound / secs
