"""The least time of the traced target-direction assembly launches
(``target_assembly_kernel``) over their measured time, in percent.  A
launch's least time comes from the cell's shapes alone, whatever
implements it: B chains, rank r, V model vertices and the m observations
of the cell's ``direction: "target"`` ICP component; the larger of the
lower triangle's B·3m·r(r+1)/2 multiply-adds at the FP32 peak and its
bytes at the memory bandwidth (the basis read once, 4·3V·r; 32 bytes of
inputs an observation a chain; M's lower triangle and the right-hand side
written once)."""
from portbench.flops import PEAK_BYTES, PEAK_FP32_FLOPS

NAMES = ("target_assembly_kernel",)


def bound_s(chains: int, m: int, rank: int, vertices: int) -> float:
    r = rank
    flops = 2.0 * chains * 3 * m * r * (r + 1) / 2
    n_bytes = 4.0 * vertices * 3 * r + 32.0 * chains * m + 4.0 * chains * (r * (r + 1) / 2 + r)
    return max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES)


def read(view):
    secs, count = view.seconds_of(NAMES)
    m = next((c["n_points"] for c in view.cell.get("mixture", ())
              if c.get("kind") == "icp" and c.get("direction") == "target"), None)
    if not count or secs <= 0 or m is None:
        return None
    bound = bound_s(int(view.cell["chains"]), int(m), int(view.config["rank"]),
                    int(view.config["vertices"]))
    return 100.0 * count * bound / secs
