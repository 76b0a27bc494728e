"""Operation and byte counts, from a cell's shapes alone.

``step_flops`` is the least arithmetic one MH step of the cell needs, at 2
FLOPs a multiply-add, whatever implements it:

* the candidate's decode Qα over all V vertices: 3V·r;
* for each ICP component (its anchor is computed at every candidate): the
  symmetric product QᵀPQ over its 3m observation rows, counted once,
  3m·r(r+1)/2, and its right-hand side 3m·r; the factor r³/6; the two
  triangular solves for α̂, r²; the draw L⁻ᵀz, r²/2; and the forward and
  reverse densities' Lᵀδ, 2·r²/2;
* for each Langevin component, the gradient's product Qᵀ∂ over all
  vertices: 3V·r.

``factor_bound_s`` is the least time of one K1/K6 launch (factor and
solve of B systems of rank r): the larger of B·r³/3 FLOPs over the FP32
peak and its bytes over the memory bandwidth, counting M and the
right-hand side read once and L, α̂ and log det M written once.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def step_macs_per_chain(mixture: list, vertices: int, rank: int) -> float:
    r = rank
    macs = 3 * vertices * r
    for c in mixture:
        if c["kind"] == "icp":
            m = c["n_points"]
            macs += 3 * m * r * (r + 1) / 2 + 3 * m * r
            macs += r ** 3 / 6 + r * r + r * r / 2 + 2 * (r * r / 2)
        elif c["kind"] == "mala":
            macs += 3 * vertices * r
    return macs


def step_flops(cell: dict, config: dict) -> float:
    return 2.0 * cell["chains"] * step_macs_per_chain(
        cell["mixture"], int(config["vertices"]), int(config["rank"]))


def factor_flops(chains: int, rank: int) -> float:
    return chains * rank ** 3 / 3.0


def factor_bytes(chains: int, rank: int) -> float:
    r = rank
    return 4.0 * chains * ((r * (r + 1) / 2 + r) + (r * r + r + 1))


def factor_bound_s(chains: int, rank: int) -> float:
    return max(factor_flops(chains, rank) / PEAK_FP32_FLOPS,
               factor_bytes(chains, rank) / PEAK_BYTES)
