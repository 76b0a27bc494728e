"""The operation and byte counts against hand counts at small r."""
import math

from portbench import flops


def icp(n):
    return {"kind": "icp", "n_points": n}


def test_decode_only():
    # 3V·r multiply-adds: V = 2, r = 3 → 18
    assert flops.step_macs_per_chain([{"kind": "shape"}], vertices=2, rank=3) == 18


def test_one_icp_component_by_hand():
    # r = 2, m = 1: QᵀPQ over 3 rows, symmetric: 3·(2·3/2) = 9; rhs 3·2 = 6;
    # factor 8/6; α̂ solves 4; draw 2; two densities 2·2 = 4; decode 3·4·2 = 24
    want = 24 + 9 + 6 + 8 / 6 + 4 + 2 + 4
    assert math.isclose(flops.step_macs_per_chain([icp(1)], vertices=4, rank=2), want)


def test_mala_adds_a_transpose_product():
    base = flops.step_macs_per_chain([{"kind": "shape"}], vertices=5, rank=3)
    assert flops.step_macs_per_chain([{"kind": "mala"}], vertices=5, rank=3) == 2 * base


def test_step_flops_scale_with_chains():
    cell = {"chains": 4, "mixture": [icp(1)]}
    config = {"vertices": 4, "rank": 2}
    assert math.isclose(flops.step_flops(cell, config),
                        2 * 4 * flops.step_macs_per_chain([icp(1)], 4, 2))


def test_factor_bound_by_hand():
    # B = 2, r = 3: flops 2·27/3 = 18; bytes: M's lower triangle 6 and the
    # right-hand side 3 in, L 9, α̂ 3 and log det 1 out: 4·2·(9 + 13) = 176
    assert flops.factor_flops(2, 3) == 18
    assert flops.factor_bytes(2, 3) == 176
    assert flops.factor_bound_s(2, 3) == max(18 / flops.PEAK_FP32_FLOPS,
                                             176 / flops.PEAK_BYTES)
    # r = 101: 5,151 + 101 in, 10,201 + 101 + 1 out, 4 bytes each
    assert flops.factor_bytes(1, 101) == 4 * (5151 + 101 + 10201 + 101 + 1)
    # the flagship's factor is bound by its bytes, rank 600 by its operations
    assert flops.factor_bound_s(2048, 101) == flops.factor_bytes(2048, 101) / flops.PEAK_BYTES
    assert flops.factor_bound_s(2048, 600) == flops.factor_flops(2048, 600) / flops.PEAK_FP32_FLOPS
