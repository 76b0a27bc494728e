"""The step's counted FLOPs (``portbench/flops.step_flops``: the least
arithmetic of decode, ICP assembly, factor, solves, draw and densities)
over the seconds a step of the untraced window takes and the H100's
published FP32 peak outside the tensor cores (67 TFLOP/s), in percent."""
from portbench.flops import PEAK_FP32_FLOPS


def read(view):
    if view.step_s <= 0:
        return None
    return 100.0 * view.step_flops / view.step_s / PEAK_FP32_FLOPS
