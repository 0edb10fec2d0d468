"""K4, the RMSNorm forward (``csrc/rms_norm.cu``)."""

import math

from bench.peaks import F32_FLOPS

OP = "_RMSNorm"
FRAGMENTS = ("rms_norm_kernel",)


def work(shapes, conf):
    """``(bytes, operations, peak operations/s)`` of one launch on x
    (..., d) in bf16: x read and the output written once, the scale read
    once; four float32 operations an element."""
    *lead, d = shapes[0]
    rows = math.prod(lead)
    return 2 * 2 * rows * d + 2 * d, 4 * rows * d, F32_FLOPS
