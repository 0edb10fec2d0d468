"""The unprofiled window's model FLOPs (the frozen count of
``bench/flops.py``) per second over one H100's bf16 peak, in %."""

from bench.peaks import BF16_TENSOR_FLOPS


def read(run):
    w = run.window
    if not w["steps"]:
        return None
    return (100.0 * run.flops_per_step * w["steps"] / w["seconds"]
            / BF16_TENSOR_FLOPS)
