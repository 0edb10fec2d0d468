"""Device time under the plain attention backward (the autograd node of
``kernels/flash_attention/ops.py``) over the profiled steps' device time,
in %."""

from bench.readers import share_under


def read(run):
    return share_under(run, "_FlashAttentionBackward")
