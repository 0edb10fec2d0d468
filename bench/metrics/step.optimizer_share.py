"""Device time under the program's ``step.optimizer`` span (AdamW with its
norms and clipping) over the profiled step's device time, in %."""

from bench.readers import share_under


def read(run):
    return share_under(run, "step.optimizer")
