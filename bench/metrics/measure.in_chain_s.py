"""Seconds of the program's ``measure.in_chain`` span in set-up (host
clock): the traced steps of ``launch.steps.measure_chain`` that time each
stage inside the chain, read from the program's ``measure.in_chain_s``
histogram."""

from repro_torch.obs import metrics


def read(run):
    got = metrics.snapshot().get("measure.in_chain_s")
    if not got or not got["count"]:
        return None
    return got["last"]
