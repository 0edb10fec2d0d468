"""Seconds of ``launch.steps.measure_chain`` in set-up (host clock, the
device synchronised after it)."""


def read(run):
    return run.timings.get("measure_chain_s")
