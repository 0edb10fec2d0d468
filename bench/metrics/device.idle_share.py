"""The share of the profiled steps' span in which no operation ran on the
device, in %."""


def read(run):
    t = run.trace
    if t is None or not t.window_s > 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
