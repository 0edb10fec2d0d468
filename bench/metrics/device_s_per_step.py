"""Seconds in which an operation ran on the device, per step of the
timed trace: the step's device time, which the host's speed does not
move (beside ``train_tokens_per_s``, which it does)."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    return t.busy_s / t.steps
