"""Seconds of ``launch.steps.plan_training`` in set-up (host clock): the
DP fill on K1, the schedule and the tree."""


def read(run):
    return run.timings.get("plan_s")
