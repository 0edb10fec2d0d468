"""Device time under the program's ``remat.replay`` spans (stage forwards
run again inside the backward) over that under ``step.forward`` and
``step.backward``, in %: the measured twin of ``plan.recompute_share``."""


def read(run):
    t = run.trace
    if t is None:
        return None
    replay = t.under.get("remat.replay")
    step = t.under.get("step.forward", 0.0) + t.under.get("step.backward", 0.0)
    if not replay or not step:
        return None
    return 100.0 * replay / step
