"""How far the plan's predicted forward and backward
(``MemoryPlan.expected_time``) lies from the device time under the
program's ``step.forward`` and ``step.backward`` spans in the profiled
step, over the prediction, in %."""


def read(run):
    t, plan = run.trace, run.plan
    if t is None or plan is None or not plan.expected_time > 0:
        return None
    fwd, bwd = t.under.get("step.forward"), t.under.get("step.backward")
    if not fwd or not bwd:
        return None
    return 100.0 * abs(fwd + bwd - plan.expected_time) / plan.expected_time
