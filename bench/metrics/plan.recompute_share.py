"""The plan's replayed forwards, each priced at its stage's measured
``uf``, over the plan's predicted step time (``MemoryPlan.expected_time``),
in %."""

FORWARDS = ("Fnone", "Fck", "Fall")


def read(run):
    plan = run.plan
    if plan is None or not plan.expected_time > 0:
        return None
    runs = {}
    for kind, stage in plan.schedule.ops:
        if kind in FORWARDS:
            runs[stage] = runs.get(stage, 0) + 1
    replayed = sum((n - 1) * float(plan.chain.uf[stage - 1])
                   for stage, n in runs.items())
    return 100.0 * replayed / plan.expected_time
