"""Stage forwards the program ran in its last step (its
``remat.forward_runs`` histogram) over those the plan's schedule runs
(``Fall``, ``Fck`` and ``Fnone`` ops): 1 where the nested checkpoints run
the plan."""

from repro_torch.obs import metrics


def read(run):
    runs = metrics.snapshot().get("remat.forward_runs")
    if run.plan is None or not runs or not runs["count"]:
        return None
    planned = sum(run.plan.schedule.forward_counts().values())
    return runs["last"] / planned
