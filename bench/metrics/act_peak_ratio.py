"""The plan's predicted activation peak (``MemoryPlan.peak_device_mem``)
over the largest forward+backward peak a step of the window measured."""


def read(run):
    peaks = [p for p in run.fwd_bwd if p is not None]
    if run.plan is None or not peaks:
        return None
    return run.plan.peak_device_mem / max(peaks)
