"""What the per-layer readers (``bench/metrics/<metric>.py``) share.

A reader is ``read(run) -> float | None``: ``run`` holds the cell's
configuration (``conf``), the plan (``plan``, ``None`` in store-all), the
budget, the set-up timings, the window (``window``: steps and seconds of
the unprofiled steps), every step's forward+backward peak (``fwd_bwd``),
the trace of the profiled steps (``trace``, a
:class:`bench.profiling.Trace`, ``None`` without one), the model FLOPs of
a step (``flops_per_step``) and ``log``.  A reader that finds nothing to
read returns ``None`` and the metric is left out of the line."""

from bench.peaks import HBM_BYTES_PER_S


def roofline(run, kernel):
    """A kernel's share of its roofline, in %: Σ over its launches of the
    least time the card could take (bytes at the memory bandwidth or
    operations at the peak, whichever is longer) over Σ of their device
    time.  Each launch's shapes come from the CPU op that launched it, in
    order."""
    t = run.trace
    if t is None:
        return None
    shapes = t.op_shapes.get(kernel.OP, [])
    times = t.kernel_seconds(kernel.FRAGMENTS)
    if not times:
        return None
    if len(shapes) != len(times):
        run.log(f"[bench] {kernel.OP}: {len(shapes)} ops against "
                f"{len(times)} launches in the trace")
        return None
    bound = 0.0
    for s in shapes:
        nbytes, ops, peak = kernel.work(s, run.conf)
        bound += max(nbytes / HBM_BYTES_PER_S, ops / peak)
    return 100.0 * bound / sum(times)


def share_under(run, key):
    """Device time under the CPU op or autograd node ``key`` over the
    profiled steps' device time, in %."""
    t = run.trace
    if t is None or not t.under.get(key):
        return None
    return 100.0 * t.under[key] / t.device_seconds
