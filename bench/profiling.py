"""The device trace of a few steady steps, taken in two passes.

- Timed steps under ``torch.profiler`` with the device's activity alone: no
  host op is recorded, so the host runs at its own pace.  Every device
  operation's interval gives the time in which one ran (``busy_s``) against
  the steps' length on the host clock, from one synchronisation to the
  next (``window_s``); the operations that took most time; and the longest
  idle gaps, each named by the host op that launches the operation the
  device waited for (known from the second pass) and that operation.
- One more step with the host's ops and their input shapes: each kernel
  launch's device time with the shapes of the op that launched it (the
  kernel's autograd function), and the device time under each autograd
  node.  Recording the host's ops costs that step several times its own
  length, which the first pass would read as idle; device times are not
  affected.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType

TOP = 10
NAME = 120      # characters of a kernel's name kept in the breakdown


@dataclasses.dataclass
class Trace:
    steps: int                                     # timed pass
    window_s: float
    busy_s: float
    device_ops: List[list]                         # [name, seconds]
    idle_gaps: List[list]                          # [what, seconds]
    kernels: List[Tuple[str, float, float]]        # shaped pass: name, s, e
    op_shapes: Dict[str, List[list]]               # CPU op -> input shapes
    under: Dict[str, float]                        # key -> device s under it

    def kernel_seconds(self, fragments) -> List[float]:
        """Each launch's device time in the shaped step, of the kernels
        whose name holds one of ``fragments``, in order."""
        return [e - s for n, s, e in self.kernels
                if any(f in n for f in fragments)]

    @property
    def device_seconds(self) -> float:
        """Summed device time of every operation of the shaped step."""
        return sum(e - s for _, s, e in self.kernels)


def record(step: Callable[[], None], timed_steps: int,
           ops: Tuple[str, ...], sync: Callable[[], None]) -> Trace:
    """``timed_steps`` calls of ``step`` traced on the device alone, then one
    traced with host ops; ``ops`` are the host ops whose input shapes are
    kept."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    cpu = torch.profiler.ProfilerActivity.CPU
    sync()
    with torch.profiler.profile(activities=[cuda]) as timed:
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            step()
        sync()
        window_s = time.perf_counter() - t0
    with torch.profiler.profile(activities=[cpu, cuda],
                                record_shapes=True) as shaped:
        step()
        sync()
    return reduce(timed, timed_steps, window_s, shaped, ops)


def _device_events(events, skip=()):
    """``(name, start s, end s)`` of each device operation, by start."""
    return sorted(((e.name, e.time_range.start * 1e-6,
                    e.time_range.end * 1e-6) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name not in skip), key=lambda k: k[1])


def reduce(timed, steps: int, window_s: float, shaped,
           ops: Tuple[str, ...]) -> Trace:
    # the shaped step: a host range also shows on the device's timeline as
    # an annotation, which is no operation
    events = shaped.events()
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA}
    kernels = _device_events(events, ranges)
    op_shapes, launcher = defaultdict(list), defaultdict(Counter)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            continue
        if e.name in ops:
            op_shapes[e.name].append(e.input_shapes)
        for k in getattr(e, "kernels", ()):
            launcher[k.name][e.name] += 1
    under = {}
    for e in shaped.key_averages():
        t = getattr(e, "device_time_total", None)
        under[e.key] = (t if t is not None
                        else getattr(e, "cuda_time_total", 0.0)) * 1e-6
    # the timed steps
    ran = _device_events(timed.events())
    if not ran or not kernels:
        raise RuntimeError("the profiler recorded no device operation")
    busy, gaps = [], []
    for name, s, e in ran:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
            continue
        if busy:
            gaps.append((s - busy[-1][1], name))
        busy.append([s, e])
    busy_s = sum(e - s for s, e in busy)
    gaps.append((window_s - (busy[-1][1] - busy[0][0]),
                 "before the first and after the last operation"))
    by_name = defaultdict(float)
    for name, s, e in ran:
        by_name[name] += e - s

    def what(kernel: str) -> str:
        if kernel not in by_name:
            return kernel
        host = launcher.get(kernel)
        head = f"{host.most_common(1)[0][0]}: " if host else ""
        return f"{head}{kernel[:NAME]}"

    return Trace(
        steps=steps, window_s=window_s, busy_s=busy_s,
        device_ops=[[n[:NAME], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[what(n), g] for g, n in sorted(gaps, reverse=True)[:TOP]],
        kernels=kernels, op_shapes=dict(op_shapes), under=under)
