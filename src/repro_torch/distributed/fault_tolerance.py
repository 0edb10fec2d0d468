"""Fault tolerance of a run (the port of
``repro.distributed.fault_tolerance``):

- :class:`StragglerWatchdog` tracks per-step durations; a step longer than
  ``threshold`` × the rolling median flags a straggler, and after
  ``max_flags`` consecutive flags the train loop checkpoints and stops, so
  a restart resumes from that step;
- :class:`HeartbeatRegistry` — liveness bookkeeping for hosts; ``dead()``
  lists those silent for more than ``timeout`` seconds;
- :func:`elastic_plan` — the ``(data, model)`` mesh a restart on fewer
  devices builds (``launch.train`` sizes its mesh with it).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerEvent:
    """One flagged step: its duration and the median it was held to."""

    step: int
    duration: float
    median: float


class StragglerWatchdog:
    """Flags a step longer than ``threshold`` × the median of the last
    ``window`` steps (once four are known); :attr:`should_restart` after
    ``max_flags`` flags in a row.  ``clock`` is injectable for tests."""

    def __init__(self, threshold: float = 2.0, window: int = 32,
                 max_flags: int = 3, clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.window: deque = deque(maxlen=window)
        self.max_flags = max_flags
        self.clock = clock
        self._t0: Optional[float] = None
        self.consecutive_flags = 0
        self.events: List[StragglerEvent] = []

    def step_begin(self) -> None:
        self._t0 = self.clock()

    def step_end(self, step: int) -> Optional[StragglerEvent]:
        if self._t0 is None:
            raise RuntimeError("step_end without step_begin")
        dur = self.clock() - self._t0
        self._t0 = None
        med = self.median()
        self.window.append(dur)
        if med is not None and dur > self.threshold * med:
            self.consecutive_flags += 1
            ev = StragglerEvent(step, dur, med)
            self.events.append(ev)
            return ev
        self.consecutive_flags = 0
        return None

    def median(self) -> Optional[float]:
        if len(self.window) < 4:
            return None
        s = sorted(self.window)
        return s[len(s) // 2]

    @property
    def should_restart(self) -> bool:
        return self.consecutive_flags >= self.max_flags


class HeartbeatRegistry:
    """The last beat of each of ``hosts`` hosts; ``clock`` is injectable
    for tests."""

    def __init__(self, hosts: int, timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last: Dict[int, float] = {h: clock() for h in range(hosts)}

    def beat(self, host: int) -> None:
        self.last[host] = self.clock()

    def dead(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]


def elastic_plan(n_chips: int, model_parallel: int,
                 global_batch: int) -> Tuple[Tuple[int, ...], Tuple[str, ...], int]:
    """The largest ``(data, model)`` mesh on ``n_chips`` devices:
    ``(mesh_shape, axis_names, grad_accum_factor)``.  The model-parallel
    width is kept (the weights were sharded that way), the data axis takes
    what remains, shrunk until it divides the global batch; the
    accumulation factor is 1, as the reference's.  Raises ``ValueError``
    with fewer devices than the model-parallel width."""
    if n_chips < model_parallel:
        raise ValueError("fewer chips than the model-parallel width; "
                         "cannot restore this sharding")
    data = n_chips // model_parallel
    while global_batch % data:
        data -= 1  # the data axis must divide the global batch
    return (data, model_parallel), ("data", "model"), 1
