"""Fault tolerance on one process: the straggler watchdog (the port of
``StragglerWatchdog`` / ``StragglerEvent`` from
``repro.distributed.fault_tolerance``; the heartbeat registry and the
elastic re-mesh plan wait for the multi-device slice).

:class:`StragglerWatchdog` tracks per-step durations; a step longer than
``threshold`` × the rolling median flags a straggler, and after
``max_flags`` consecutive flags the train loop checkpoints and stops, so a
restart resumes from that step.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional


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
