"""What runs across devices, and the fault tolerance of a run (one process
for now: :class:`StragglerWatchdog`)."""

from .fault_tolerance import StragglerEvent, StragglerWatchdog

__all__ = ["StragglerEvent", "StragglerWatchdog"]
