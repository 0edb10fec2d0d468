"""Kernel launch counts, and the byte books of kernel ops run plain.

Each kernel wrapper adds one to its entry right where it launches its CUDA
kernel, and nowhere else (the plain PyTorch branch does not count), so
a run can show that its main path went through the kernels.

Off CUDA a wrapper runs its plain version through :func:`plain`, which
tells an active byte count (``launch.roofline.ByteCounter``) to book the
op as the kernel moves it — each tensor argument read once, each output
written once — in place of the plain version's own ops.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

LAUNCHES: Dict[str, int] = {}

#: the byte count active in this process, if any
_SINK: Optional[Any] = None


def bump(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset() -> None:
    LAUNCHES.clear()


def snapshot() -> Dict[str, int]:
    return dict(LAUNCHES)


def plain(name: str, fn: Callable, *args) -> Any:
    """``fn(*args)``: kernel op ``name``'s plain version, booked with the
    active byte count as the kernel would move it (not a launch)."""
    sink = _SINK
    if sink is None:
        return fn(*args)
    with sink.uncounted():
        out = fn(*args)
    sink.book(name, args, out)
    return out


@contextlib.contextmanager
def byte_sink(sink: Any):
    """Make ``sink`` the active byte count while in the block."""
    global _SINK
    _SINK = sink
    try:
        yield sink
    finally:
        _SINK = None
