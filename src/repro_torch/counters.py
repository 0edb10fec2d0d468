"""Kernel launch counts.

Each kernel wrapper adds one to its entry right where it launches its CUDA
kernel, and nowhere else (the plain PyTorch branch does not count), so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {}


def bump(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset() -> None:
    LAUNCHES.clear()


def snapshot() -> Dict[str, int]:
    return dict(LAUNCHES)
