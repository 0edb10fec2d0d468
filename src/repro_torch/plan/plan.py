"""The :class:`MemoryPlan` artifact and the budget grammar (the lean part of
``repro.plan``: no store codec, bound plans or verifier yet).

Budget grammar (shared with the JAX package's policy strings):

- ``"1.5G"``, ``"800M"``, ``"2e9"``, ``"123"`` — absolute bytes, with an
  optional K/M/G/T decimal suffix (:func:`parse_size`);
- ``"x0.5"`` — a fraction of the chain's store-all activation peak;
- ``"auto"`` — derived from launch context (device memory minus parameter,
  gradient and optimizer state).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Union

from ..core.chain import Chain
from ..core.schedule import Schedule, simulate, uses_offload
from ..core.solver import Solution

#: Default slot count for the DP discretization (paper §5.2).
DEFAULT_NUM_SLOTS = 500

_UNITS = {"K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12}
_NUMBER = r"(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
_SIZE_RE = re.compile(rf"({_NUMBER})\s*([KMGT]?)")
_FRACTION_RE = re.compile(rf"x({_NUMBER})")


class InfeasiblePlanError(MemoryError):
    """No feasible schedule exists for the request (budget too small)."""


def parse_size(spec: str) -> float:
    """A non-negative number with an optional K/M/G/T suffix (``"1.5G"`` →
    1.5e9); anything else raises."""
    m = _SIZE_RE.fullmatch(spec.strip())
    if not m:
        raise ValueError(
            f"cannot parse size {spec!r}: expected a number with an optional "
            f"K/M/G/T suffix, e.g. '1.5G', '800M', '2e9', '123'")
    return float(m.group(1)) * _UNITS.get(m.group(2), 1.0)


@dataclasses.dataclass(frozen=True)
class Budget:
    """A memory budget: absolute bytes, a fraction of the store-all peak, or
    ``auto`` (derived from launch context by the caller)."""

    kind: str           # "bytes" | "fraction" | "auto"
    value: float = 0.0

    @staticmethod
    def parse(spec: str) -> "Budget":
        spec = spec.strip()
        if spec == "auto":
            return Budget("auto")
        if spec.startswith("x"):
            m = _FRACTION_RE.fullmatch(spec)
            if not m:
                raise ValueError(
                    f"cannot parse fractional budget {spec!r}: expected "
                    f"'x' followed by a number, e.g. 'x0.5'")
            return Budget("fraction", float(m.group(1)))
        return Budget("bytes", parse_size(spec))

    def resolve(self, chain: Chain,
                auto_budget: Union[float, Callable[[], float], None] = None
                ) -> float:
        """The budget in bytes; ``auto`` needs ``auto_budget`` (a float or a
        zero-argument callable supplied by the launch path)."""
        if self.kind == "bytes":
            return self.value
        if self.kind == "fraction":
            return self.value * chain.store_all_peak()
        if auto_budget is None:
            raise ValueError(
                "auto budget needs launch context (device memory and the "
                "parameter/optimizer footprint) — pass auto_budget=, or use "
                "an explicit bytes/fraction budget")
        return float(auto_budget() if callable(auto_budget) else auto_budget)


@dataclasses.dataclass
class MemoryPlan:
    """A resolved memory plan for one chain: the recursion ``tree`` (run as
    nested checkpoints, or by the eager walker when it holds offload nodes),
    the equivalent flat ``schedule``, the solver ``solution`` (solver-backed
    policies only) and the float64 simulator's predicted makespan, device
    and host peaks and transfer stall (NaN without a profiled chain)."""

    policy: str
    schedule: Schedule
    tree: Any
    solution: Optional[Solution]
    chain: Optional[Chain]
    budget_bytes: Optional[float]
    expected_time: float
    peak_device_mem: float
    peak_host_mem: float = float("nan")
    transfer_stall: float = float("nan")

    @staticmethod
    def build(policy: str, chain: Optional[Chain], tree: Any,
              schedule: Schedule, solution: Optional[Solution] = None,
              budget_bytes: Optional[float] = None) -> "MemoryPlan":
        """Wrap a schedule with its simulator-exact predictions."""
        nan = float("nan")
        expected, peak, host_peak, stall = nan, nan, nan, nan
        if chain is not None:
            res = simulate(chain, schedule)
            if not res.valid:
                raise AssertionError(
                    f"planned schedule does not simulate: {res.error}")
            expected, peak = res.time, res.peak_mem
            host_peak, stall = res.host_peak_mem, res.transfer_stall
        return MemoryPlan(policy, schedule, tree, solution, chain,
                          budget_bytes, expected, peak, host_peak, stall)

    @property
    def length(self) -> int:
        return self.schedule.length

    @property
    def uses_offload(self) -> bool:
        """True if the schedule needs the host tier (Foff/Prefetch ops)."""
        return uses_offload(self.schedule)

    def op_counts(self) -> dict:
        counts: dict = {}
        for k, _ in self.schedule.ops:
            counts[k] = counts.get(k, 0) + 1
        return counts

    def summary(self) -> str:
        c = self.op_counts()
        ops = " ".join(f"{k}:{c[k]}" for k in
                       ("Fall", "Fck", "Fnone", "B", "Foff", "Prefetch")
                       if k in c)
        lines = [f"MemoryPlan[{self.policy}] L={self.length} stages",
                 f"  ops: {len(self.schedule)} ({ops})"]
        if self.budget_bytes is not None:
            lines.append(f"  budget: {self.budget_bytes:.6e} B")
        if self.expected_time == self.expected_time:  # not NaN
            lines.append(f"  predicted: {self.expected_time:.6e} s/iter, "
                         f"activation peak {self.peak_device_mem:.6e} B, "
                         f"host peak {self.peak_host_mem:.6e} B, "
                         f"transfer stall {self.transfer_stall:.6e} s")
        lines.append("  executor: " + ("eager offload walker (host copies)"
                                       if self.uses_offload
                                       else "nested checkpoints"))
        return "\n".join(lines)
