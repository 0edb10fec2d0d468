"""The :class:`MemoryPlan` artifact, its executor binding (:class:`BoundPlan`)
and the budget grammar (the part of ``repro.plan`` the port has: no store
codec, verifier or tracer yet).

Budget grammar (shared with the JAX package's policy strings):

- ``"1.5G"``, ``"800M"``, ``"2e9"``, ``"123"`` — absolute bytes, with an
  optional K/M/G/T decimal suffix (:func:`parse_size`);
- ``"x0.5"`` — a fraction of the chain's store-all activation peak;
- ``"auto"`` — derived from launch context (device memory minus parameter,
  gradient and optimizer state).
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

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


def chain_fingerprint(chain: Chain) -> str:
    """Content hash of a chain: every cost and size array and the host link
    (the JAX package's ``solver_cache.chain_fingerprint``, byte for byte)."""
    h = hashlib.sha256()
    h.update(b"repro-chain\0")
    for arr in (chain.uf, chain.ub, chain.wa, chain.wabar, chain.wdelta,
                chain.of, chain.ob):
        h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
        h.update(b"\0")
    host = chain.host
    if host is None:
        h.update(b"nohost")
    else:
        h.update(np.array(
            [host.bandwidth_d2h,
             -1.0 if host.bandwidth_h2d is None else host.bandwidth_h2d,
             host.latency], dtype=np.float64).tobytes())
    return h.hexdigest()


def _strategy(policy: str) -> str:
    """The JAX package's ``PlanRequest.strategy`` of a policy string."""
    return {"none": "store_all", "full": "full_remat", "periodic": "periodic",
            "revolve": "revolve"}.get(policy.split(":", 1)[0], "optimal")


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
    num_slots: int = DEFAULT_NUM_SLOTS
    tiers: str = "device"           # "device", or "device+host"

    @staticmethod
    def build(policy: str, chain: Optional[Chain], tree: Any,
              schedule: Schedule, solution: Optional[Solution] = None,
              budget_bytes: Optional[float] = None,
              num_slots: int = DEFAULT_NUM_SLOTS,
              tiers: str = "device") -> "MemoryPlan":
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
                          budget_bytes, expected, peak, host_peak, stall,
                          num_slots, tiers)

    @property
    def length(self) -> int:
        return self.schedule.length

    @property
    def uses_offload(self) -> bool:
        """True if the schedule needs the host tier (Foff/Prefetch ops)."""
        return uses_offload(self.schedule)

    @property
    def remat_expressible(self) -> bool:
        """True if the plan runs as nested checkpoints (host copies cannot
        be expressed by a remat tree)."""
        return self.tree is not None and not self.uses_offload

    def op_counts(self) -> dict:
        counts: dict = {}
        for k, _ in self.schedule.ops:
            counts[k] = counts.get(k, 0) + 1
        return counts

    def recompute_factor(self) -> float:
        """Mean number of forward executions per stage (1.0 = none)."""
        fc = self.schedule.forward_counts()
        return sum(fc.values()) / max(len(fc), 1)

    def timeline(self) -> List[dict]:
        """Per-op records ``{"op", "arg", "t_start", "t_end", "device_mem",
        "host_mem"}`` from the float64 simulator (needs a profiled
        chain)."""
        if self.chain is None:
            raise ValueError("timeline() needs a plan built from a profiled "
                             "chain, not a bare length")
        rows: List[dict] = []
        res = simulate(self.chain, self.schedule, trace=rows)
        if not res.valid:
            raise AssertionError(f"plan schedule does not simulate: "
                                 f"{res.error}")
        return rows

    def stats(self) -> dict:
        """JSON-serializable description, with the JAX package's fields;
        ``executor`` is ``"nested-checkpoint"`` or ``"eager-offload"``."""
        return {
            "strategy": _strategy(self.policy),
            "tiers": self.tiers,
            "policy": self.policy,
            "num_slots": self.num_slots,
            "slots_used": (self.solution.slots_used
                           if self.solution is not None else None),
            "budget_bytes": self.budget_bytes,
            "expected_time_s": self.expected_time,
            "peak_device_mem": self.peak_device_mem,
            "peak_host_mem": self.peak_host_mem,
            "transfer_stall_s": self.transfer_stall,
            "ops": self.op_counts(),
            "recompute_factor": self.recompute_factor(),
            "uses_offload": self.uses_offload,
            "executor": ("eager-offload" if self.uses_offload
                         else "nested-checkpoint"),
            "chain_hash": (chain_fingerprint(self.chain)
                           if self.chain is not None else None),
        }

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

    # -- execution ---------------------------------------------------------

    def bind(self, stages: Sequence[Callable]) -> "BoundPlan":
        """Bind per-stage callables (``stages[l-1]`` is paper-stage ``l``):
        the one call surface for both executors."""
        return BoundPlan(self, stages)

    def execute(self, stages: Sequence[Callable], params: Sequence[Any],
                x: Any, **kwargs) -> Tuple[Any, List[Any], Any]:
        """Run the exact op sequence on the eager walker
        (``core.executor.execute_schedule``; host copies included);
        returns ``(out, param_grads, input_grad)``."""
        from ..core.executor import execute_schedule
        return execute_schedule(self.schedule, stages, params, x, **kwargs)


class BoundPlan:
    """A plan bound to stage callables.

    - ``remat_expressible`` — the plan runs as nested checkpoints
      (:func:`~repro_torch.core.rematerialize.build_remat_fn`); otherwise on
      the eager offload walker with a fresh host buffer per call.
    - ``forward(params, x)`` — the chain's output.
    - ``value_and_grad(params, x)`` — ``(out, param_grads, input_grad)``
      for a cotangent of ones on the output, shaped as
      :func:`~repro_torch.core.executor.reference_grads` shapes them.
    """

    def __init__(self, plan: MemoryPlan, stages: Sequence[Callable]):
        self.plan = plan
        self.stages = list(stages)
        self.remat_expressible = plan.remat_expressible
        self._fn = None
        if self.remat_expressible:
            from ..core.rematerialize import build_remat_fn
            self._fn = build_remat_fn(plan.tree, self.stages)

    def forward(self, params: Sequence[Any], x: Any) -> Any:
        if self.remat_expressible:
            return self._fn(params, x)
        return self._run_eager(params, x)[0]

    def value_and_grad(self, params: Sequence[Any], x: Any
                       ) -> Tuple[Any, List[Any], Any]:
        if self.remat_expressible:
            from ..core.executor import value_and_grads
            return value_and_grads(self._fn, params, x)
        return self._run_eager(params, x)

    def _run_eager(self, params, x):
        from ..offload.executor import execute_offload_schedule
        from ..offload.host_buffer import HostBuffer
        return execute_offload_schedule(self.plan.schedule, self.stages,
                                        params, x, host_buffer=HostBuffer())

    def __repr__(self):
        mode = "nested-checkpoint" if self.remat_expressible else \
            "eager-offload"
        return f"BoundPlan({mode}, L={self.plan.length})"
