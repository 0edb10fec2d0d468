"""Typed planning requests — the port of ``repro.plan.request``: what a
caller wants from the memory planner.

A :class:`PlanRequest` names a strategy, a budget (bytes, a fraction of the
store-all peak, or ``auto``), the storage tiers to plan over, the host link,
the slot discretization and the DP fill, and :func:`repro_torch.plan.build_plan`
resolves it.  The policy strings (``"rotor:x0.6"``, ...) map onto exactly
one request each (:func:`repro_torch.plan.compat.policy_to_request`).

Size / budget grammar (shared with the policy strings):

- ``"1.5G"``, ``"800M"``, ``"2e9"``, ``"123"``, ``"0"`` — absolute sizes,
  with an optional K/M/G/T decimal suffix (:func:`parse_size`);
- ``"x0.5"`` — a fraction of the chain's store-all activation peak;
- ``"auto"`` — derived from launch context (device memory less parameters,
  gradients and optimizer state).

Where the port differs from the JAX package:

- ``impl`` names the port's fills, ``banded|plain|cuda|cuda_fused``
  (``core.dp_kernels.KNOWN_IMPLS``);
- a host-backed tier (``"host"``, ``"kv"``) needs a measured link, given as
  ``host=`` or carried by the chain.  The JAX package falls back to a
  PCIe-3 x16 constant; the port keeps no default link, and
  :func:`~repro_torch.plan.build_plan` raises without one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Tuple, Union

from ..core.chain import Chain, HostTransferModel
from ..core.dp_kernels import KNOWN_IMPLS

#: Default slot count for the DP discretization (paper §5.2: the makespan
#: overestimation is at most a ``1 + 1/S`` factor).
DEFAULT_NUM_SLOTS = 500

_UNITS = {"K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12}

# a strict decimal-or-scientific literal: "1", "1.5", ".5", "2e9", "1.5E-3"
_NUMBER = r"(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
_SIZE_RE = re.compile(rf"({_NUMBER})\s*([KMGT]?)")
_FRACTION_RE = re.compile(rf"x({_NUMBER})")


def parse_size(spec: str) -> float:
    """A non-negative number with an optional K/M/G/T suffix (``"1.5G"`` →
    1.5e9); anything else (``"1e"``, ``"--5G"``, ``"1..5"``, ...) raises
    with a message naming the accepted forms."""
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

    _KINDS = ("bytes", "fraction", "auto")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown budget kind {self.kind!r}; "
                             f"expected one of {self._KINDS}")
        if self.kind != "auto" and (self.value < 0 or self.value != self.value):
            raise ValueError(f"budget value must be non-negative, "
                             f"got {self.value!r}")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def bytes(n: float) -> "Budget":
        return Budget("bytes", float(n))

    @staticmethod
    def fraction(f: float) -> "Budget":
        """Fraction of the chain's store-all activation peak."""
        return Budget("fraction", float(f))

    @staticmethod
    def auto() -> "Budget":
        """Budget derived from launch context; resolvable only where the
        caller supplies it."""
        return Budget("auto")

    @staticmethod
    def parse(spec: str) -> "Budget":
        """Parse the budget grammar: ``1.5G`` / ``800M`` / ``2e9`` / ``123``
        / ``0`` (bytes), ``x0.5`` (fraction), ``auto``."""
        spec = spec.strip()
        if spec == "auto":
            return Budget.auto()
        if spec.startswith("x"):
            m = _FRACTION_RE.fullmatch(spec)
            if not m:
                raise ValueError(
                    f"cannot parse fractional budget {spec!r}: expected "
                    f"'x' followed by a number, e.g. 'x0.5'")
            return Budget.fraction(float(m.group(1)))
        return Budget.bytes(parse_size(spec))

    # -- resolution --------------------------------------------------------

    def resolve(self, chain: Optional[Chain] = None, *,
                store_all_peak: Optional[float] = None,
                auto_budget: Union[float, Callable[[], float], None] = None,
                ) -> float:
        """The budget in bytes.  Fractions need ``chain`` (or an explicit
        ``store_all_peak``); ``auto`` needs ``auto_budget`` — a float or a
        zero-argument callable supplied by the launch path."""
        if self.kind == "bytes":
            return self.value
        if self.kind == "fraction":
            if store_all_peak is None:
                if chain is None:
                    raise ValueError("fractional budget needs a profiled chain")
                store_all_peak = chain.store_all_peak()
            return self.value * store_all_peak
        if auto_budget is None:
            raise ValueError(
                "auto budget needs launch context (device memory and the "
                "parameter/optimizer footprint) — pass auto_budget=, or use "
                "an explicit bytes/fraction budget")
        return float(auto_budget() if callable(auto_budget) else auto_budget)

    def describe(self) -> str:
        if self.kind == "bytes":
            return f"{self.value:.3e} B"
        if self.kind == "fraction":
            return f"x{self.value:g} of store-all peak"
        return "auto"


#: Strategies backed by a DP solve (need a chain; ``optimal``/``revolve``
#: also need a budget).
SOLVER_STRATEGIES = ("optimal", "revolve", "min_memory")
#: Strategies that are pure schedule structure (no solve; a bare ``length``
#: suffices when no profiled chain is at hand).
STRUCTURAL_STRATEGIES = ("store_all", "full_remat", "periodic")


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """A typed memory-planning request — the one argument of
    :func:`repro_torch.plan.build_plan`.

    - ``strategy`` — ``"optimal"`` (the paper's DP), ``"revolve"`` (the
      ``F_all``-first branch off), ``"min_memory"`` (the smallest feasible
      budget; ignores ``budget``), or the structural baselines
      ``"store_all"`` / ``"full_remat"`` / ``"periodic"``.
    - ``budget`` — a :class:`Budget`; required for ``optimal``/``revolve``.
    - ``segments`` — segment count for ``periodic``.
    - ``tiers`` — ``("device",)`` is the paper's two-tier model,
      ``("device", "host")`` adds asynchronous host-RAM offload,
      ``("device", "kv")`` is the serving scenario
      (:mod:`repro_torch.plan.serving`); the tier combination picks the
      solver through :mod:`repro_torch.plan.registry`.
    - ``host`` — the measured :class:`HostTransferModel` of a host-backed
      tier; ``None`` takes the chain's link (there is no default).
    - ``num_slots`` — DP discretization (``None`` → :data:`DEFAULT_NUM_SLOTS`).
    - ``impl`` — the DP fill (``banded``/``plain``/``cuda``/``cuda_fused``;
      ``None`` → the solver's default).
    - ``on_infeasible`` — ``"raise"`` (:class:`InfeasiblePlanError`) or
      ``"min_memory"`` (fall back to the smallest-memory schedule and report
      its true need).
    """

    strategy: str = "optimal"
    budget: Optional[Budget] = None
    segments: int = 0
    tiers: Tuple[str, ...] = ("device",)
    host: Optional[HostTransferModel] = None
    num_slots: Optional[int] = None
    impl: Optional[str] = None
    on_infeasible: str = "raise"

    def __post_init__(self):
        known = SOLVER_STRATEGIES + STRUCTURAL_STRATEGIES
        if self.strategy not in known:
            raise ValueError(f"unknown plan strategy {self.strategy!r}; "
                             f"expected one of {known}")
        if self.strategy == "periodic" and self.segments < 1:
            raise ValueError("periodic strategy needs segments >= 1")
        if isinstance(self.tiers, list):
            object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers or self.tiers[0] != "device":
            raise ValueError(f"tiers must start with 'device', "
                             f"got {self.tiers!r}")
        if self.on_infeasible not in ("raise", "min_memory"):
            raise ValueError(
                f"on_infeasible must be 'raise' or 'min_memory', "
                f"got {self.on_infeasible!r}")
        if self.impl is not None and self.impl not in KNOWN_IMPLS:
            raise ValueError(f"unknown DP impl {self.impl!r}; "
                             f"expected one of {KNOWN_IMPLS}")
        if self.num_slots is not None and self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")

    @property
    def resolved_num_slots(self) -> int:
        return DEFAULT_NUM_SLOTS if self.num_slots is None else self.num_slots

    @property
    def allow_fall(self) -> bool:
        """The DP's ``F_all``-first branch is what `revolve` disables."""
        return self.strategy != "revolve"

    def describe(self) -> str:
        bits = [self.strategy, "+".join(self.tiers)]
        if self.budget is not None and self.strategy in ("optimal", "revolve"):
            bits.append(self.budget.describe())
        if self.strategy == "periodic":
            bits.append(f"k={self.segments}")
        bits.append(f"slots={self.resolved_num_slots}")
        if self.impl:
            bits.append(f"impl={self.impl}")
        return " ".join(bits)
