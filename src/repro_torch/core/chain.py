"""Heterogeneous-chain cost model (paper §3) — a copy of ``repro.core.chain``
without the parts the training paths do not use (no default host link: the
port prices the host tier only with a link rate the caller measured).

A chain has L stages, numbered 1..L, plus a virtual loss stage L+1 (the paper's
``F^{L+1}/B^{L+1}``).  Stage ``l`` carries:

- ``uf[l]`` / ``ub[l]``  : forward / backward compute time,
- ``wa[l]``              : size of the stage *output* activation ``a^l``,
- ``wabar[l]``           : size of the full residual set ``ā^l`` (everything the
                           backward of stage l needs, *including* ``a^l`` but
                           excluding ``a^{l-1}``),
- ``wdelta[l]``          : size of the back-propagated gradient ``δ^l``
                           (in practice ``wdelta == wa``),
- ``of[l]`` / ``ob[l]``  : transient memory overheads of the fwd / bwd op.

Arrays have length ``L+1``:

- ``uf[i]``, ``ub[i]``, ``wabar[i]``, ``of[i]``, ``ob[i]`` for ``i in 0..L``
  describe stage ``i+1`` in paper numbering (so ``i=L`` is the loss stage).
- ``wa[i]`` for ``i in 0..L`` is the size of activation ``a^i`` — ``wa[0]`` is
  the chain *input* ``a^0 = x`` and ``wa[i]`` the output of (paper) stage i.
- ``wdelta[i]`` for ``i in 0..L`` is the size of ``δ^i``.

Sizes are in bytes when the planner produces the chain; the solver
discretizes them to memory slots.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class HostTransferModel:
    """Cost model of the device↔host link (the third storage tier).

    Transfers are asynchronous copies on an uncontended link: a transfer
    launched at time ``t`` lands at ``t + latency + bytes/bw`` whatever the
    compute stream does, so offloads overlap compute and only stall the
    timeline when a ``Prefetch`` reaches the data before its copy has landed.
    Bandwidths are in size units per second (bytes/s for a planner chain);
    ``bandwidth_h2d`` defaults to the device→host value.  A zero
    ``bandwidth_d2h`` disables the tier; ``Chain.host is None`` is the
    two-tier model."""

    bandwidth_d2h: float
    bandwidth_h2d: float | None = None
    latency: float = 0.0

    def __post_init__(self):
        if self.bandwidth_d2h < 0 or (self.bandwidth_h2d or 0) < 0:
            raise ValueError("host bandwidth must be non-negative")
        if self.latency < 0:
            raise ValueError("host latency must be non-negative")

    @property
    def enabled(self) -> bool:
        return self.bandwidth_d2h > 0

    def offload_time(self, size: float) -> float:
        """Seconds for a device→host copy of ``size`` units (inf if disabled)."""
        if not self.enabled:
            return float("inf")
        return self.latency + float(size) / self.bandwidth_d2h

    def prefetch_time(self, size: float) -> float:
        """Seconds for a host→device copy of ``size`` units (inf if disabled)."""
        bw = self.bandwidth_h2d if self.bandwidth_h2d else self.bandwidth_d2h
        if not bw or bw <= 0:
            return float("inf")
        return self.latency + float(size) / bw


@dataclasses.dataclass(frozen=True)
class Chain:
    """Cost description of a heterogeneous backprop chain of length L.

    ``length`` is the number of real stages L; internal arrays have L+1
    entries, the last describing the loss stage F^{L+1}/B^{L+1}.
    ``host`` (optional) prices the third storage tier; ``None`` means the
    two-tier model.
    """

    uf: np.ndarray      # (L+1,) forward times, stage 1..L+1
    ub: np.ndarray      # (L+1,) backward times, stage 1..L+1
    wa: np.ndarray      # (L+1,) sizes of a^0 .. a^L
    wabar: np.ndarray   # (L+1,) sizes of ā^1 .. ā^{L+1}
    wdelta: np.ndarray  # (L+1,) sizes of δ^0 .. δ^L
    of: np.ndarray      # (L+1,) fwd memory overheads, stage 1..L+1
    ob: np.ndarray      # (L+1,) bwd memory overheads, stage 1..L+1
    host: "HostTransferModel | None" = None

    @property
    def length(self) -> int:
        return len(self.uf) - 1

    def __post_init__(self):
        n = len(self.uf)
        for name in ("ub", "wa", "wabar", "wdelta", "of", "ob"):
            arr = getattr(self, name)
            if len(arr) != n:
                raise ValueError(
                    f"chain field {name} has length {len(arr)}, expected {n}")
        for name in ("uf", "ub", "wa", "wabar", "wdelta", "of", "ob"):
            if np.any(np.asarray(getattr(self, name)) < 0):
                raise ValueError(f"chain field {name} has negative entries")

    @staticmethod
    def make(
        uf: Sequence[float],
        ub: Sequence[float],
        wa: Sequence[float],
        wabar: Sequence[float],
        wdelta: Sequence[float] | None = None,
        of: Sequence[float] | None = None,
        ob: Sequence[float] | None = None,
        host: "HostTransferModel | None" = None,
    ) -> "Chain":
        uf = np.asarray(uf, dtype=np.float64)
        n = len(uf)
        z = np.zeros(n, dtype=np.float64)

        def arr(x, default):
            return default.copy() if x is None else np.asarray(x, dtype=np.float64)

        wa_ = np.asarray(wa, dtype=np.float64)
        wdelta_ = arr(wdelta, wa_)
        return Chain(
            uf=uf,
            ub=np.asarray(ub, dtype=np.float64),
            wa=wa_,
            wabar=np.asarray(wabar, dtype=np.float64),
            wdelta=wdelta_,
            of=arr(of, z),
            ob=arr(ob, z),
            host=host,
        )

    def with_host(self, host: "HostTransferModel | None") -> "Chain":
        """A copy of this chain priced with the given host-transfer model."""
        return dataclasses.replace(self, host=host)

    def calibrate(self, uf: "Sequence[float] | None" = None,
                  ub: "Sequence[float] | None" = None,
                  blend: float = 1.0) -> "Chain":
        """A copy with *measured* per-stage compute times folded in.

        ``uf``/``ub`` are length-``L+1`` arrays of measured forward/backward
        seconds (the chain's own indexing); ``NaN`` entries keep the modeled
        value — :func:`repro_torch.obs.trace.measured_stage_times` gives
        this shape from a trace.  ``blend`` interpolates model → measurement
        (1.0 = the measurement); sizes and the host link are untouched."""
        if not 0.0 <= blend <= 1.0:
            raise ValueError("blend must be in [0, 1]")

        def fold(model: np.ndarray, measured) -> np.ndarray:
            if measured is None:
                return model
            meas = np.asarray(measured, dtype=np.float64)
            if meas.shape != model.shape:
                raise ValueError(
                    f"measured times have shape {meas.shape}, "
                    f"expected {model.shape}")
            if np.any(meas[~np.isnan(meas)] < 0):
                raise ValueError("measured times must be non-negative")
            out = model.copy()
            ok = ~np.isnan(meas)
            out[ok] = (1.0 - blend) * model[ok] + blend * meas[ok]
            return out

        return dataclasses.replace(self, uf=fold(np.asarray(self.uf), uf),
                                   ub=fold(np.asarray(self.ub), ub))

    def offload_times(self) -> np.ndarray:
        """Per-activation device→host copy time: entry ``i`` is ``a^i``."""
        if self.host is None:
            return np.full(len(self.wa), np.inf)
        return np.array([self.host.offload_time(w) for w in self.wa])

    def prefetch_times(self) -> np.ndarray:
        """Per-activation host→device copy time: entry ``i`` is ``a^i``."""
        if self.host is None:
            return np.full(len(self.wa), np.inf)
        return np.array([self.host.prefetch_time(w) for w in self.wa])

    def discretize(self, mem_limit: float, num_slots: int) -> "DiscreteChain":
        """Discretize memory sizes into ``num_slots`` slots of size
        ``mem_limit / num_slots`` each, rounding *up* (paper §5.2: at most a
        ``1 + 1/S`` overestimation)."""
        if mem_limit <= 0:
            raise ValueError("mem_limit must be positive")
        slot = mem_limit / num_slots

        def q(x: np.ndarray) -> np.ndarray:
            return np.ceil(np.asarray(x, dtype=np.float64) / slot - 1e-12).astype(np.int64)

        return DiscreteChain(
            chain=self,
            slot_size=slot,
            num_slots=num_slots,
            wa=q(self.wa),
            wabar=q(self.wabar),
            wdelta=q(self.wdelta),
            of=q(self.of),
            ob=q(self.ob),
        )

    def store_all_peak(self) -> float:
        """Peak memory of the default store-everything strategy (all F_all then
        all B), per the simulator.  The upper end of useful budgets."""
        from .schedule import Schedule, simulate  # local import, avoid cycle
        return simulate(self, Schedule.store_all(self.length)).peak_mem


@dataclasses.dataclass(frozen=True)
class DiscreteChain:
    """A chain with memory sizes expressed in integer slots."""

    chain: Chain
    slot_size: float
    num_slots: int
    wa: np.ndarray
    wabar: np.ndarray
    wdelta: np.ndarray
    of: np.ndarray
    ob: np.ndarray

    @property
    def length(self) -> int:
        return self.chain.length

    @property
    def uf(self) -> np.ndarray:
        return self.chain.uf

    @property
    def ub(self) -> np.ndarray:
        return self.chain.ub
