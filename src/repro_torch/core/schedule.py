"""Schedule IR + memory simulator (the paper's Table 1 semantics) — a copy
of ``repro.core.schedule`` without the brute-force ``Free`` op, the per-op
trace and the verifier hooks.

An operation is a ``(kind, l)`` pair with ``l`` in *paper numbering* (stages
1..L+1, where L+1 is the loss stage):

- ``("Fnone", l)`` — forward without saving; consumes ``a^{l-1}`` (if live as
  a bare activation), produces ``a^l``.
- ``("Fck", l)``   — forward, checkpointing the *input* ``a^{l-1}``.
- ``("Fall", l)``  — forward recording the full residual set ``ā^l``.
- ``("B", l)``     — backward; consumes ``{δ^l, ā^l, a^{l-1}}`` and produces
  ``δ^{l-1}`` (an input available as ``ā^{l-1}`` is kept).

Three-tier extension (needs ``chain.host``), with ``i`` an activation index
0..L:

- ``("Foff", i)``     — launch an asynchronous device→host copy of the bare
  activation ``a^i``.  No compute time; the copy lands at
  ``t + offload_time(w_{a^i})``, so it overlaps the compute after it.  The
  device copy stays (the next ``F_∅``/``B`` consumes it); host memory is
  charged from launch.
- ``("Prefetch", i)`` — synchronous host→device copy of ``a^i``: waits for
  the offload to land, then pays ``prefetch_time(w_{a^i})``; re-creates
  ``("a", i)`` on the device and drops the host copy.

Live memory items are ``("a", i)``, ``("abar", i)``, ``("delta", i)``;
``ā^i`` includes ``a^i``.  Host copies are tracked apart and reported as
``host_peak_mem``.  During a forward, memory = live + new output +
overhead; during a backward, memory = live + overhead — the accounting under
which Theorem 1's formulas are exact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .chain import Chain

Item = Tuple[str, int]
Op = Tuple[str, int]

F_NONE, F_CK, F_ALL, BWD = "Fnone", "Fck", "Fall", "B"
F_OFF, PREFETCH = "Foff", "Prefetch"
_FORWARD_KINDS = (F_NONE, F_CK, F_ALL)
_OFFLOAD_KINDS = (F_OFF, PREFETCH)


def uses_offload(schedule: "Schedule") -> bool:
    """True if the schedule contains any host-tier (Foff/Prefetch) ops."""
    return any(k in _OFFLOAD_KINDS for k, _ in schedule.ops)


@dataclasses.dataclass
class Schedule:
    """An ordered list of operations for a chain of length L (stages 1..L+1)."""

    length: int  # L (number of real stages; loss stage is L+1)
    ops: List[Op]

    @staticmethod
    def store_all(length: int) -> "Schedule":
        """The default autograd strategy: save everything, then backprop."""
        ops: List[Op] = [(F_ALL, l) for l in range(1, length + 2)]
        ops += [(BWD, l) for l in range(length + 1, 0, -1)]
        return Schedule(length, ops)

    def count(self, kind: str) -> int:
        return sum(1 for k, _ in self.ops if k == kind)

    def forward_counts(self) -> dict:
        """How many times each stage's forward is executed (recompute factor)."""
        c: dict = {}
        for k, l in self.ops:
            if k in _FORWARD_KINDS:
                c[l] = c.get(l, 0) + 1
        return c

    def __len__(self):
        return len(self.ops)


@dataclasses.dataclass
class SimResult:
    valid: bool
    time: float
    peak_mem: float
    error: str = ""
    # peak bytes parked on the host tier (0 for two-tier schedules)
    host_peak_mem: float = 0.0
    # time stalled on host transfers (prefetch wait + copy)
    transfer_stall: float = 0.0


def _size(chain: Chain, item: Item) -> float:
    kind, i = item
    if kind == "a":
        if i == chain.length + 1:
            return 0.0  # the loss value is a scalar
        return float(chain.wa[i])
    if kind == "abar":
        return float(chain.wabar[i - 1])  # ā^i stored at array index i-1
    if kind == "delta":
        if i == chain.length + 1:
            return 0.0  # δ^{L+1} = ∂L/∂L, a scalar
        return float(chain.wdelta[i])
    raise ValueError(f"unknown item {item}")


def simulate(chain: Chain, schedule: Schedule,
             mem_limit: float | None = None,
             host_mem_limit: float | None = None,
             trace: Optional[List[dict]] = None) -> SimResult:
    """Execute ``schedule`` on the cost model; returns validity, makespan and
    peak memory.  With ``mem_limit``, the schedule is invalid if any
    during-op memory exceeds it.  Offload schedules (``Foff``/``Prefetch``)
    need ``chain.host``; the host tier's peak is tracked apart, and
    ``host_mem_limit`` bounds it as ``mem_limit`` bounds the device.
    ``trace`` (a list) receives one record per executed op, ``{"op", "arg",
    "t_start", "t_end", "device_mem", "host_mem"}``, memory as it stands
    after the op (``MemoryPlan.timeline``)."""
    L = chain.length
    live: dict = {("a", 0): True, ("delta", L + 1): True}
    mem = _size(chain, ("a", 0))
    peak = mem
    t = 0.0
    # host tier: which a^i have a host copy, and when their offload lands
    host_copies: set = set()
    off_done: dict = {}
    host_mem = 0.0
    host_peak = 0.0
    stall = 0.0

    def has_input_act(i: int) -> Tuple[bool, Item | None]:
        """Is a^i readable? Returns (ok, the live item that provides it)."""
        if ("a", i) in live:
            return True, ("a", i)
        if i >= 1 and ("abar", i) in live:
            return True, ("abar", i)
        return False, None

    def record(kind: str, arg: int, t0: float) -> None:
        if trace is not None:
            trace.append({"op": kind, "arg": arg, "t_start": t0, "t_end": t,
                          "device_mem": mem, "host_mem": host_mem})

    def fail(idx: int, msg: str) -> SimResult:
        return SimResult(False, t, peak, f"{msg} at op[{idx}]",
                         host_peak_mem=host_peak)

    for idx, (kind, arg) in enumerate(schedule.ops):
        t_op = t
        if kind in _OFFLOAD_KINDS:
            i = int(arg)  # activation index, 0..L
            if chain.host is None or not chain.host.enabled:
                return fail(idx, f"{kind} a^{i}: chain has no host tier")
            if not (0 <= i <= L):
                return fail(idx, f"{kind}: bad activation {i}")
            w = float(chain.wa[i])
            if kind == F_OFF:
                if ("a", i) not in live:
                    return fail(idx, f"Foff: a^{i} not live as a bare "
                                     f"activation")
                if i in host_copies:
                    return fail(idx, f"Foff: a^{i} already offloaded")
                off_done[i] = t + chain.host.offload_time(w)
                host_copies.add(i)
                host_mem += w
                host_peak = max(host_peak, host_mem)
                if host_mem_limit is not None and \
                        host_mem > host_mem_limit + 1e-9:
                    return fail(idx, f"Foff: host mem {host_mem} > limit "
                                     f"{host_mem_limit}")
            else:  # PREFETCH
                if i not in host_copies:
                    return fail(idx, f"Prefetch: a^{i} has no host copy")
                if ("a", i) in live:
                    return fail(idx, f"Prefetch: a^{i} already on device")
                during = mem + w
                peak = max(peak, during)
                if mem_limit is not None and during > mem_limit + 1e-9:
                    return fail(idx, f"Prefetch: mem {during} > limit "
                                     f"{mem_limit}")
                t0 = t
                t = max(t, off_done.get(i, t)) + chain.host.prefetch_time(w)
                stall += t - t0
                live[("a", i)] = True
                mem += w
                host_copies.discard(i)
                host_mem -= w
            record(kind, i, t_op)
            continue
        l = int(arg)  # stage index, 1..L+1
        if not (1 <= l <= L + 1):
            return fail(idx, f"bad stage {l}")
        if kind in _FORWARD_KINDS:
            ok, src = has_input_act(l - 1)
            if not ok:
                return fail(idx, f"{kind}^{l}: a^{l-1} not live")
            out: Item = ("abar", l) if kind == F_ALL else ("a", l)
            new_bytes = 0.0 if out in live else _size(chain, out)
            during = mem + new_bytes + float(chain.of[l - 1])
            peak = max(peak, during)
            if mem_limit is not None and during > mem_limit + 1e-9:
                return fail(idx, f"{kind}^{l}: mem {during} > limit {mem_limit}")
            t += float(chain.uf[l - 1])
            if kind == F_NONE and src == ("a", l - 1):
                mem -= _size(chain, src)
                del live[src]
            if out not in live:
                live[out] = True
                mem += new_bytes
        elif kind == BWD:
            for item in (("delta", l), ("abar", l)):
                if item not in live:
                    return fail(idx, f"B^{l}: {item} not live")
            ok, src = has_input_act(l - 1)
            if not ok:
                return fail(idx, f"B^{l}: a^{l-1} not live")
            during = mem + float(chain.ob[l - 1])
            peak = max(peak, during)
            if mem_limit is not None and during > mem_limit + 1e-9:
                return fail(idx, f"B^{l}: mem {during} > limit {mem_limit}")
            t += float(chain.ub[l - 1])
            # consume δ^l, ā^l, and a^{l-1} (unless provided by ā^{l-1})
            for item in (("delta", l), ("abar", l)):
                mem -= _size(chain, item)
                del live[item]
            if src == ("a", l - 1):
                mem -= _size(chain, src)
                del live[src]
            out = ("delta", l - 1)
            if out not in live:
                live[out] = True
                mem += _size(chain, out)
        else:
            return fail(idx, f"unknown op kind {kind}")
        record(kind, l, t_op)

    if ("delta", 0) not in live:
        return SimResult(False, t, peak, "schedule did not produce δ^0",
                         host_peak_mem=host_peak, transfer_stall=stall)
    return SimResult(True, t, peak, host_peak_mem=host_peak,
                     transfer_stall=stall)
