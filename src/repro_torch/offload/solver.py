"""Offload-aware optimal persistent checkpointing — the three-tier DP (a copy
of ``repro.offload.solver`` on the banded fill, without the float64
reference tables and the solver cache).

The third saving parks the sub-chain input ``a^{s-1}`` in host RAM,
reclaiming its device slots while the right segment runs, and pays the
transfer only where compute does not hide it:

.. math::

    C3(s,t,m) = \\min_{s'} \\Big[ X + \\max(T_{off}(a^{s-1}) - X,\\, 0)
                + T_{pre}(a^{s-1}) + C_b(s, s'-1, m) \\Big],
    \\quad X = \\sum_{k=s}^{s'-1} u_f^k + C_b(s', t,\\,
              m + w_{a^{s-1}} - w_{a^{s'-1}})

The offload starts at the beginning of the group, so it overlaps the forward
stream and the right segment (``X``); only the residue stalls.  The prefetch
is issued once the right segment is done and is charged in full.

An input can be offloaded only while it is a *bare* device activation, so
the DP carries one state bit: ``C_b`` (input bare, all three branches) and
``C_e`` (input embedded in an ``ā``, two-tier branches).  Without a host
model (or at zero bandwidth) the solvers delegate to the two-tier ones.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from ..core import dp_kernels
from ..core.chain import Chain
from ..core.dp_kernels import INFEASIBLE, _views
from ..core.schedule import (BWD, F_ALL, F_CK, F_NONE, F_OFF, PREFETCH,
                             Schedule, simulate)
from ..core.solver import (AllNode, CkNode, Leaf, Solution, _resolve_impl,
                           solve_min_memory, solve_optimal)


@dataclasses.dataclass
class OffNode:
    """``F_off^{s-1}`` first: the group input ``a^{s-1}`` is parked in host
    RAM while ``[s, sp-1]`` is streamed with ``F_∅`` and ``[sp, t]`` is
    solved; a ``Prefetch`` restores it before ``[s, sp-1]`` is re-solved."""
    s: int
    sp: int
    right: "Tree"   # sub-chain [sp, t]
    left: "Tree"    # sub-chain [s, sp-1], executed after the prefetch


Tree = Union[Leaf, AllNode, CkNode, OffNode]


def tree_uses_offload(tree) -> bool:
    """True if any node of the recursion tree is an ``OffNode``."""
    if isinstance(tree, OffNode):
        return True
    if isinstance(tree, AllNode):
        return tree_uses_offload(tree.rest)
    if isinstance(tree, CkNode):
        return tree_uses_offload(tree.right) or tree_uses_offload(tree.left)
    return False


def _rebuild_banded(v: dict, tb, te, toffP, tpre32, s: int, t: int, m: int,
                    bare: bool, allow_fall: bool) -> Tuple[List, Tree]:
    """Reconstruction with the branch recomputed at each visited cell
    (:func:`repro_torch.core.dp_kernels.choose_offload`)."""
    S = tb.S
    ch, sp = dp_kernels.choose_offload(v, tb, te, toffP, tpre32, s, t, m,
                                       bare, allow_fall)
    if ch == 0:
        raise ValueError(f"infeasible sub-problem ({s},{t},{m},"
                         f"{'bare' if bare else 'embedded'})")
    if s == t:
        return [(F_ALL, s), (BWD, s)], Leaf(s)

    def rec(s_, t_, m_, bare_):
        return _rebuild_banded(v, tb, te, toffP, tpre32, s_, t_, m_, bare_,
                               allow_fall)

    if ch == 2:
        ops_rest, tree_rest = rec(s + 1, t, m - int(v["WABAR"][s]), False)
        return ([(F_ALL, s)] + ops_rest + [(BWD, s)], AllNode(s, tree_rest))
    if ch == 1:
        ops = [(F_CK, s)] + [(F_NONE, j) for j in range(s + 1, sp)]
        ops_right, tree_right = rec(sp, t, m - int(v["WA"][sp - 1]), True)
        ops_left, tree_left = rec(s, sp - 1, m, bare)
        return ops + ops_right + ops_left, CkNode(s, sp, tree_right, tree_left)
    assert bare, "offload branch reconstructed from an embedded-input state"
    ops = [(F_OFF, s - 1)] + [(F_NONE, j) for j in range(s, sp)]
    m_right = min(m + int(v["WA"][s - 1]) - int(v["WA"][sp - 1]), S)
    ops_right, tree_right = rec(sp, t, m_right, True)
    ops_left, tree_left = rec(s, sp - 1, m, True)
    ops = ops + ops_right + [(PREFETCH, s - 1)] + ops_left
    return ops, OffNode(s, sp, tree_right, tree_left)


def tree_to_schedule(tree: Tree, length: int) -> Schedule:
    """Flatten a (possibly offload-bearing) recursion tree into ops."""
    ops: List = []

    def rec(node: Tree):
        if isinstance(node, Leaf):
            ops.extend([(F_ALL, node.s), (BWD, node.s)])
        elif isinstance(node, AllNode):
            ops.append((F_ALL, node.s))
            rec(node.rest)
            ops.append((BWD, node.s))
        elif isinstance(node, CkNode):
            ops.append((F_CK, node.s))
            ops.extend((F_NONE, j) for j in range(node.s + 1, node.sp))
            rec(node.right)
            rec(node.left)
        elif isinstance(node, OffNode):
            ops.append((F_OFF, node.s - 1))
            ops.extend((F_NONE, j) for j in range(node.s, node.sp))
            rec(node.right)
            ops.append((PREFETCH, node.s - 1))
            rec(node.left)
        else:
            raise TypeError(f"unknown tree node {node!r}")

    rec(tree)
    return Schedule(length, ops)


def _solve_offload(chain: Chain, dchain, mem_limit: float, num_slots: int,
                   allow_fall: bool, impl: str, pick) -> Solution:
    """Fill and rebuild shared by the two entry points.  ``pick`` maps the
    top-level row to ``(m, reported_budget)``, or ``None`` if infeasible."""
    L = dchain.length
    v = _views(dchain)
    tb, te = dp_kernels.fill_tables_offload(dchain, num_slots, impl=impl,
                                            allow_fall=allow_fall, v=v)
    table_bytes = tb.nbytes + te.nbytes
    picked = pick(tb.row(1, L + 1))
    if picked is None:
        return Solution(False, INFEASIBLE, None, None, mem_limit, num_slots,
                        0, table_bytes)
    m_use, budget = picked
    toffP, tpre32 = dp_kernels.offload_vectors(dchain, v)
    ops, tree = _rebuild_banded(v, tb, te, toffP, tpre32, 1, L + 1, m_use,
                                bare=True, allow_fall=allow_fall)
    sched = Schedule(L, ops)
    return Solution(True, float(simulate(chain, sched).time), sched, tree,
                    budget, num_slots, m_use, table_bytes)


def solve_optimal_offload(chain: Chain, mem_limit: float,
                          num_slots: int = 500, allow_fall: bool = True,
                          impl: Optional[str] = None) -> Solution:
    """Optimal persistent three-tier schedule under ``mem_limit`` *device*
    memory (host memory is taken as abundant: simulate the schedule with
    ``host_mem_limit`` to check its host peak).  Without a host model, or
    at zero bandwidth, this is the two-tier ``solve_optimal``."""
    if chain.host is None or not chain.host.enabled:
        return solve_optimal(chain, mem_limit, num_slots=num_slots,
                             allow_fall=allow_fall, impl=impl)
    impl = _resolve_impl(impl)
    dchain = chain.discretize(mem_limit, num_slots)
    m_top = num_slots - int(dchain.wa[0])

    def pick(top):
        if m_top < 0 or not np.isfinite(top[m_top]):
            return None
        return m_top, mem_limit

    sol = _solve_offload(chain, dchain, mem_limit, num_slots, allow_fall,
                         impl, pick)
    if not sol.feasible:
        sol = dataclasses.replace(sol, slots_used=max(m_top, 0))
    return sol


def solve_min_device_memory(chain: Chain, num_slots: int = 500,
                            allow_fall: bool = True,
                            impl: Optional[str] = None) -> Solution:
    """Smallest feasible *device* budget in the three-tier model — the floor
    below the two-tier ``solve_min_memory`` that offloading unlocks."""
    if chain.host is None or not chain.host.enabled:
        return solve_min_memory(chain, num_slots=num_slots,
                                allow_fall=allow_fall, impl=impl)
    impl = _resolve_impl(impl)
    peak = simulate(chain, Schedule.store_all(chain.length)).peak_mem
    dchain = chain.discretize(peak, num_slots)
    w0 = int(dchain.wa[0])

    def pick(top):
        feasible = np.where(np.isfinite(top))[0]
        if len(feasible) == 0:
            return None
        m_min = int(feasible[0])
        return m_min, (m_min + w0) * dchain.slot_size  # physical incl. a^0

    return _solve_offload(chain, dchain, peak, num_slots, allow_fall, impl,
                          pick)
