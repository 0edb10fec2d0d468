"""Optimal persistent checkpointing DP — paper Theorem 1 / Algorithms 1 & 2
(a copy of ``repro.core.solver`` on the banded fill).

``C[s, t, m]`` = optimal makespan to backprop the sub-chain ``[s, t]`` (paper
numbering, ``1 <= s <= t <= L+1``) with ``m`` memory slots, given that the
input ``a^{s-1}`` and the gradient ``δ^t`` are live, with ``a^{s-1}`` *not*
counted against ``m``.

The fill runs behind ``dp_kernels.fill_tables(impl=...)`` (``"banded"``
numpy, ``"plain"`` PyTorch, ``"cuda"`` the Hopper band-min kernel); branch
choices are recomputed at the O(L) cells the reconstruction visits, and the
published ``expected_time`` is the float64 simulator's makespan of the
reconstructed schedule.  Every entry point memoizes its Solution through
:mod:`.solver_cache` (``cache=False`` bypasses it, as timings of real fills
need).

Outputs: the optimal op ``Schedule`` (Algorithm 2) and the equivalent
recursion *tree* that ``rematerialize.py`` turns into nested
``torch.utils.checkpoint`` scopes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from . import dp_kernels, solver_cache
from .chain import Chain
from .dp_kernels import INFEASIBLE, _views
from .schedule import BWD, F_ALL, F_CK, F_NONE, Schedule, simulate


def _resolve_impl(impl: Optional[str]) -> str:
    impl = impl or "banded"
    if impl not in dp_kernels.KNOWN_IMPLS:
        raise ValueError(f"unknown DP impl {impl!r}; "
                         f"expected one of {dp_kernels.KNOWN_IMPLS}")
    return impl


# ---------------------------------------------------------------------------
# Recursion tree (consumed by the nested-remat compiler)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Leaf:
    """Stage ``s`` executed as ``F_all^s`` immediately followed by ``B^s``."""
    s: int


@dataclasses.dataclass
class AllNode:
    """``F_all^s`` first: stage ``s`` residuals are recorded, rest recurses."""
    s: int
    rest: "Tree"


@dataclasses.dataclass
class CkNode:
    """``F_ck^s`` first: segment ``[s, sp-1]`` streamed with ``F_∅`` (its input
    ``a^{s-1}`` checkpointed), then ``[sp, t]`` solved, then ``[s, sp-1]``
    re-solved recursively."""
    s: int
    sp: int
    right: "Tree"   # sub-chain [sp, t]
    left: "Tree"    # sub-chain [s, sp-1], executed after `right`'s backward


Tree = Union[Leaf, AllNode, CkNode]


@dataclasses.dataclass
class Solution:
    feasible: bool
    expected_time: float
    schedule: Optional[Schedule]
    tree: Optional[Tree]
    mem_limit: float
    num_slots: int
    slots_used: int
    table_bytes: int = 0


# ---------------------------------------------------------------------------
# Reconstruction (Algorithm 2) — both as op sequence and as recursion tree
# ---------------------------------------------------------------------------

def _rebuild_banded(v: dict, tab: "dp_kernels.BandedTable", s: int, t: int,
                    m: int, allow_fall: bool) -> Tuple[List, Tree]:
    """Reconstruction with branch choices recomputed per visited cell."""
    ch, sp = dp_kernels.choose_two_tier(v, tab, s, t, m, allow_fall)
    if ch == 0:
        raise ValueError(f"infeasible sub-problem ({s},{t},{m})")
    if s == t:
        return [(F_ALL, s), (BWD, s)], Leaf(s)
    if ch == 2:
        ops_rest, tree_rest = _rebuild_banded(
            v, tab, s + 1, t, m - int(v["WABAR"][s]), allow_fall)
        return ([(F_ALL, s)] + ops_rest + [(BWD, s)], AllNode(s, tree_rest))
    ops = [(F_CK, s)] + [(F_NONE, j) for j in range(s + 1, sp)]
    ops_right, tree_right = _rebuild_banded(
        v, tab, sp, t, m - int(v["WA"][sp - 1]), allow_fall)
    ops_left, tree_left = _rebuild_banded(v, tab, s, sp - 1, m, allow_fall)
    return ops + ops_right + ops_left, CkNode(s, sp, tree_right, tree_left)


def _finish(chain: Chain, mem_limit: float, num_slots: int,
            m_use: int, table_bytes: int, rebuild_fn) -> Solution:
    """Rebuild at ``m_use`` and publish the float64 simulator makespan."""
    ops, tree = rebuild_fn(m_use)
    sched = Schedule(chain.length, ops)
    expected = float(simulate(chain, sched).time)
    return Solution(True, expected, sched, tree, mem_limit, num_slots, m_use,
                    table_bytes)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def solve_optimal(chain: Chain, mem_limit: float, num_slots: int = 500,
                  allow_fall: bool = True, impl: Optional[str] = None,
                  cache: bool = True) -> Solution:
    """Optimal persistent schedule for ``chain`` under ``mem_limit`` memory.

    ``allow_fall=False`` disables the ``C2`` branch for sub-chains of length
    > 1 (the paper's revolve comparator).  ``impl`` picks the fill
    (``dp_kernels.KNOWN_IMPLS``; default ``"banded"``) and is part of the
    cache key.  ``cache=False`` bypasses the solver cache (it neither reads
    nor writes), so the fill always runs."""
    impl = _resolve_impl(impl)
    dchain = chain.discretize(mem_limit, num_slots)

    def solve() -> Solution:
        L, S = dchain.length, num_slots
        m_top = S - int(dchain.wa[0])  # Alg. 1: budget excludes the input a^0
        v = _views(dchain)
        tab = dp_kernels.fill_tables(dchain, S, impl=impl,
                                     allow_fall=allow_fall, v=v)
        if m_top < 0 or not np.isfinite(tab.row(1, L + 1)[m_top]):
            return Solution(False, INFEASIBLE, None, None, mem_limit,
                            num_slots, max(m_top, 0), tab.nbytes)
        return _finish(chain, mem_limit, num_slots, m_top, tab.nbytes,
                       lambda m: _rebuild_banded(v, tab, 1, L + 1, m,
                                                 allow_fall))

    return solver_cache.memoize_solve("solve_optimal", impl, chain, dchain,
                                      num_slots, allow_fall, cache, solve)


def solve_min_memory(chain: Chain, num_slots: int = 500,
                     allow_fall: bool = True, impl: Optional[str] = None,
                     cache: bool = True) -> Solution:
    """Smallest-memory feasible persistent schedule: run the DP with the
    store-all peak as the limit, then rebuild at the smallest feasible slot
    count (``mem_limit`` reports the budget it needs, input included).
    ``cache`` as in :func:`solve_optimal`."""
    impl = _resolve_impl(impl)
    peak = simulate(chain, Schedule.store_all(chain.length)).peak_mem
    dchain = chain.discretize(peak, num_slots)

    def solve() -> Solution:
        L, S = dchain.length, num_slots
        w0 = int(dchain.wa[0])
        v = _views(dchain)
        tab = dp_kernels.fill_tables(dchain, S, impl=impl,
                                     allow_fall=allow_fall, v=v)
        top = tab.row(1, L + 1)
        feasible = np.where(np.isfinite(top))[0]
        if len(feasible) == 0:
            return Solution(False, INFEASIBLE, None, None, peak, num_slots,
                            0, tab.nbytes)
        m_min = int(feasible[0])
        budget = (m_min + w0) * dchain.slot_size  # physical mem incl. a^0
        return _finish(chain, budget, num_slots, m_min, tab.nbytes,
                       lambda m: _rebuild_banded(v, tab, 1, L + 1, m,
                                                 allow_fall))

    return solver_cache.memoize_solve("solve_min_memory", impl, chain,
                                      dchain, num_slots, allow_fall, cache,
                                      solve)


def tree_to_schedule(tree: Tree, length: int) -> Schedule:
    """Flatten a recursion tree back into the canonical op sequence."""
    ops: List = []

    def rec(node: Tree):
        if isinstance(node, Leaf):
            ops.extend([(F_ALL, node.s), (BWD, node.s)])
        elif isinstance(node, AllNode):
            ops.append((F_ALL, node.s))
            rec(node.rest)
            ops.append((BWD, node.s))
        else:
            # right spans [sp, t]; left spans [s, sp-1]
            ops.append((F_CK, node.s))
            ops.extend((F_NONE, j) for j in range(node.s + 1, node.sp))
            rec(node.right)
            rec(node.left)

    rec(tree)
    return Schedule(length, ops)
