"""Exhaustive optimal-schedule search on tiny chains (test oracle) — the
port of ``repro.core.bruteforce``.

Explores the full schedule space of the paper's Table-1 operation model with a
Dijkstra search over states ``(live-set, next-backward, persistent-flag)``.
Supports non-persistent schedules via value drops (``Free``), which is what
the §4.1 counter-example needs.

Only usable for small L (state space is exponential), which is exactly its
role: an oracle to validate the DP solver's optimality over *persistent*
schedules and the strict gap to *non-persistent* ones.  The schedules it
returns run on :func:`repro_torch.core.schedule.simulate` (``Free`` ops
included).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, FrozenSet, Optional, Tuple

from .chain import Chain
from .schedule import BWD, F_ALL, F_CK, F_NONE, FREE, Schedule

Item = Tuple[str, int]
State = Tuple[FrozenSet[Item], int, bool]  # (live a/abar items, next_bwd, persistent)


def _sizes(chain: Chain):
    L = chain.length

    def size(item: Item) -> float:
        k, i = item
        if k == "a":
            return 0.0 if i == L + 1 else float(chain.wa[i])
        if k == "abar":
            return float(chain.wabar[i - 1])
        if k == "delta":
            return 0.0 if i == L + 1 else float(chain.wdelta[i])
        raise ValueError(item)

    return size


def optimal_time(chain: Chain, mem_limit: float,
                 persistent_only: bool = False,
                 return_schedule: bool = False):
    """Minimum makespan over ALL valid schedules within ``mem_limit``.

    With ``persistent_only=True``, restrict to memory-persistent schedules
    (checkpointed values never dropped before their backward use).
    Returns ``inf`` if infeasible; with ``return_schedule`` also returns the
    argmin ``Schedule`` (or None).
    """
    L = chain.length
    size = _sizes(chain)

    def mem_of(live: FrozenSet[Item], next_bwd: int) -> float:
        return sum(size(it) for it in live) + size(("delta", next_bwd))

    # ``ckpt`` membership is tracked implicitly: an ("a", i) item is a
    # checkpoint iff it was retained by an F_ck/F_all/initial-input event.
    # In this reduced state we conservatively treat every *stored* item as a
    # checkpoint: any live ("a", i) that gets consumed by F_none or dropped
    # makes the schedule non-persistent UNLESS it was just produced by the
    # immediately preceding forward (streaming).  To keep the state small we
    # instead annotate items: ("a", i, tag) with tag "ck" or "tmp".
    start_live: FrozenSet = frozenset({("a", 0)})
    start: State = (start_live, L + 1, True)

    # item encoding inside `live`: ("a", i) means *checkpointed* a^i;
    # ("t", i) means transient a^i (produced by F_none, droppable freely);
    # ("abar", i) is always a checkpoint.
    def a_live(live, i):
        return ("a", i) in live or ("t", i) in live or ("abar", i) in live

    def size2(item):
        if item[0] == "t":
            return size(("a", item[1]))
        return size(item)

    def mem2(live, next_bwd):
        return sum(size2(it) for it in live) + size(("delta", next_bwd))

    dist: Dict[State, float] = {start: 0.0}
    prev: Dict[State, Tuple[State, tuple]] = {}
    pq = [(0.0, 0, start)]
    counter = itertools.count(1)
    goal_time = float("inf")
    goal_state: Optional[State] = None

    while pq:
        d, _, state = heapq.heappop(pq)
        if d > dist.get(state, float("inf")):
            continue
        live, nb, pers = state
        if nb == 0:
            if d < goal_time:
                goal_time, goal_state = d, state
            break  # Dijkstra: first goal pop is optimal
        base_mem = mem2(live, nb)

        def push(nstate: State, cost: float, op: tuple):
            nd = d + cost
            if nd < dist.get(nstate, float("inf")):
                dist[nstate] = nd
                prev[nstate] = (state, op)
                heapq.heappush(pq, (nd, next(counter), nstate))

        # forwards
        for l in range(1, L + 2):
            if not a_live(live, l - 1):
                continue
            uf = float(chain.uf[l - 1])
            of = float(chain.of[l - 1])
            # F_none
            out_t = ("t", l)
            if out_t not in live and ("a", l) not in live:
                new_bytes = size(("a", l))
                if base_mem + new_bytes + of <= mem_limit + 1e-9:
                    nl = set(live)
                    npers = pers
                    if ("t", l - 1) in nl:
                        nl.discard(("t", l - 1))
                    elif ("a", l - 1) in nl:
                        nl.discard(("a", l - 1))
                        npers = False  # consumed a checkpoint
                    nl.add(out_t)
                    if not (persistent_only and not npers):
                        push((frozenset(nl), nb, npers), uf, (F_NONE, l))
            # F_ck (same compute; input becomes/stays a checkpoint)
            if ("t", l) not in live and ("a", l) not in live:
                new_bytes = size(("a", l))
                if base_mem + new_bytes + of <= mem_limit + 1e-9:
                    nl = set(live)
                    if ("t", l - 1) in nl:
                        nl.discard(("t", l - 1))
                        nl.add(("a", l - 1))
                    nl.add(("t", l))
                    push((frozenset(nl), nb, pers), uf, (F_CK, l))
            # F_all
            if ("abar", l) not in live:
                new_bytes = size(("abar", l))
                if base_mem + new_bytes + of <= mem_limit + 1e-9:
                    nl = set(live)
                    if ("t", l - 1) in nl:  # input retained -> checkpoint
                        nl.discard(("t", l - 1))
                        nl.add(("a", l - 1))
                    nl.add(("abar", l))
                    push((frozenset(nl), nb, pers), uf, (F_ALL, l))
        # backward of stage nb
        l = nb
        if ("abar", l) in live and a_live(live, l - 1):
            ob = float(chain.ob[l - 1])
            if base_mem + ob <= mem_limit + 1e-9:
                nl = set(live)
                nl.discard(("abar", l))
                # consume the bare a^{l-1} if live (matches simulator's
                # preference); if only ā^{l-1} provides it, keep ā^{l-1}.
                for tag in ("a", "t"):
                    if (tag, l - 1) in nl:
                        nl.discard((tag, l - 1))
                        break
                push((frozenset(nl), nb - 1, pers), float(chain.ub[l - 1]),
                     (BWD, l))
        # frees (only useful for non-persistent exploration)
        if not persistent_only:
            for it in live:
                nl = set(live)
                nl.discard(it)
                npers = pers if it[0] == "t" else False
                push((frozenset(nl), nb, npers), 0.0, (FREE, it))

    if goal_state is None:
        return (float("inf"), None) if return_schedule else float("inf")
    if not return_schedule:
        return goal_time
    ops = []
    st = goal_state
    while st in prev:
        st, op = prev[st]
        ops.append(op)
    ops.reverse()
    # map internal Free-item encoding back to simulator items
    fixed = []
    for k, arg in ops:
        if k == FREE and isinstance(arg, tuple) and arg[0] == "t":
            fixed.append((FREE, ("a", arg[1])))
        else:
            fixed.append((k, arg))
    return goal_time, Schedule(L, fixed)
