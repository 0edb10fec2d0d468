"""The strategies the paper compares against (§5.3), as the JAX package's
``repro.core.baselines`` gives them:

- store-all — autograd's default, every residual kept
  (``Schedule.store_all``; policy ``none``);
- :func:`periodic` — the *sequential* strategy (PyTorch's
  ``checkpoint_sequential``, after Chen et al.): ``k`` segments, each
  segment's input stored in the forward and the segment replayed with
  ``F_all`` before its backward; the last segment, which holds the loss, is
  not replayed.  Its schedule is the flattened
  :func:`~repro_torch.core.rematerialize.periodic_tree`, the tree the
  ``periodic:K`` policy runs, so the two cannot drift;
- :func:`chen_sqrt` — :func:`periodic` with ``ceil(sqrt(L))`` segments;
- :func:`revolve` — the optimal schedule that checkpoints only bare
  activations: the same DP with the ``F_all``-first branch turned off
  (``solve_optimal(..., allow_fall=False)``);
- :func:`best_periodic` — the fastest segment count that fits a budget.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from .chain import Chain
from .rematerialize import periodic_tree
from .schedule import Schedule, SimResult, simulate
from .solver import Solution, solve_optimal, tree_to_schedule


def periodic(chain: Chain, num_segments: int) -> Schedule:
    """``checkpoint_sequential`` with ``num_segments`` segments (clamped to
    ``1..L``); the loss stage rides with the last segment."""
    return tree_to_schedule(periodic_tree(chain.length, num_segments),
                            chain.length)


def chen_sqrt(chain: Chain) -> Schedule:
    return periodic(chain, int(math.ceil(math.sqrt(chain.length))))


def revolve(chain: Chain, mem_limit: float, num_slots: int = 500,
            impl: Optional[str] = None) -> Solution:
    """The revolve comparator on the fill ``impl`` (``dp_kernels``)."""
    return solve_optimal(chain, mem_limit, num_slots, allow_fall=False,
                         impl=impl)


def best_periodic(chain: Chain, mem_limit: float
                  ) -> Optional[Tuple[int, SimResult, Schedule]]:
    """``(k, simulation, schedule)`` of the fastest segment count among
    ``1..2·sqrt(L)`` (the paper's sweep, §5.3) whose schedule fits
    ``mem_limit``; ``None`` if none fits."""
    best = None
    hi = max(2, int(2 * math.sqrt(chain.length)) + 1)
    for k in range(1, min(chain.length, hi) + 1):
        sched = periodic(chain, k)
        res = simulate(chain, sched, mem_limit)
        if res.valid and (best is None or res.time < best[1].time):
            best = (k, res, sched)
    return best
