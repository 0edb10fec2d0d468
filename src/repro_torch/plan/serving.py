"""KV-cache residency planning for the decode path — the port of
``repro.plan.serving``.

Serving has the shape of the paper's problem: per-layer state under a
device-memory budget, with a slower tier (host RAM over the link) to spill
to.  The decode cache becomes a heterogeneous chain whose per-layer
"activations" are KV blocks — sized by
:meth:`repro_torch.models.lm.StagedLM.cache_layout` at the configured
``kv_cache_dtype`` — solved by the three-tier offload DP
(:func:`..offload.solver.solve_optimal_offload`, on any fill: ``cuda`` runs
K5a, ``cuda_fused`` K5b).

Chain mapping (paper indexing, chain length ``L = cfg.num_layers``):

- ``wa[i]`` (``i`` in 1..L) — allocated bytes of layer ``i``'s KV block;
  ``wa[0]`` is the decode-step input hidden state (negligible → 0);
- ``wabar[i]`` — the block again (the decode "backward" of stage ``i+1`` is
  the per-step attention read over that block);
- ``wdelta = 0`` — no gradients flow at serving time;
- ``uf[i]`` — the cost of *rebuilding* layer ``i``'s prefix KV, priced out
  by ``recompute_penalty``: the decode loop cannot recompute a layer's KV
  from its neighbour's, so the DP meets the budget with ``Foff`` /
  ``Prefetch`` staging and spends the link model deciding *which* blocks
  to stage;
- ``ub[i]`` — the per-decode-step cost of stage ``i``: analytic FLOPs
  (:func:`..models.flops.per_layer_flops`) plus the read of the block.

The DP's timeline is a forward+backward sweep while decode is a steady
loop, so the executor (:mod:`..runtime.kv_residency`) takes only the
plan's staging *set* — the ``Foff`` args — and re-stages it every step.
Schedules may lean on recompute branches that serving cannot execute (the
min-memory fallback, say), so :func:`kv_residency_layers` clamps the set
deterministically to the budget.

The port keeps no default host link (``host=`` is required: on the card
the rate ``core.planner.measure_host_bandwidth`` measures), and its time
prices default to the H100's.  The plan is a ``("device", "kv")``
:class:`~repro_torch.plan.PlanRequest` resolved by
:func:`~repro_torch.plan.build_plan`, which refuses a schedule that does
not simulate; ``run_serving`` verifies it before it serves
(:meth:`MemoryPlan.verify`).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..core.chain import Chain, HostTransferModel
from .api import build_plan
from .plan import MemoryPlan
from .request import Budget, PlanRequest

#: Time prices of the per-layer estimates: NVIDIA H100 SXM's dense bf16
#: tensor-core rate and HBM3 bandwidth (data sheet; the JAX package's
#: defaults, 50e12 and 800e9, are a TPU-era serving part's).  They need only
#: be relatively right: the DP weighs staging against compute overlap.
DEFAULT_DEVICE_FLOPS = 989e12
DEFAULT_HBM_BANDWIDTH = 3.35e12

#: Multiplier pricing recompute branches out of the serving DP.
DEFAULT_RECOMPUTE_PENALTY = 1e3


def kv_chain(cfg, *, batch: int, prompt_len: int,
             host: HostTransferModel, max_len: Optional[int] = None,
             device_flops: float = DEFAULT_DEVICE_FLOPS,
             hbm_bandwidth: float = DEFAULT_HBM_BANDWIDTH,
             recompute_penalty: float = DEFAULT_RECOMPUTE_PENALTY) -> Chain:
    """The decode cache as a heterogeneous chain: one stage per model layer,
    activation ``a^i`` = layer ``i``'s KV block (allocated bytes at
    ``max_len`` and the configured ``kv_cache_dtype``), priced with the
    host link ``host``."""
    from ..models.flops import per_layer_flops
    from ..models.lm import StagedLM

    max_len = max_len or prompt_len
    layout = StagedLM(cfg).cache_layout(batch, max_len)
    blocks = [float(b) for b in layout.block_bytes]
    prefill_flops = per_layer_flops(cfg, batch, prompt_len)
    decode_flops = per_layer_flops(cfg, batch, 1, kv_len=prompt_len)
    uf = [recompute_penalty * f / device_flops for f in prefill_flops] + [0.0]
    ub = [f / device_flops + b / hbm_bandwidth
          for f, b in zip(decode_flops, blocks)] + [0.0]
    return Chain.make(uf=uf, ub=ub, wa=[0.0] + blocks, wabar=blocks + [0.0],
                      wdelta=np.zeros(cfg.num_layers + 1), host=host)


def plan_serving(cfg, budget: Union[Budget, str, float], *, batch: int,
                 prompt_len: int, host: HostTransferModel,
                 max_len: Optional[int] = None,
                 num_slots: Optional[int] = None,
                 impl: Optional[str] = None,
                 on_infeasible: str = "min_memory",
                 recompute_penalty: float = DEFAULT_RECOMPUTE_PENALTY,
                 device_flops: float = DEFAULT_DEVICE_FLOPS,
                 hbm_bandwidth: float = DEFAULT_HBM_BANDWIDTH) -> MemoryPlan:
    """Plan KV-cache residency for the decode path: which layers' prefix KV
    lives on the card and which in host RAM under ``budget`` bytes of
    device KV (a :class:`Budget`, the budget grammar — ``"1.5G"``,
    ``"x0.5"`` — or bytes).  An infeasible budget raises
    :class:`InfeasiblePlanError`, or with ``on_infeasible="min_memory"``
    falls back to the smallest-memory schedule (reporting its budget).
    Returns a ``"device+kv"`` :class:`MemoryPlan`;
    :func:`..runtime.serve_loop.run_serving` runs it with ``plan=``."""
    if isinstance(budget, Budget):
        b = budget
    elif isinstance(budget, str):
        b = Budget.parse(budget)
    else:
        b = Budget.bytes(float(budget))
    chain = kv_chain(cfg, batch=batch, prompt_len=prompt_len,
                     max_len=max_len, host=host, device_flops=device_flops,
                     hbm_bandwidth=hbm_bandwidth,
                     recompute_penalty=recompute_penalty)
    request = PlanRequest(strategy="optimal", budget=b,
                          tiers=("device", "kv"), host=chain.host,
                          num_slots=num_slots, impl=impl,
                          on_infeasible=on_infeasible)
    return build_plan(request, chain)


def kv_residency_layers(plan: MemoryPlan,
                        budget_bytes: Optional[float] = None) -> List[int]:
    """The 0-based model layers whose prefix KV the plan stages to host.

    The schedule's ``Foff`` args (activation ``a^i`` ↔ layer ``i-1``), then
    a deterministic clamp of that set to the budget the decode loop can
    execute: grow it largest-block first until the resident blocks plus one
    in flight fit, then drop staged blocks (smallest first) the budget
    never needed.  ``budget_bytes`` overrides the plan's own budget (e.g.
    the requested one when the plan fell back to min-memory)."""
    if plan.chain is None:
        raise ValueError("kv_residency_layers needs a plan built from a "
                         "kv chain")
    blocks = np.asarray(plan.chain.wa[1:], dtype=float)
    staged = {arg - 1 for op, arg in plan.schedule.ops
              if op == "Foff" and arg >= 1}
    budget = plan.budget_bytes if budget_bytes is None else float(budget_bytes)
    if budget is None:
        return sorted(staged)

    def fits(st) -> bool:
        resident = blocks.sum() - sum(blocks[j] for j in st)
        transient = max((blocks[j] for j in st), default=0.0)
        return resident + transient <= budget

    for j in sorted(range(len(blocks)), key=lambda j: (-blocks[j], j)):
        if fits(staged):
            break
        staged.add(j)
    for j in sorted(staged, key=lambda j: (blocks[j], j)):
        if fits(staged - {j}):
            staged.discard(j)
    return sorted(staged)
