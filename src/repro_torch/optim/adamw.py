"""AdamW with global-norm clipping over a list of parameter tensors.

Moments are float32 whatever the parameter dtype; weight decay applies to
tensors with ``ndim >= 2`` only (matrices, not norms or biases).  The update
is in place (parameters and moments are overwritten), which keeps one copy of
the optimizer state on the device.

Parameters, gradients and moments may be DTensors with the same placements
(a ZeRO-3 run): the update then runs on each rank's shards, and the global
norms are an all-reduce of the shards' squared sums, each shard counted once
however many ranks hold it, so clipping is the unsharded run's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import all_reduce, local_tensor, replication


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def adamw_init(params: Sequence[torch.Tensor]) -> dict:
    """Zero moments shaped (and, for DTensors, placed) like ``params``."""
    with torch.no_grad():
        return {"mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                "count": 0}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    if not any(isinstance(x, DTensor) for x in tensors):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tensors))
    total = sum(torch.sum(torch.square(local_tensor(x).float()))
                / replication(x) for x in tensors)
    return torch.sqrt(all_reduce(total))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Sequence[torch.Tensor],
                 state: dict, params: Sequence[torch.Tensor],
                 lr: Optional[float] = None) -> dict:
    """One AdamW step, in place on ``params`` and ``state``; returns the
    ``grad_norm`` (before clipping) and ``param_norm`` (before the step)."""
    gnorm = global_norm(grads)
    pnorm = global_norm(params)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = [local_tensor(g) * scale.to(g.dtype) for g in grads]
    state["count"] += 1
    count = torch.tensor(float(state["count"]), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** count)
    bc2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** count)
    lr = cfg.lr if lr is None else lr
    for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
        p, g, m, v = (local_tensor(t) for t in (p, g, m, v))
        gf = g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:
            step.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * step)
    return {"grad_norm": gnorm, "param_norm": pnorm}
