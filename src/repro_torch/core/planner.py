"""Parameter estimation (paper §5.1) — the analytic ``Chain`` of a sequence
of PyTorch stage functions, without running anything on a device.

Activation sizes come from one forward of each stage on ``meta`` tensors;
the residual set ``ā`` of a stage is what autograd saves during that forward,
observed with ``torch.autograd.graph.saved_tensors_hooks``.  Times are the
caller's per-stage FLOP counts over a peak rate the caller supplies (on the
card, a measured one): the port carries no device constant.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..tree import tensors_of, tree_bytes
from .chain import Chain, HostTransferModel


def _base(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def _fresh_input(tree: Any) -> Any:
    """A copy of an activation whose floating tensors are new leaves that
    require grad (so autograd saves what the input gradient needs)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            return tree.detach().requires_grad_()
        return tree
    if isinstance(tree, dict):
        return {k: _fresh_input(v) for k, v in tree.items()}
    return tree


def residual_bytes(fn: Callable, p: Any, a: Any) -> Tuple[Any, int]:
    """``(fn(p, a), ω_ā)`` for one stage: the bytes of every storage autograd
    saves while running the stage, each counted once, leaving out the
    stage's own parameters and its input ``a^{l-1}`` (the paper removes
    model memory from the activation budget, and ``ā^l`` excludes
    ``a^{l-1}``).  Output tensors that were not saved are added, since
    ``ā^l`` includes ``a^l``."""
    excluded = {id(_base(t)) for t in tensors_of(p) + tensors_of(a)}
    saved: Dict[int, torch.Tensor] = {}

    def pack(t: torch.Tensor) -> torch.Tensor:
        b = _base(t)
        if id(b) not in excluded:
            saved[id(b)] = b
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        out = fn(p, a)
    for t in tensors_of(out):
        b = _base(t)
        if id(b) not in excluded:
            saved.setdefault(id(b), b)
    return out, tree_bytes(list(saved.values()))


def profile_stages_analytic(stages: Sequence[Callable], params: Sequence[Any],
                            x: Any, *, flops_fwd: Sequence[float],
                            flops_bwd: Sequence[float],
                            peak_flops: float,
                            host: Optional[HostTransferModel] = None
                            ) -> Chain:
    """Build the chain cost model from a forward on ``meta`` tensors:
    ``params`` and ``x`` should live on the meta device (parameters with
    ``requires_grad``).  ``uf``/``ub`` are ``flops / peak_flops`` seconds;
    ``host`` prices the host tier (a measured link, or ``None``)."""
    if peak_flops <= 0:
        raise ValueError("peak_flops must be positive")
    n = len(stages)
    wa, wabar = [tree_bytes(x)], []
    a = x
    for i, (fn, p) in enumerate(zip(stages, params)):
        out, res = residual_bytes(fn, p, _fresh_input(a))
        wabar.append(res)
        if i < n - 1:
            wa.append(tree_bytes(out))
        a = out
    return Chain.make(uf=[f / peak_flops for f in flops_fwd],
                      ub=[f / peak_flops for f in flops_bwd],
                      wa=wa, wabar=wabar, host=host)
