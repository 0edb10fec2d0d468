"""Paper-faithful eager executor (the port of ``repro.core.executor``): runs
a schedule's op sequence literally.  The op walker itself is
:func:`repro_torch.offload.executor.execute_offload_schedule`, whose op set
is a superset of Table 1's (it adds ``Foff``/``Prefetch``); this module keeps
the two-tier entry point and the plain-autograd oracle."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from ..tree import tensors_of, tree_map, with_tensors
from .planner import _fresh_input
from .schedule import Schedule


def execute_schedule(schedule: Schedule, stages: Sequence[Callable],
                     params: Sequence[Any], x: Any,
                     loss_cotangent: Any = None,
                     track_live_bytes: bool = False, tracer=None):
    """Run forward and backward per ``schedule``; returns ``(loss_output,
    param_grads, input_grad)`` (and the peak of the saved set in bytes with
    ``track_live_bytes``) — see ``execute_offload_schedule``.  ``tracer``
    (opt-in) records one span per op."""
    from ..offload.executor import execute_offload_schedule
    return execute_offload_schedule(
        schedule, stages, params, x, loss_cotangent=loss_cotangent,
        track_live_bytes=track_live_bytes, tracer=tracer)


def value_and_grads(fn: Callable, params: Sequence[Any], x: Any
                    ) -> Tuple[Any, List[Any], Any]:
    """``fn(params, x)`` and its gradients for a cotangent of ones:
    ``(output, per-stage parameter gradients, input gradient)`` shaped as
    :func:`execute_schedule` shapes them (zeros where a parameter is
    unused, ``None`` at non-floating input leaves).  Each stage runs on
    aliases of its own (``view_as``), so a tensor that several stages share
    (Zamba2's shared block) gets each stage's part, as the schedule walker
    returns it, not the total at every stage."""
    inp = _fresh_input(x)
    with torch.enable_grad():
        params = [tree_map(lambda t: t.view_as(t)
                           if isinstance(t, torch.Tensor) else t, p)
                  for p in params]
        out = fn(params, inp)
    ins = [t for t in tensors_of(inp) if t.is_floating_point()]
    ps = [tensors_of(p) for p in params]
    flat = [t for group in ps for t in group]
    got = torch.autograd.grad(out, ins + flat, torch.ones_like(out),
                              allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(ins + flat, got)]
    grads, k = [], len(ins)
    for p, group in zip(params, ps):
        grads.append(with_tensors(p, got[k:k + len(group)]))
        k += len(group)
    return out.detach(), grads, with_tensors(x, got[:len(ins)],
                                             floating_only=True)


def reference_grads(stages: Sequence[Callable], params: Sequence[Any], x: Any
                    ) -> Tuple[Any, List[Any], Any]:
    """Plain autograd over the composed chain — the correctness oracle
    (:func:`value_and_grads` of the plain composition)."""

    def composed(ps, a):
        for fn, p in zip(stages, ps):
            a = fn(p, a)
        return a

    return value_and_grads(composed, params, x)
