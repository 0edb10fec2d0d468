"""Compile a persistent-schedule recursion tree into nested
``torch.utils.checkpoint`` scopes — the execution path of a two-tier plan.

Correspondence (per node, as in ``repro.core.rematerialize``):

- ``Leaf(s)`` / ``AllNode(s)``  →  stage ``s`` applied *plain*: autograd
  records its saved tensors — this is ``F_all^s`` (+ its later ``B^s``).
- ``CkNode(s, sp, right, left)``  →  ``right_fn ∘ checkpoint(left_fn)``: the
  first forward of the checkpoint runs stages ``s..sp-1`` keeping only their
  input ``a^{s-1}`` (``F_ck^s`` then ``F_∅``); in the backward, ``left_fn`` is
  replayed and *its* own nested checkpoints apply — the recursion on
  ``[s, sp-1]``.

``build_remat_fn`` returns ``f(params, x)`` where ``params`` is the per-stage list;
``torch.autograd`` on its output then executes the schedule's structure.

Every stage forward adds to a tally (:func:`take_counts`): the runs, and
the replays among them, a replay being a forward that runs inside the
backward.  While traced (a tracer, or a ``torch.profiler`` recording) each
stage call is a program span of :mod:`repro_torch.obs.trace`:
``remat.forward`` for its first run, ``remat.replay`` for a run inside the
backward, and ``remat.backward`` from the moment the backward reaches the
stage's output (an identity autograd function there, put in only while
traced) to the moment it reaches the previous stage's, less the replays
that run in between.  On a tracer each span is the schedule op it runs:
the stage's index and ``Fall``/``Fck``/``Fnone`` (the first stage of a
checkpoint's first run is ``Fck``, the others of that run ``Fnone``, a
stage outside any first run ``Fall``) or ``B``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..obs.trace import at_backward_end, on_backward, open_span, profiling
from ..tree import tensors_of, tree_bytes
from .solver import AllNode, CkNode, Leaf, Tree

StageFn = Callable  # (stage_params, activation) -> activation


class _Kept:
    """The values a ``remat(..., keep=True)`` region passed through
    :func:`kept` on its first run, handed back in order on its recompute."""

    def __init__(self):
        self.values: list = []
        self.replay = False
        self.pos = 0


_region = threading.local()


def kept(compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``compute()``; inside a ``remat(..., keep=True)`` region its first
    run keeps the result, and its recompute in the backward gets that
    result back instead of computing it again (the port's
    ``save_only_these_names``: the expert exchange marks its outputs so)."""
    tape = getattr(_region, "tape", None)
    if tape is None:
        return compute()
    if tape.replay:
        tape.pos += 1
        return tape.values[tape.pos - 1]
    out = compute()
    tape.values.append(out.detach())
    return out


def remat(fn: Callable, *args, keep: bool = False):
    """``fn(*args)`` keeping only its inputs: the repo's one checkpoint call
    (non-reentrant, so the inputs may be dicts of tensors; no RNG state is
    saved because no stage draws random numbers).  With ``keep``, also
    what ``fn`` passes through :func:`kept`; a region without such values
    is a plain checkpoint."""
    from ..distributed.sharding import reentered

    if keep:
        fn = functools.partial(_keeping, fn, _Kept())
    # the recompute runs under the meshes and rules of the first run
    context = reentered()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), context))


def _keeping(fn: Callable, tape: _Kept, *args):
    outer = getattr(_region, "tape", None)
    _region.tape, tape.pos = tape, 0
    try:
        return fn(*args)
    finally:
        _region.tape, tape.replay = outer, True


#: stage forwards run since the last :func:`take_counts`: all, replays
_runs = [0, 0]


def take_counts() -> tuple:
    """``(stage forwards run, replays among them)`` since the last call,
    and the tally reset."""
    out = (_runs[0], _runs[1])
    _runs[0] = _runs[1] = 0
    return out


_regions = threading.local()


class _Region:
    """A checkpoint's function, counting its calls: the first is the
    checkpoint's first run, the next its recompute.  Each call's kind is
    on a per-thread stack while it runs (tracers only: it names the ops)."""

    def __init__(self, s: int, fn: Callable):
        self.s, self.fn, self.calls = s, fn, 0

    def __call__(self, *args):
        stack = _regions.__dict__.setdefault("stack", [])
        stack.append((self.s, self.calls == 0))
        self.calls += 1
        try:
            return self.fn(*args)
        finally:
            stack.pop()


def _forward_kind(s: int) -> str:
    stack = getattr(_regions, "stack", None)
    if not stack or not stack[-1][1]:
        return "Fall"
    return "Fck" if stack[-1][0] == s else "Fnone"


def _pass_grad_tensors(out: Any, fresh) -> Any:
    """``out`` with its tensors that require grad replaced, in order, by
    ``fresh``'s."""
    if isinstance(out, torch.Tensor):
        return next(fresh) if out.requires_grad else out
    if isinstance(out, dict):
        return {k: _pass_grad_tensors(v, fresh) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_pass_grad_tensors(v, fresh) for v in out)
    return out


class _Traced:
    """One traced call of a remat function: its tracer and stream, and the
    stage whose backward is open."""

    def __init__(self, tracer, stream):
        self.tracer, self.stream = tracer, stream
        self.open = None       # the open remat.backward span
        self.closing = False   # its close is queued at the backward's end

    def stage(self, fn: StageFn, s: int, p: Any, x: Any, replay: bool):
        kind = _forward_kind(s) if self.tracer is not None else None
        if replay and self.open is not None:
            self.open.pause()
        h = open_span("remat.replay" if replay else "remat.forward",
                      self.tracer, kind, s, self.stream)
        out = None
        try:
            out = fn(p, x)
        finally:
            if h is not None:
                h.close(bytes=None if out is None else tree_bytes(out))
            if replay and self.open is not None:
                self.open.resume()
        if replay:
            return out
        marked = [t for t in tensors_of(out) if t.requires_grad]
        if not marked:
            return out
        fresh = on_backward(marked, lambda: self.backward_reaches(s))
        return _pass_grad_tensors(out, iter(fresh))

    def backward_reaches(self, s: int) -> None:
        if self.open is not None:
            self.open.close()
        elif not self.closing:
            self.closing = True
            at_backward_end(self.finish)
        self.open = open_span("remat.backward", self.tracer, "B", s,
                              self.stream)

    def finish(self) -> None:
        if self.open is not None:
            self.open.close()
        self.open, self.closing = None, False


def _stream_of(x: Any):
    ts = tensors_of(x)
    if ts and ts[0].device.type == "cuda":
        return torch.cuda.current_stream(ts[0].device)
    return None


def build_remat_fn(tree: Tree, stages: Sequence[StageFn],
                   tracer=None) -> Callable:
    """Return ``f(params, x)`` executing the chain per the schedule tree;
    ``stages[l-1]`` is the callable for paper-stage ``l`` (1-based).  With
    ``tracer`` (a :class:`~repro_torch.obs.trace.Tracer`) every call
    records one span per schedule op (on CUDA, event pairs on the stream
    ``x`` is on)."""
    if tracer is not None and not tracer.enabled:
        tracer = None

    def stage(s: int) -> Callable:
        fn = stages[s - 1]

        def run(params, x, traced):
            replay = torch._C._current_graph_task_id() != -1
            _runs[0] += 1
            _runs[1] += replay
            if traced is None:
                return fn(params[s - 1], x)
            return traced.stage(fn, s, params[s - 1], x, replay)

        return run

    def rec(node: Tree) -> Callable:
        if isinstance(node, Leaf):
            return stage(node.s)
        if isinstance(node, AllNode):
            first, rest = stage(node.s), rec(node.rest)
            return lambda params, x, t: rest(params, first(params, x, t), t)
        if isinstance(node, CkNode):
            left = rec(node.left)    # stages [s, sp-1]
            right = rec(node.right)  # stages [sp, t]
            if tracer is None:
                return lambda params, x, t: right(
                    params, remat(left, params, x, t), t)
            s = node.s
            return lambda params, x, t: right(
                params, remat(_Region(s, left), params, x, t), t)
        raise TypeError(f"unknown tree node {node!r}")

    root = rec(tree)

    def run(params, x):
        traced = None
        if tracer is not None:
            traced = _Traced(tracer, _stream_of(x))
        elif profiling():
            traced = _Traced(None, None)
        return root(params, x, traced)

    return run


def sequential_tree(length: int) -> Tree:
    """Store-all tree: every stage plain (AllNode chain) — autograd default."""
    node: Tree = Leaf(length + 1)
    for s in range(length, 0, -1):
        node = AllNode(s, node)
    return node


def full_remat_tree(length: int) -> Tree:
    """``F_ck`` every stage: remat everything (max recompute, min memory)."""

    def make(s: int, t: int) -> Tree:
        if s == t:
            return Leaf(s)
        return CkNode(s, s + 1, make(s + 1, t), Leaf(s))

    return make(1, length + 1)


def periodic_tree(length: int, num_segments: int) -> Tree:
    """The `sequential` baseline (torch ``checkpoint_sequential``) as a tree:
    each non-final segment is a CkNode whose left child is a plain
    sub-chain."""
    L = length
    k = max(1, min(num_segments, L))
    bounds = np.linspace(0, L, k + 1).astype(int)
    segments = [(int(bounds[i]) + 1, int(bounds[i + 1])) for i in range(k)]
    segments[-1] = (segments[-1][0], L + 1)  # last segment has the loss

    def plain(a: int, b: int) -> Tree:
        node: Tree = Leaf(b)
        for s in range(b - 1, a - 1, -1):
            node = AllNode(s, node)
        return node

    def rec(i: int) -> Tree:
        a, b = segments[i]
        if i == len(segments) - 1:
            return plain(a, b)
        return CkNode(a, b + 1, rec(i + 1), plain(a, b))

    return rec(0)


def tree_stage_span(tree: Tree) -> tuple:
    """(first, last) stage a tree covers (sanity checking)."""
    if isinstance(tree, Leaf):
        return tree.s, tree.s
    if isinstance(tree, AllNode):
        _, last = tree_stage_span(tree.rest)
        return tree.s, last
    a, _ = tree_stage_span(tree.left)
    _, b = tree_stage_span(tree.right)
    return a, b


def count_checkpoint_scopes(tree: Tree) -> int:
    if isinstance(tree, Leaf):
        return 0
    if isinstance(tree, AllNode):
        return count_checkpoint_scopes(tree.rest)
    return 1 + count_checkpoint_scopes(tree.left) + count_checkpoint_scopes(tree.right)
