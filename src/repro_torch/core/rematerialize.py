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
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
from torch.utils.checkpoint import checkpoint

from .solver import AllNode, CkNode, Leaf, Tree

StageFn = Callable  # (stage_params, activation) -> activation


def remat(fn: Callable, *args):
    """``fn(*args)`` keeping only its inputs: the repo's one checkpoint call
    (non-reentrant, so the inputs may be dicts of tensors; no RNG state is
    saved because no stage draws random numbers)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def build_remat_fn(tree: Tree, stages: Sequence[StageFn]) -> Callable:
    """Return ``f(params, x)`` executing the chain per the schedule tree;
    ``stages[l-1]`` is the callable for paper-stage ``l`` (1-based)."""

    def rec(node: Tree) -> Callable:
        if isinstance(node, Leaf):
            s = node.s
            return lambda params, x: stages[s - 1](params[s - 1], x)
        if isinstance(node, AllNode):
            s = node.s
            rest = rec(node.rest)
            return lambda params, x: rest(params, stages[s - 1](params[s - 1], x))
        if isinstance(node, CkNode):
            left = rec(node.left)    # stages [s, sp-1]
            right = rec(node.right)  # stages [sp, t]
            return lambda params, x: right(params, remat(left, params, x))
        raise TypeError(f"unknown tree node {node!r}")

    return rec(tree)


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


def count_checkpoint_scopes(tree: Tree) -> int:
    if isinstance(tree, Leaf):
        return 0
    if isinstance(tree, AllNode):
        return count_checkpoint_scopes(tree.rest)
    return 1 + count_checkpoint_scopes(tree.left) + count_checkpoint_scopes(tree.right)
