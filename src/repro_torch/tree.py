"""The nests of dicts and lists that hold parameters and activations."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch


def tensors_of(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves, in insertion order (``None`` leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every non-container leaf, structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))


def with_tensors(template: Any, leaves: Sequence[Optional[torch.Tensor]],
                 floating_only: bool = False) -> Any:
    """``template``'s structure with its tensor leaves (only the floating
    ones, with ``floating_only``) replaced by ``leaves`` in order; other
    leaves become ``None``."""
    it = iter(leaves)

    def pick(t):
        if isinstance(t, torch.Tensor) and (t.is_floating_point()
                                            or not floating_only):
            return next(it)
        return None

    return tree_map(pick, template)
