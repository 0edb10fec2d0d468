"""The nests of dicts and lists that hold parameters and activations."""

from __future__ import annotations

from typing import Any, Callable, List

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
