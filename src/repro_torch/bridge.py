"""Weights carried between the JAX package and the port, through numpy.

The port keeps the JAX ``StagedLM`` pytree layout exactly — the same nested
dict keys, the chunk list, stacked ``(length, ...)`` chunk leaves and dense
kernels as ``(in_dim, *out_dims)`` — so a leaf maps to a tensor of the same
shape with no transpose, and gradients map back leaf by leaf on the same
tree paths.  The conv chain (``configs.paper_resnet``) is the exception: its
kernels are HWIO in the JAX package and OIHW in the port, converted both
ways by :func:`chain_params_from_numpy` and :func:`chain_grads_to_numpy`.
The decode cache differs too: the JAX package stacks it per chunk, the
port keeps one dict per layer (:func:`cache_from_numpy`,
:func:`cache_to_numpy`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .models.lm import StagedLM
from .tree import tree_map


def _to_tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree: Any, cfg, device) -> Any:
    """JAX ``StagedLM.init`` parameters (numpy leaves) → the port's tensors on
    ``device``, in the config's parameter dtype, requiring grad (an audio
    model's empty ``embed`` tree carries across as it is).  Raises if the
    tree does not have the port model's structure and shapes."""
    ref = StagedLM(cfg).init(device="meta")

    def convert(a, r):
        t = _to_tensor(a)
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"leaf of shape {tuple(t.shape)} where the port "
                             f"model has {tuple(r.shape)}")
        return t.to(device=device, dtype=r.dtype).requires_grad_()

    def walk(node, r):
        if isinstance(r, dict):
            if set(node) != set(r):
                raise ValueError(f"keys {sorted(node)} where the port model "
                                 f"has {sorted(r)}")
            return {k: walk(node[k], r[k]) for k in r}
        if isinstance(r, list):
            if len(node) != len(r):
                raise ValueError(f"{len(node)} chunks where the port model "
                                 f"has {len(r)}")
            return [walk(n, x) for n, x in zip(node, r)]
        return convert(node, r)

    return walk(tree, ref)


def params_to_numpy(tree: Any) -> Any:
    """Tensors (parameters or gradients) → float32 numpy leaves, same
    structure."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def chain_params_from_numpy(params: Any, device) -> Any:
    """The JAX conv chain's per-stage parameters (HWIO kernels as numpy
    arrays) → the port's (OIHW float32 tensors on ``device``, requiring
    grad), stage by stage with the same keys."""
    return [{k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v, np.float32).transpose(3, 2, 0, 1))).to(device)
        .requires_grad_() for k, v in p.items()} for p in params]


def chain_grads_to_numpy(grads: Any) -> Any:
    """Inverse of :func:`chain_params_from_numpy` for the port's per-stage
    gradients: OIHW tensors → HWIO float32 numpy arrays."""
    return [{k: v.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
             for k, v in g.items()} for g in grads]


def cache_from_numpy(cache: Any, cfg, device) -> dict:
    """The JAX package's decode cache (``{"pos", "chunks": [stacked per
    chunk], "shared": stacked per invocation}``, numpy leaves) → the port's
    (one dict per layer and per shared invocation, ``pos`` an int)."""
    layers = [{k: _to_tensor(v[off]).to(device)
               for k, v in cache["chunks"][ci].items()}
              for ci, off in cfg.layer_slices]
    sh = cache.get("shared")
    shared = [] if sh is None else [
        {k: _to_tensor(sh[k][i]).to(device) for k in sh}
        for i in range(len(sh["k"]))]
    return {"pos": int(np.asarray(cache["pos"])), "layers": layers,
            "shared": shared}


def cache_to_numpy(cache: dict, cfg) -> dict:
    """Inverse of :func:`cache_from_numpy`, float32 numpy leaves."""
    def np_(t):
        return t.float().cpu().numpy()

    chunks = []
    for _, start, length in cfg.chunks:
        block = cache["layers"][start:start + length]
        chunks.append({k: np.stack([np_(c[k]) for c in block])
                       for k in block[0]})
    out = {"pos": np.int32(cache["pos"]), "chunks": chunks}
    if cache["shared"]:
        out["shared"] = {k: np.stack([np_(c[k]) for c in cache["shared"]])
                         for k in cache["shared"][0]}
    return out
