"""Input-shape cells and their ``meta``-tensor stand-ins."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


def input_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a text cell
    (shapes and dtypes only, nothing allocated): a training batch, a
    prefill's prompt, or a decode step's one new token (the cache's specs
    come from ``StagedLM.init_cache`` on ``meta``)."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"input specs of {cfg.modality!r} cells are not ported")
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        return {"tokens": spec((B, S)), "labels": spec((B, S)),
                "loss_mask": spec((B, S), torch.float32)}
    if shape.kind == "prefill":
        return {"tokens": spec((B, S))}
    return {"tokens": spec((B, 1))}
