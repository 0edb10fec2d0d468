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
    """``meta`` tensors standing in for every model input of a text training
    cell (shapes and dtypes only, nothing allocated)."""
    if shape.kind != "train" or cfg.modality != "text":
        raise NotImplementedError(
            f"input specs of {shape.kind!r} {cfg.modality!r} cells are not "
            f"ported")
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
            "labels": torch.empty((B, S), dtype=torch.int32, device="meta"),
            "loss_mask": torch.empty((B, S), dtype=torch.float32,
                                     device="meta")}
