"""The four assigned input-shape sets, their applicability rules, and
``meta``-tensor stand-ins for a cell's inputs."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic sequence mixing: only the SSM and hybrid
# archs run it; the full-attention archs skip it
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "zamba2-2.7b")


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def cells(archs) -> List[Tuple[str, str]]:
    """All assigned (arch × shape) dry-run cells."""
    return [(a, s) for a in archs for s in SHAPES if applicable(a, s)]


def input_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a cell (shapes
    and dtypes only, nothing allocated): a training batch, a prefill's
    prompt, or a decode step's one new token (the cache's specs come from
    ``StagedLM.init_cache`` on ``meta``).  An audio model takes frame
    embeddings in the model dtype (a decode step one frame); a VLM the
    image prefix and ``seq_len - prefix_len`` tokens, as the JAX package's
    ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    f = cfg.dtype

    def spec(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        if cfg.modality == "audio_embed":
            return {"tokens": spec((B, 1, cfg.d_model), f)}
        return {"tokens": spec((B, 1))}
    if cfg.modality == "audio_embed":
        specs = {"embeds": spec((B, S, cfg.d_model), f)}
        T = S
    elif cfg.modality == "vlm":
        P = cfg.prefix_len
        specs = {"image_embeds": spec((B, P, cfg.d_model), f),
                 "tokens": spec((B, S - P))}
        T = S - P
    else:
        specs = {"tokens": spec((B, S))}
        T = S
    if shape.kind == "train":
        specs.update(labels=spec((B, T)),
                     loss_mask=spec((B, T), torch.float32))
    return specs
