"""Dense feed-forward variants: SwiGLU, GeGLU and the plain GELU MLP (the
dense part of ``repro.models.mlp``; MoE is not ported yet)."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import dense_apply, dense_init

Params = Dict[str, Any]


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             kind: str = "swiglu", num_layers: int = 1) -> Params:
    out_scale = 1.0 / math.sqrt(d_ff * max(num_layers, 1))
    if kind in ("swiglu", "geglu"):
        return {
            "wi_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "wi_up": dense_init(gen, d_model, d_ff, dtype, device),
            "wo": dense_init(gen, d_ff, d_model, dtype, device,
                             scale=out_scale),
        }
    return {  # plain gelu MLP (StarCoder2, MusicGen)
        "wi": dense_init(gen, d_model, d_ff, dtype, device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device, scale=out_scale),
    }


def mlp_apply(p: Params, x: torch.Tensor, kind: str = "swiglu"
              ) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(dense_apply(p["wi_gate"], x)) * dense_apply(p["wi_up"], x)
    elif kind == "geglu":
        h = (F.gelu(dense_apply(p["wi_gate"], x), approximate="tanh")
             * dense_apply(p["wi_up"], x))
    else:
        h = F.gelu(dense_apply(p["wi"], x), approximate="tanh")
    return dense_apply(p["wo"], h)
