"""Shared layer primitives (functional init/apply pairs on tensor dicts)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.rmsnorm import ops as rmsnorm_ops

Params = Dict[str, Any]


def truncated_normal_init(gen: torch.Generator, shape, dtype, scale: float,
                          device) -> torch.Tensor:
    """2-sigma truncated normal times ``scale`` (drawn in float32)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (scale * t).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dims, dtype, device,
               use_bias: bool = False, scale: Optional[float] = None
               ) -> Params:
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p: Params = {"kernel": truncated_normal_init(gen, (in_dim,) + out_dims,
                                                 dtype, scale, device)}
    if use_bias:
        p["bias"] = torch.zeros(out_dims, dtype=dtype, device=device)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in_dim) @ kernel: (in_dim, *out_dims) -> (..., *out_dims)."""
    k = p["kernel"]
    out_dims = k.shape[1:]
    y = torch.matmul(x, k.to(x.dtype).reshape(k.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *out_dims)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def rms_norm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm through the fused kernel (plain version off the card)."""
    return rmsnorm_ops.rms_norm(x, p["scale"], eps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    D = x.shape[-1]
    exponents = torch.arange(0, D, 2, dtype=torch.float32,
                             device=x.device) / D
    freqs = 1.0 / (theta ** exponents)                            # (D/2,)
    angles = positions[..., None].float() * freqs                 # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, offset: int = 0,
                         device=None) -> torch.Tensor:
    """MusicGen-style sinusoidal embeddings, (seq_len, dim), float32: sin on
    the even columns, cos on the odd ones."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    emb = torch.zeros((seq_len, dim), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(pos * div)
    emb[:, 1::2] = torch.cos(pos * div)
    return emb


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean xent; logits (B,S,V) any float dtype, labels (B,S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
