"""Attention: GQA/MQA (+RoPE, optional QKV bias) and DeepSeek-style MLA —
the training paths of ``repro.models.attention``.

Masking is spec-driven; the causal flash path (:mod:`..kernels.flash_attention`)
is taken exactly where the JAX package takes it (GQA only), and otherwise the
scores are computed directly for sequences up to ``DIRECT_ATTEND_MAX``.  The
q-block chunked path for longer sequences is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..kernels.flash_attention import ops as flash_ops
from .common import apply_rope, dense_apply, dense_init, rms_norm

Params = Dict[str, Any]

NEG = -1e30
DIRECT_ATTEND_MAX = 2048


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    prefix_len: int = 0                  # first N kv positions bidirectional
    window: Optional[int] = None         # sliding window width
    kv_len: Optional[int] = None         # true kv length (padding cutoff)

    def block(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
        """Boolean mask for broadcastable position index tensors."""
        m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                       dtype=torch.bool, device=q_pos.device)
        if self.causal:
            c = k_pos <= q_pos
            if self.prefix_len:
                c = c | (k_pos < self.prefix_len)
            m = m & c
        if self.window:
            m = m & (k_pos > q_pos - self.window)
        if self.kv_len is not None:
            m = m & (k_pos < self.kv_len)
        return m


def _block_scores_gqa(qblk, k, v, q0: int, spec: MaskSpec) -> torch.Tensor:
    """qblk: (B,bq,H,D); k/v: (B,S,K,D). Returns (B,bq,H,Dv)."""
    B, bq, H, D = qblk.shape
    S, K = k.shape[1], k.shape[2]
    qg = qblk.reshape(B, bq, K, H // K, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(D)
    q_pos = q0 + torch.arange(bq, device=qblk.device)[:, None]
    k_pos = torch.arange(S, device=qblk.device)[None, :]
    mask = spec.block(q_pos, k_pos)                      # (bq, S)
    logits = torch.where(mask, logits, torch.full((), NEG, device=qblk.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, bq, H, -1)


def _attend(q, k, v, spec: MaskSpec, q_offset: int = 0,
            use_flash: bool = False) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Skv,K,D) grouped. Spec-masked attention."""
    Sq = q.shape[1]
    if use_flash and spec.causal and not spec.prefix_len and not spec.window:
        return flash_ops.flash_attention(q, k, v)
    if Sq <= DIRECT_ATTEND_MAX:
        return _block_scores_gqa(q, k, v, q_offset, spec)
    raise NotImplementedError(
        f"the q-block chunked attention path (Sq > {DIRECT_ATTEND_MAX}) is "
        f"not ported; use use_flash_attention=True for causal training")


def gqa_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, (H, Dh), dtype, device, use_bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, (K, Dh), dtype, device, use_bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, (K, Dh), dtype, device, use_bias=cfg.qkv_bias),
        "wo": dense_init(gen, H * Dh, d, dtype, device,
                         scale=1.0 / math.sqrt(H * Dh * max(cfg.num_layers, 1))),
    }


def _gqa_qkv(p, cfg, x, positions):
    q = dense_apply(p["wq"], x)            # (B,S,H,Dh)
    k = dense_apply(p["wk"], x)            # (B,S,K,Dh)
    v = dense_apply(p["wv"], x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.query_scale is not None:
        q = q * cfg.query_scale
    return q, k, v


def gqa_apply(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
              spec: MaskSpec) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    out = _attend(q, k, v, spec, use_flash=cfg.use_flash_attention
                  and spec.causal and not spec.prefix_len and not spec.window)
    return dense_apply(p["wo"], out.reshape(B, S, -1))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 Multi-head Latent Attention)
# ---------------------------------------------------------------------------
# The -Lite variant: no query compression; K/V compressed to a rank-
# ``kv_lora_rank`` latent plus one rotary key shared by the heads.  A stage
# saves the latent and the shared key instead of per-head K/V, so its ā
# differs sharply from a GQA stage's.

def mla_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init(gen, d, (H, dn + dr), dtype, device),
        "wkv_a": dense_init(gen, d, r + dr, dtype, device),
        "kv_norm": {"scale": torch.ones((r,), dtype=dtype, device=device)},
        "wk_b": dense_init(gen, r, (H, dn), dtype, device),
        "wv_b": dense_init(gen, r, (H, dv), dtype, device),
        "wo": dense_init(gen, H * dv, d, dtype, device, scale=1.0 / math.sqrt(
            H * dv * max(cfg.num_layers, 1))),
    }


def _mla_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = dense_apply(p["wq"], x)                              # (B,S,H,dn+dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = dense_apply(p["wkv_a"], x)                          # (B,S,r+dr)
    c_kv = rms_norm(p["kv_norm"], kv[..., :r])
    k_rope = apply_rope(kv[:, :, None, r:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope          # k_rope: (B,S,1,dr)


def _mla_block(p: Params, cfg, q_nope, q_rope, c_kv, k_rope, q0: int,
               spec: MaskSpec) -> torch.Tensor:
    """Latent-space attention (the up-projection of K absorbed into the
    query, that of V applied to the latent context); float32 scores."""
    bq, S = q_nope.shape[1], c_kv.shape[1]
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["wk_b"]["kernel"].to(q_nope.dtype))
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv.float())
              + torch.einsum("bqhd,bsod->bhqs", q_rope.float(),
                             k_rope.float()))
    logits = logits / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_pos = q0 + torch.arange(bq, device=c_kv.device)[:, None]
    k_pos = torch.arange(S, device=c_kv.device)[None, :]
    logits = torch.where(spec.block(q_pos, k_pos), logits,
                         torch.full((), NEG, device=c_kv.device))
    probs = torch.softmax(logits, dim=-1).to(c_kv.dtype)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)        # latent context
    return torch.einsum("bqhr,rhd->bqhd", ctx,
                        p["wv_b"]["kernel"].to(ctx.dtype))


def mla_apply(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
              spec: MaskSpec) -> torch.Tensor:
    B, Sq, _ = x.shape
    if Sq > DIRECT_ATTEND_MAX:
        raise NotImplementedError(
            f"the q-block chunked MLA path (Sq > {DIRECT_ATTEND_MAX}) is not "
            f"ported")
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    out = _mla_block(p, cfg, q_nope, q_rope, c_kv, k_rope, 0, spec)
    return dense_apply(p["wo"], out.reshape(B, Sq, -1))
