"""Attention: GQA/MQA (+RoPE, optional QKV bias) and DeepSeek-style MLA,
with their prefill and KV-cache decode paths — the port of
``repro.models.attention``.

Masking is spec-driven; the causal flash path (:mod:`..kernels.flash_attention`)
is taken where the JAX package's training path takes it (GQA only), and
also by ``gqa_prefill``, whose JAX counterpart always runs the plain path.
Otherwise the scores are computed directly for sequences up to
``DIRECT_ATTEND_MAX`` and in q blocks of ``cfg.attn_block_q`` above it, each
block under its own checkpoint when a gradient is wanted, so the scores'
memory is O(block × S).  Decode attends one new token to the cache with
plain float32 scores, as the JAX package does; the cache may be stored in
``cfg.kv_cache_dtype`` (fp8 allowed) and is read in the model's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def _q_blocks(fn: Callable, qs, block_q: int, dim: int = 1
              ) -> torch.Tensor:
    """``fn(*q_block_slices, q0)`` over the q blocks of ``qs`` (each sliced
    along ``dim``), concatenated along ``dim``; each block runs under a
    non-reentrant checkpoint when autograd records, so its scores are
    recomputed in the backward instead of kept."""
    Sq = qs[0].shape[1]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in qs)
    outs = []
    for q0 in range(0, Sq, block_q):
        blk = [t[:, q0:q0 + block_q] for t in qs]
        outs.append(checkpoint(fn, *blk, q0, use_reentrant=False) if grad
                    else fn(*blk, q0))
    return torch.cat(outs, dim=dim)


def _attend(q, k, v, spec: MaskSpec, q_offset: int = 0, block_q: int = 512,
            use_flash: bool = False) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Skv,K,D) grouped. Spec-masked attention."""
    Sq = q.shape[1]
    if use_flash and spec.causal and not spec.prefix_len and not spec.window:
        return flash_ops.flash_attention(q, k, v)
    if Sq <= DIRECT_ATTEND_MAX:
        return _block_scores_gqa(q, k, v, q_offset, spec)
    return _q_blocks(lambda qb, q0: _block_scores_gqa(qb, k, v, q_offset + q0,
                                                      spec),
                     [q], min(block_q, Sq))


def gqa_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, (H, Dh), dtype, device, use_bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, (K, Dh), dtype, device, use_bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, (K, Dh), dtype, device, use_bias=cfg.qkv_bias),
        "wo": dense_init(gen, H * Dh, d, dtype, device,
                         scale=1.0 / math.sqrt(H * Dh * max(cfg.num_layers, 1))),
    }



def gqa_param_axes(cfg) -> Params:
    """Logical axes of :func:`gqa_init`'s tree (``distributed.sharding``)."""
    qb = {"bias": ("heads", None)} if cfg.qkv_bias else {}
    kb = {"bias": ("kv", None)} if cfg.qkv_bias else {}
    return {
        "wq": {"kernel": ("embed", "heads", None), **qb},
        "wk": {"kernel": ("embed", "kv", None), **kb},
        "wv": {"kernel": ("embed", "kv", None), **kb},
        "wo": {"kernel": ("heads_merged", "embed")},
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
    return gqa_prefill(p, cfg, x, positions, spec)[0]


def gqa_prefill(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                spec: MaskSpec
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence forward and its keys and values ``{"k", "v"}``
    (B, S, K, Dh), on the flash kernel where ``gqa_apply`` takes it."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, positions)
    out = _attend(q, k, v, spec, block_q=cfg.attn_block_q,
                  use_flash=cfg.use_flash_attention)
    return dense_apply(p["wo"], out.reshape(B, S, -1)), {"k": k, "v": v}


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Store one position's ``new`` (B, 1, ...) at ``pos``, in place, in the
    cache's dtype."""
    cache[:, pos] = new[:, 0].to(cache.dtype)


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); cache k/v: (B, S_max, K, Dh), written
    at ``pos`` in place; attends to positions ``<= pos`` (and the sliding
    window).  Returns ``(y, cache)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions)
    _write(cache["k"], k_new, pos)
    _write(cache["v"], v_new, pos)
    lo = max(pos - cfg.sliding_window + 1, 0) if cfg.sliding_window else 0
    kc = cache["k"][:, lo:pos + 1].to(q.dtype)  # fp8 storage: compute in
    vc = cache["v"][:, lo:pos + 1].to(q.dtype)  # the model dtype
    K, H, D = kc.shape[2], q.shape[2], q.shape[3]
    qg = q.reshape(B, 1, K, H // K, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          kc.float()) / math.sqrt(D)
    probs = torch.softmax(logits, dim=-1).to(vc.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vc).reshape(B, 1, -1)
    return dense_apply(p["wo"], out), cache


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



def mla_param_axes(cfg) -> Params:
    """Logical axes of :func:`mla_init`'s tree."""
    return {
        "wq": {"kernel": ("embed", "heads", None)},
        "wkv_a": {"kernel": ("embed", "kv_lora")},
        "kv_norm": {"scale": (None,)},
        "wk_b": {"kernel": ("kv_lora", "heads", None)},
        "wv_b": {"kernel": ("kv_lora", "heads", None)},
        "wo": {"kernel": ("heads_merged", "embed")},
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


def _mla_attend(p: Params, cfg, q_nope, q_rope, c_kv, k_rope,
                spec: MaskSpec) -> torch.Tensor:
    B, Sq = q_nope.shape[:2]
    if Sq <= DIRECT_ATTEND_MAX:
        out = _mla_block(p, cfg, q_nope, q_rope, c_kv, k_rope, 0, spec)
    else:
        out = _q_blocks(lambda qn, qr, q0: _mla_block(
            p, cfg, qn, qr, c_kv, k_rope, q0, spec), [q_nope, q_rope],
            min(cfg.attn_block_q, Sq))
    return dense_apply(p["wo"], out.reshape(B, Sq, -1))


def mla_apply(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
              spec: MaskSpec) -> torch.Tensor:
    return mla_prefill(p, cfg, x, positions, spec)[0]


def mla_prefill(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                spec: MaskSpec
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence forward and its latent cache ``{"c_kv": (B, S, r),
    "k_rope": (B, S, 1, dr)}``."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    y = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, spec)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode on the latent cache (written at ``pos`` in place),
    with the up-projection of K absorbed into the query."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(p, cfg, x, positions)
    _write(cache["c_kv"], c_new, pos)
    _write(cache["k_rope"], kr_new, pos)
    ckc = cache["c_kv"][:, :pos + 1].to(x.dtype)     # fp8 storage: compute
    krc = cache["k_rope"][:, :pos + 1].to(x.dtype)   # in the model dtype
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["wk_b"]["kernel"].to(q_nope.dtype))
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckc.float())
              + torch.einsum("bqhd,bsod->bhqs", q_rope.float(), krc.float()))
    logits = logits / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    probs = torch.softmax(logits, dim=-1).to(ckc.dtype)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckc)
    out = torch.einsum("bqhr,rhd->bqhd", ctx,
                       p["wv_b"]["kernel"].to(ctx.dtype))
    return dense_apply(p["wo"], out.reshape(B, 1, -1)), cache
