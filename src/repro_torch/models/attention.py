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

Model-axis tensor parallelism (:mod:`..distributed.tensor_parallel`): a
block whose query-head weights are this rank's share runs split by heads —
*f* on its input, ``wq``/``wk``/``wv`` column-parallel (K3 on the rank's
``H/M`` query heads and their KV heads), ``wo`` row-parallel and *g*.
Where the model axis does not divide the KV heads (MQA) the KV weights are
replicated: the rank slices the heads its query heads read, through *f* so
that their gradient is summed.  MLA splits ``wq``, ``wk_b``, ``wv_b`` and
``wo`` by heads; every rank computes the replicated latent, whose weights
pass through *f*.  Decode over a cache cut along the sequence
(``DECODE_RULES``) gathers the query heads, attends the rank's positions
and merges the ranks' partial results by their log-sum-exp; the new
position is written by the rank that holds it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed import tensor_parallel as tp
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

def _kv_heads(cfg, axis: tp.ModelAxis) -> Tuple[int, int]:
    """The KV heads ``[kv0, kv1)`` that this rank's query heads read, where
    the model axis splits the query heads but not the (replicated) KV
    heads: each rank's heads must read whole groups, or one KV head."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    q0, q1 = axis.slice(H)
    g = H // K
    kv0, kv1 = q0 // g, (q1 - 1) // g + 1
    if (q1 - q0) % g and g % (q1 - q0):
        raise NotImplementedError(
            f"{H} query heads over {K} KV heads on a model axis of "
            f"{axis.size}: a rank's {q1 - q0} query heads do not read whole "
            f"KV groups of {g}")
    return kv0, kv1


def _kv_weights(p: Params, cfg, axis: Optional[tp.ModelAxis]):
    """``wk``, ``wv`` as this rank computes them: its shards, or (KV heads
    replicated on a split block) the slice of heads its query heads read,
    through *f*."""
    wk, wv = p["wk"], p["wv"]
    if axis is None or wk["kernel"].shape[1] != cfg.n_kv_heads:
        return wk, wv
    kv0, kv1 = _kv_heads(cfg, axis)

    def cut(w):
        out = {"kernel": tp.copy_to_model(w["kernel"], axis)[:, kv0:kv1]}
        if "bias" in w:
            out["bias"] = tp.copy_to_model(w["bias"], axis)[kv0:kv1]
        return out

    return cut(wk), cut(wv)


def _rope_scale(cfg, q, k, positions):
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.query_scale is not None:
        q = q * cfg.query_scale
    return q, k


def _gqa_qkv(p, cfg, x, positions):
    """``(q, k, v, axis)``: the rank's query heads and the KV heads they
    read; ``axis`` the model axis when the block runs split."""
    axis = tp.split_by(p["wq"]["kernel"].shape[1], cfg.n_heads)
    x = tp.copy_to_model(x, axis)
    wk, wv = _kv_weights(p, cfg, axis)
    q = dense_apply(p["wq"], x)            # (B,S,H,Dh)
    k = dense_apply(wk, x)                 # (B,S,K,Dh)
    v = dense_apply(wv, x)
    q, k = _rope_scale(cfg, q, k, positions)
    return q, k, v, axis


def _whole_kv(p, cfg, x, positions, k, v, axis):
    """All ``n_kv_heads`` of this position range's keys and values, from
    the rank's (no gradient: the decode cache's content): gathered where
    the model axis splits them, else computed with the replicated
    weights."""
    if axis is None or k.shape[2] == cfg.n_kv_heads:
        return k, v
    if p["wk"]["kernel"].shape[1] < cfg.n_kv_heads:
        return (tp.gather_from_model(k, 2, axis),
                tp.gather_from_model(v, 2, axis))
    k = dense_apply(p["wk"], x)
    v = dense_apply(p["wv"], x)
    if cfg.use_rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_apply(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
              spec: MaskSpec) -> torch.Tensor:
    return gqa_prefill(p, cfg, x, positions, spec)[0]


def gqa_prefill(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                spec: MaskSpec, whole_kv: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence forward and its keys and values ``{"k", "v"}``
    (B, S, K, Dh), on the flash kernel where ``gqa_apply`` takes it.  On a
    split block the keys and values are the rank's heads, or all of them
    with ``whole_kv``."""
    B, S, _ = x.shape
    q, k, v, axis = _gqa_qkv(p, cfg, x, positions)
    out = _attend(q, k, v, spec, block_q=cfg.attn_block_q,
                  use_flash=cfg.use_flash_attention)
    y = tp.reduce_from_model(dense_apply(p["wo"], out.reshape(B, S, -1)),
                             axis)
    if whole_kv:
        k, v = _whole_kv(p, cfg, x, positions, k, v, axis)
    return y, {"k": k, "v": v}


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Store one position's ``new`` (B, 1, ...) at ``pos``, in place, in the
    cache's dtype."""
    cache[:, pos] = new[:, 0].to(cache.dtype)


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, shard: Optional[tp.SeqShard] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, d); cache k/v: (B, S_max, K, Dh), written
    at ``pos`` in place; attends to positions ``<= pos`` (and the sliding
    window).  Returns ``(y, cache)``.  On a mesh the cache holds this
    rank's block of positions (``shard``: which one) of all KV heads, or
    of the rank's KV heads where the model axis splits them, and the block
    runs split as in training (:func:`_sharded_decode`)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new, axis = _gqa_qkv(p, cfg, x, positions)
    if axis is not None or shard is not None:
        return _sharded_decode(p, cfg, x, cache, pos, shard, positions, q,
                               k_new, v_new, axis), cache
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


def _own_range(cache_len: int, shard: Optional[tp.SeqShard], lo: int,
               pos: int) -> Tuple[int, int, int]:
    """``(start, a, b)``: the first position of this rank's cache block and
    the allowed positions ``[a, b)`` of it (empty when ``a >= b``)."""
    start = shard.index * cache_len if shard is not None else 0
    return start, max(lo, start), min(pos + 1, start + cache_len)


def _write_own(cache: torch.Tensor, new: torch.Tensor, pos: int,
               start: int) -> None:
    """Store ``new`` at ``pos`` if this rank's block holds it."""
    if start <= pos < start + cache.shape[1]:
        _write(cache, new, pos - start)


def _partial_attend(logits: torch.Tensor, values: torch.Tensor,
                    spec: str, shard: Optional[tp.SeqShard]) -> torch.Tensor:
    """Attention from float32 ``logits`` (..., n) over this rank's ``n``
    allowed positions (n may be 0) and their ``values``: the rank's row
    maximum, sum of exponentials and weighted values, merged over the
    ranks that hold the other positions; ``spec`` the einsum of
    probabilities and values.  Float32."""
    if logits.shape[-1]:
        m = logits.amax(dim=-1)
    else:
        m = torch.full(logits.shape[:-1], NEG, device=logits.device)
    e = torch.exp(logits - m[..., None])
    o = torch.einsum(spec, e, values.float())
    return tp.merge_partial_attention(m, e.sum(dim=-1), o, shard)


def _sharded_decode(p, cfg, x, cache, pos, shard, positions, q, k_new, v_new,
                    axis):
    """GQA decode on a mesh: the cache's heads all or this rank's (the
    model axis on ``act_kv``), its positions all or a block
    (``act_kv_seq``); whole heads gather the query heads first and cut the
    rank's back out of the output for the row-parallel ``wo``."""
    B, H, D = x.shape[0], cfg.n_heads, cfg.head_dim
    whole = cache["k"].shape[2] == cfg.n_kv_heads
    if whole and axis is not None:
        q = tp.gather_from_model(q, 2, axis)
        k_new, v_new = _whole_kv(p, cfg, x, positions, k_new, v_new, axis)
    lo = max(pos - cfg.sliding_window + 1, 0) if cfg.sliding_window else 0
    start, a, b = _own_range(cache["k"].shape[1], shard, lo, pos)
    _write_own(cache["k"], k_new, pos, start)
    _write_own(cache["v"], v_new, pos, start)
    kc = cache["k"][:, max(a - start, 0):max(b - start, 0)].to(q.dtype)
    vc = cache["v"][:, max(a - start, 0):max(b - start, 0)].to(q.dtype)
    Hq, K = q.shape[2], kc.shape[2]
    qg = q.reshape(B, 1, K, Hq // K, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          kc.float()) / math.sqrt(D)
    out = _partial_attend(logits, vc, "bkgqs,bskd->bkgqd", shard)
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(B, 1, Hq, D)
    if whole and axis is not None:
        h0, h1 = axis.slice(H)
        out = out[:, :, h0:h1]
    return tp.reduce_from_model(dense_apply(p["wo"], out.reshape(B, 1, -1)),
                                axis)


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
    """``(q_nope, q_rope, c_kv, k_rope, axis)``: the rank's query heads,
    the latent and the shared rotary key (every rank computes them, their
    replicated weights through *f* on a split block)."""
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    axis = tp.split_by(p["wq"]["kernel"].shape[1], cfg.n_heads)
    x = tp.copy_to_model(x, axis)
    q = dense_apply(p["wq"], x)                              # (B,S,H,dn+dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = dense_apply({"kernel": tp.copy_to_model(p["wkv_a"]["kernel"], axis)},
                     x)                                      # (B,S,r+dr)
    c_kv = rms_norm({"scale": tp.copy_to_model(p["kv_norm"]["scale"], axis)},
                    kv[..., :r])
    k_rope = apply_rope(kv[:, :, None, r:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope, axis    # k_rope: (B,S,1,dr)


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
                spec: MaskSpec, axis=None) -> torch.Tensor:
    B, Sq = q_nope.shape[:2]
    if Sq <= DIRECT_ATTEND_MAX:
        out = _mla_block(p, cfg, q_nope, q_rope, c_kv, k_rope, 0, spec)
    else:
        out = _q_blocks(lambda qn, qr, q0: _mla_block(
            p, cfg, qn, qr, c_kv, k_rope, q0, spec), [q_nope, q_rope],
            min(cfg.attn_block_q, Sq))
    return tp.reduce_from_model(dense_apply(p["wo"], out.reshape(B, Sq, -1)),
                                axis)


def mla_apply(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
              spec: MaskSpec) -> torch.Tensor:
    return mla_prefill(p, cfg, x, positions, spec)[0]


def mla_prefill(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                spec: MaskSpec
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full-sequence forward and its latent cache ``{"c_kv": (B, S, r),
    "k_rope": (B, S, 1, dr)}`` (every rank's whole: the latent is not split
    by heads)."""
    q_nope, q_rope, c_kv, k_rope, axis = _mla_qkv(p, cfg, x, positions)
    y = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope, spec, axis)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, shard: Optional[tp.SeqShard] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode on the latent cache (written at ``pos`` in place),
    with the up-projection of K absorbed into the query.  On a mesh the
    cache holds this rank's block of positions (``shard``) and the heads
    run split: the latent queries of all heads are gathered, each rank
    attends its positions, the partial results are merged, and the rank's
    heads of the latent context go through its ``wv_b`` and ``wo``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_new, kr_new, axis = _mla_qkv(p, cfg, x, positions)
    start, a, b = _own_range(cache["c_kv"].shape[1], shard, 0, pos)
    _write_own(cache["c_kv"], c_new, pos, start)
    _write_own(cache["k_rope"], kr_new, pos, start)
    ckc = cache["c_kv"][:, max(a - start, 0):max(b - start, 0)].to(x.dtype)
    krc = cache["k_rope"][:, max(a - start, 0):max(b - start, 0)].to(x.dtype)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["wk_b"]["kernel"].to(q_nope.dtype))
    q_lat = tp.gather_from_model(q_lat, 2, axis)
    q_rope = tp.gather_from_model(q_rope, 2, axis)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckc.float())
              + torch.einsum("bqhd,bsod->bhqs", q_rope.float(), krc.float()))
    logits = logits / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    if axis is None and shard is None:
        probs = torch.softmax(logits, dim=-1).to(ckc.dtype)
        ctx = torch.einsum("bhqs,bsr->bqhr", probs, ckc)
    else:
        ctx = _partial_attend(logits, ckc, "bhqs,bsr->bhqr", shard
                              ).to(ckc.dtype).transpose(1, 2)
        if axis is not None:
            h0, h1 = axis.slice(cfg.n_heads)
            ctx = ctx[:, :, h0:h1]
    out = torch.einsum("bqhr,rhd->bqhd", ctx,
                       p["wv_b"]["kernel"].to(ctx.dtype))
    return tp.reduce_from_model(dense_apply(p["wo"], out.reshape(B, 1, -1)),
                                axis), cache
