"""Analytic per-stage FLOP counts (``repro.models.flops``' stage and layer
counts: dense and MoE layers on GQA or MLA attention, Mamba2 and Zamba2
layers, the Zamba2 shared block, a VLM's head on its text positions) —
the rotor planner's ``u_f``/``u_b`` without running anything, and the
per-layer counts the KV-residency planner prices a decode step with.

Counting convention: multiply-add = 2 FLOPs; attention scores/values counted
at full (non-causal) cost.  Backward ≈ 2× forward, +1× when the per-layer
remat replays the forward; loss stage backward = 2× its forward.
"""

from __future__ import annotations

from typing import List, Tuple


def _attn_flops(cfg, B: int, S: int, kv_len: int | None = None) -> float:
    kv = kv_len if kv_len is not None else S
    if cfg.attention_kind == "mla":
        d, H = cfg.d_model, cfg.n_heads
        dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
        proj = 2 * B * S * d * (H * (dn + dr) + r + dr + H * dv)
        absorb = 2 * B * S * H * dn * r + 2 * B * S * H * r * dv
        attn = 2 * B * S * kv * H * (r + dr) + 2 * B * S * kv * H * r
        return proj + absorb + attn
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * B * S * d * (H * Dh + 2 * K * Dh) + 2 * B * S * H * Dh * d
    attn = 2 * B * S * kv * H * Dh * 2
    return proj + attn


def _mlp_flops(cfg, B: int, S: int, d_ff: int) -> float:
    mult = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return 2 * B * S * cfg.d_model * d_ff * mult


def _moe_flops(cfg, B: int, S: int) -> float:
    T = B * S
    router = 2 * T * cfg.d_model * cfg.num_experts
    routed = 2 * (T * cfg.moe_top_k * cfg.moe_capacity_factor) * 3 \
        * cfg.d_model * cfg.moe_d_ff
    shared = 2 * T * 3 * cfg.d_model * (cfg.moe_d_ff * cfg.num_shared_experts)
    return router + routed + shared


def _mamba_flops(cfg, B: int, S: int) -> float:
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    G, N = cfg.ssm_groups, cfg.ssm_state
    H = d_inner // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    proj = 2 * B * S * d * (2 * d_inner + 2 * G * N + H) + 2 * B * S * d_inner * d
    conv = 2 * B * S * (d_inner + 2 * G * N) * cfg.ssm_conv
    # SSD: scores (Q×N)@(N×Q), y (Q×Q)@(Q×P), states (P×Q)@(Q×N), y_off (Q×N)@(N×P)
    nc = max(S // Q, 1)
    ssd = B * H * nc * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * P * N * 2)
    return proj + conv + ssd


def _layer_flops(cfg, kind: str, B: int, S: int, kv_len=None) -> float:
    if kind == "dense":
        return _attn_flops(cfg, B, S, kv_len) + _mlp_flops(cfg, B, S, cfg.d_ff)
    if kind == "moe":
        return _attn_flops(cfg, B, S, kv_len) + _moe_flops(cfg, B, S)
    return _mamba_flops(cfg, B, S)


def per_layer_flops(cfg, B: int, S: int, kv_len: int | None = None
                    ) -> List[float]:
    """Forward FLOPs per *model layer* (length ``cfg.num_layers``).

    The Zamba2 shared block is attributed to the period-start layers that
    invoke it.  ``kv_len`` prices attention against a KV prefix longer than
    ``S`` (a decode step: ``S=1``, ``kv_len=`` the cache position)."""
    out = [0.0] * cfg.num_layers
    for kind, start, length in cfg.chunks:
        per = _layer_flops(cfg, kind, B, S, kv_len)
        for j in range(start, start + length):
            out[j] += per
        if (cfg.hybrid_period and kind == "zamba"
                and start % cfg.hybrid_period == 0):
            out[start] += (_attn_flops(cfg, B, S, kv_len)
                           + _mlp_flops(cfg, B, S, cfg.d_ff))
    return out


def stage_flops(cfg, B: int, S: int) -> Tuple[List[float], List[float]]:
    """(fwd, bwd) FLOPs per rotor stage: [embed] + chunks + [head+loss]; a
    Zamba2 chunk that starts a period adds its shared block.  ``S`` counts
    every position, a VLM's image prefix included."""
    fwd: List[float] = [2 * B * S * cfg.d_model]  # lookup/scale — negligible
    for kind, start, length in cfg.chunks:
        f = length * _layer_flops(cfg, kind, B, S)
        if (cfg.hybrid_period and kind == "zamba"
                and start % cfg.hybrid_period == 0):
            f += _attn_flops(cfg, B, S) + _mlp_flops(cfg, B, S, cfg.d_ff)
        fwd.append(f)
    # a VLM's head runs on the text positions only
    S_eff = S - cfg.prefix_len if cfg.modality == "vlm" else S
    fwd.append(2 * B * S_eff * cfg.d_model * cfg.vocab_size)
    # backward ≈ 2× fwd; +1× when inner per-layer remat replays the forward
    inner = 1.0 if cfg.scan_layer_remat == "full" else 0.0
    bwd = [(2.0 + inner) * f for f in fwd[:-1]] + [2.0 * fwd[-1]]
    return fwd, bwd


# ---------------------------------------------------------------------------
# parameter counts and model FLOPs (the 6·N·D of a utilisation figure)
# ---------------------------------------------------------------------------

def _attn_params(cfg) -> int:
    if cfg.attention_kind == "mla":
        d, H = cfg.d_model, cfg.n_heads
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return (d * H * qd + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                + cfg.kv_lora_rank * H * (cfg.qk_nope_head_dim
                                          + cfg.v_head_dim)
                + H * cfg.v_head_dim * d)
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return d * H * Dh + 2 * d * K * Dh + H * Dh * d


def _mlp_params(cfg, d_ff: int) -> int:
    mult = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _mamba_params(cfg) -> int:
    d_inner = cfg.ssm_expand * cfg.d_model
    gn = cfg.ssm_groups * cfg.ssm_state
    d_proj = 2 * d_inner + 2 * gn + d_inner // cfg.ssm_head_dim
    return cfg.d_model * d_proj + d_inner * cfg.d_model


def param_count(cfg, active_only: bool = True) -> int:
    """The matrices' parameters (norms, biases and SSM vectors left out):
    embedding and head, each layer's, the Zamba2 shared block once; with
    ``active_only`` a MoE layer counts its top-k routed experts, not all of
    them — ``repro``'s ``ModelConfig.active_params`` / ``total_params``."""
    total = 2 * cfg.vocab_size * cfg.d_model  # embed + head
    for kind in cfg.layer_kinds:
        if kind == "dense":
            total += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
        elif kind == "moe":
            ek = cfg.moe_top_k if active_only else cfg.num_experts
            total += _attn_params(cfg)
            total += ek * 3 * cfg.d_model * cfg.moe_d_ff
            total += cfg.num_shared_experts * 3 * cfg.d_model * cfg.moe_d_ff
        elif kind in ("mamba", "zamba"):
            total += _mamba_params(cfg)
    if cfg.hybrid_period and "zamba" in cfg.layer_kinds:
        # stored once, applied every period: counted once
        total += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    return total


def model_flops_per_step(cfg, B: int, S: int, train: bool = True) -> float:
    """MODEL_FLOPS = 6·N_active·D in training (2ND forward + 4ND backward),
    2·N_active·D otherwise; D = ``B·S`` tokens."""
    return (6.0 if train else 2.0) * param_count(cfg) * (B * S)
