"""Feed-forward variants: SwiGLU, GeGLU, the plain GELU MLP, and the
capacity-based top-k MoE (shared + routed experts, DeepSeek-V2/Moonlight
style) on one device — the local path of ``repro.models.mlp.moe_apply``.
The expert-parallel path (``moe_apply_ep``) belongs to multi-device work and
is not ported."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import dense_apply, dense_init, truncated_normal_init

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


# -- mixture of experts ---------------------------------------------------------

def moe_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    """Router (float32 whatever ``dtype``), the stacked routed experts
    ``(E, d, e_ff)`` / ``(E, e_ff, d)`` and, with shared experts, one SwiGLU
    of width ``e_ff · num_shared_experts``."""
    d, e_ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(e_ff * max(cfg.num_layers, 1))
    p: Params = {
        "router": dense_init(gen, d, E, torch.float32, device),
        "we_gate": {"kernel": truncated_normal_init(
            gen, (E, d, e_ff), dtype, scale_in, device)},
        "we_up": {"kernel": truncated_normal_init(
            gen, (E, d, e_ff), dtype, scale_in, device)},
        "we_down": {"kernel": truncated_normal_init(
            gen, (E, e_ff, d), dtype, scale_out, device)},
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, d, e_ff * cfg.num_shared_experts, dtype,
                               device, "swiglu", cfg.num_layers)
    return p


def _route(p: Params, cfg, xt: torch.Tensor):
    """Top-k routing in float32: ``(probs (T, E), gate_vals (T, k),
    expert_idx (T, k))``."""
    logits = dense_apply(p["router"], xt.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    if cfg.moe_norm_topk:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def moe_capacity(cfg, tokens: int) -> int:
    """Rows per expert: ``ceil(T·k / E · capacity_factor)``, at least 4,
    rounded up to a multiple of 8."""
    cap = max(4, int(math.ceil(tokens * cfg.moe_top_k / cfg.num_experts
                               * cfg.moe_capacity_factor)))
    return -(-cap // 8) * 8


def moe_apply(p: Params, cfg, x: torch.Tensor):
    """``(y, aux_loss)`` for x (B, S, d): each token's top-k (token, expert)
    pairs queue in token-major order; a pair whose queue position reaches
    the capacity is dropped (its slot is the overflow row ``E·cap``), the
    kept ones run through their expert as one batched product over
    ``(E, cap, d)``, and come back weighted by their gate.  The aux loss is
    Switch's load-balancing term, ``aux_coef · E · Σ_e mean_prob_e ·
    frac_e``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    cap = moe_capacity(cfg, T)

    eidx = expert_idx.reshape(T * k)
    # the position of each (token, choice) in its expert's queue: a running
    # count along the token-major order, laid out (E, T·k) so that the scan
    # runs along the inner axis (along the outer axis of a (T·k, E) one-hot
    # it took 13 ms a call on an H100 at T·k = 49152, E = 64)
    onehot = (torch.arange(E, device=x.device)[:, None]
              == eidx[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1).gather(0, eidx[None])[0] - 1
    keep = pos < cap
    slot = torch.where(keep, eidx * cap + pos, E * cap)    # overflow row
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((E * cap + 1, d)).index_put((slot,), xt[token_idx])
    xs = buf[:E * cap].reshape(E, cap, d)
    h = torch.matmul(xs, p["we_gate"]["kernel"].to(x.dtype))
    u = torch.matmul(xs, p["we_up"]["kernel"].to(x.dtype))
    ys = torch.matmul(F.silu(h) * u, p["we_down"]["kernel"].to(x.dtype))

    picked = ys.reshape(E * cap, d)[torch.clamp(slot, max=E * cap - 1)]
    picked = torch.where(keep[:, None], picked, 0.0)
    y = (picked.reshape(T, k, d)
         * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt, "swiglu")

    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, eidx, torch.full((T * k,), 1.0 / (T * k), device=x.device))
    aux = cfg.moe_aux_loss * E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux
