"""Qwen1.5 (the Qwen2 architecture of ``transformers``) in plain float32
PyTorch: token embedding, pre-norm layers of causal multi-head attention
with biased q, k and v projections and rotary positions (the two halves of
each head rotated against each other), a SwiGLU MLP, the final RMSNorm and
an untied head under a mean cross-entropy."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import dense, layer_at, rms_norm, token_loss

BIAS_STD = 0.02


def _heads(conf):
    d, H = conf["d_model"], conf["n_heads"]
    return d, H, conf["n_kv_heads"], conf.get("head_dim") or d // H


def weight_spec(conf):
    """The weights' nest, shapes, stored dtypes and initialisation."""
    d, H, K, Dh = _heads(conf)
    Ff, V, L = conf["d_ff"], conf["vocab_size"], conf["num_layers"]
    n = conf["layers_per_stage"]
    bf = getattr(torch, conf["dtype"])

    def w(*shape, std):
        return ((n,) + shape, bf, ("normal", std))

    def proj(heads):
        return {"kernel": w(d, heads, Dh, std=d ** -0.5),
                "bias": w(heads, Dh, std=BIAS_STD)}

    def stage():
        return {"ln1": {"scale": ((n, d), bf, ("ones",))},
                "attn": {"wq": proj(H), "wk": proj(K), "wv": proj(K),
                         "wo": {"kernel": w(H * Dh, d,
                                            std=(H * Dh * L) ** -0.5)}},
                "ln2": {"scale": ((n, d), bf, ("ones",))},
                "mlp": {"wi_gate": {"kernel": w(d, Ff, std=d ** -0.5)},
                        "wi_up": {"kernel": w(d, Ff, std=d ** -0.5)},
                        "wo": {"kernel": w(Ff, d, std=(Ff * L) ** -0.5)}}}

    return {"embed": {"table": ((V, d), bf, ("normal", 1.0))},
            "chunks": [stage() for _ in range(L // n)],
            "final_norm": {"scale": ((d,), bf, ("ones",))},
            "head": {"kernel": ((d, V), bf, ("normal", d ** -0.5))}}


def rope(x, theta):
    """Rotary positions on x (B, S, H, D): frequencies theta^(-2i/D), the
    first half of each head rotated against the second."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm):
    """Causal attention: q (B, S, H, D), k and v (B, S, K, D)."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return mm(probs, v).transpose(1, 2).reshape(B, S, H * D)


def _layer(h, p, conf, mm):
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    a = rms_norm(h, p["ln1"]["scale"], eps)
    at = p["attn"]
    q, k, v = (dense(mm, a, at[n]["kernel"]) + at[n]["bias"]
               for n in ("wq", "wk", "wv"))
    h = h + dense(mm, attention(rope(q, theta), rope(k, theta), v, mm),
                  at["wo"]["kernel"])
    m = rms_norm(h, p["ln2"]["scale"], eps)
    ml = p["mlp"]
    g = F.silu(dense(mm, m, ml["wi_gate"]["kernel"])) \
        * dense(mm, m, ml["wi_up"]["kernel"])
    return h + dense(mm, g, ml["wo"]["kernel"])


def loss(tree, batch, conf, mm):
    h = tree["embed"]["table"][batch["tokens"].long()]
    for stage in tree["chunks"]:
        for j in range(conf["layers_per_stage"]):
            h = checkpoint(_layer, h, layer_at(stage, j), conf, mm,
                           use_reentrant=False)
    return token_loss(mm, h, tree["final_norm"]["scale"],
                      tree["head"]["kernel"], batch["labels"],
                      conf["rms_norm_eps"])
