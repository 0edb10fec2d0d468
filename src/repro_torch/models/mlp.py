"""Feed-forward variants: SwiGLU, GeGLU, the plain GELU MLP, and the
capacity-based top-k MoE (shared + routed experts, DeepSeek-V2/Moonlight
style): the local path, and the expert-parallel one (:func:`moe_apply_ep`,
``dist.all_to_all_single`` over the model axis' process group), which
:func:`moe_apply` takes under a mesh whose model axis divides the experts,
as ``repro.models.mlp.moe_apply`` does."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.rematerialize import kept
from ..distributed import tensor_parallel as tp
from ..distributed.sharding import all_reduce, all_to_all
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



def mlp_param_axes(kind: str = "swiglu") -> Params:
    """Logical axes of :func:`mlp_init`'s tree."""
    if kind in ("swiglu", "geglu"):
        return {"wi_gate": {"kernel": ("embed", "mlp")},
                "wi_up": {"kernel": ("embed", "mlp")},
                "wo": {"kernel": ("mlp", "embed")}}
    return {"wi": {"kernel": ("embed", "mlp")},
            "wo": {"kernel": ("mlp", "embed")}}

def mlp_apply(p: Params, x: torch.Tensor, kind: str = "swiglu",
              d_ff: Optional[int] = None) -> torch.Tensor:
    """The feed-forward of ``x``.  Where the weights hold this rank's share
    of ``d_ff`` hidden columns (model-axis tensor parallelism), the block
    runs split: *f*, the column-parallel ``wi_*``, the row-parallel ``wo``
    and *g*."""
    wi = p["wi_gate" if kind in ("swiglu", "geglu") else "wi"]["kernel"]
    axis = tp.split_by(wi.shape[1], d_ff if d_ff is not None
                       else wi.shape[1])
    x = tp.copy_to_model(x, axis)
    if kind == "swiglu":
        h = F.silu(dense_apply(p["wi_gate"], x)) * dense_apply(p["wi_up"], x)
    elif kind == "geglu":
        h = (F.gelu(dense_apply(p["wi_gate"], x), approximate="tanh")
             * dense_apply(p["wi_up"], x))
    else:
        h = F.gelu(dense_apply(p["wi"], x), approximate="tanh")
    return tp.reduce_from_model(dense_apply(p["wo"], h), axis)


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



def moe_param_axes(cfg) -> Params:
    """Logical axes of :func:`moe_init`'s tree: the router replicated
    (tiny), the expert stacks sharded on the expert (EP) axis only — the
    expert-parallel path takes them as each rank's ``(E/M, d, f)`` block."""
    p: Params = {
        "router": {"kernel": (None, None)},
        "we_gate": {"kernel": ("experts", None, None)},
        "we_up": {"kernel": ("experts", None, None)},
        "we_down": {"kernel": ("experts", None, None)},
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_param_axes("swiglu")
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


def _dispatch(p: Params, cfg, xt: torch.Tensor):
    """Route the tokens ``xt`` (T, d) and lay the kept (token, expert) pairs
    out by expert: ``(probs, gate_vals, eidx, slot, keep, buf (E·cap, d))``.
    Each token's top-k pairs queue in token-major order; a pair whose queue
    position reaches the capacity is dropped (its slot is the overflow row
    ``E·cap``, cut off ``buf``)."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    probs, gate_vals, expert_idx = _route(p, cfg, xt)
    cap = moe_capacity(cfg, T)
    eidx = expert_idx.reshape(T * k)
    # the position of each (token, choice) in its expert's queue: a running
    # count along the token-major order, laid out (E, T·k) so that the scan
    # runs along the inner axis (along the outer axis of a (T·k, E) one-hot
    # it took 13 ms a call on an H100 at T·k = 49152, E = 64)
    onehot = (torch.arange(E, device=xt.device)[:, None]
              == eidx[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1).gather(0, eidx[None])[0] - 1
    keep = pos < cap
    slot = torch.where(keep, eidx * cap + pos, E * cap)    # overflow row
    token_idx = torch.arange(T, device=xt.device).repeat_interleave(k)
    buf = xt.new_zeros((E * cap + 1, d)).index_put((slot,), xt[token_idx])
    return probs, gate_vals, eidx, slot, keep, buf[:E * cap]


def _experts(xs: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The SwiGLU experts on their rows: xs (E, rows, d) → (E, rows, d)."""
    dt = xs.dtype
    h = torch.matmul(xs, wg.to(dt))
    u = torch.matmul(xs, wu.to(dt))
    return torch.matmul(F.silu(h) * u, wd.to(dt))


def _combine(rows: torch.Tensor, slot, keep, gate_vals, k: int
             ) -> torch.Tensor:
    """Each pair's expert output, read back from ``rows`` (E·cap, d) (0 for
    a dropped pair) and summed over a token's pairs by gate: (T, d)."""
    d = rows.shape[1]
    picked = rows[torch.clamp(slot, max=rows.shape[0] - 1)]
    picked = torch.where(keep[:, None], picked, 0.0)
    return (picked.reshape(-1, k, d)
            * gate_vals[..., None].to(rows.dtype)).sum(dim=1)


def _aux(cfg, probs: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """Switch's load-balancing term, ``aux_coef · E · Σ_e mean_prob_e ·
    frac_e``."""
    E, n = cfg.num_experts, eidx.shape[0]
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=probs.device
                     ).index_add_(0, eidx, torch.full(
                         (n,), 1.0 / n, device=probs.device))
    return cfg.moe_aux_loss * E * torch.sum(me * ce)


def is_routed_expert(path: str) -> bool:
    """Whether a stage-parameter path (``chunk/moe/we_up/kernel``) names a
    routed expert stack: under expert parallelism each rank keeps its own
    experts and never gathers them."""
    return path.endswith(("moe/we_gate/kernel", "moe/we_up/kernel",
                          "moe/we_down/kernel"))


def ep_width(cfg, mesh: Any) -> int:
    """The model axis' size when :func:`moe_apply` takes the
    expert-parallel path under ``mesh`` (it has more than one member and
    divides the experts), else 1."""
    if mesh is None or not cfg.num_experts:
        return 1
    from ..distributed.sharding import mesh_shape

    m = mesh_shape(mesh).get("model", 1)
    return m if m > 1 and cfg.num_experts % m == 0 else 1


def moe_apply(p: Params, cfg, x: torch.Tensor):
    """``(y, aux_loss)`` for x (B, S, d): the kept (token, expert) pairs
    (:func:`_dispatch`) run through their expert as one batched product
    over ``(E, cap, d)`` and come back weighted by their gate; the aux loss
    is Switch's load-balancing term.  Under an active mesh
    (:func:`..distributed.sharding.axis_rules`) whose model axis divides the
    experts, the expert-parallel path (:func:`moe_apply_ep`) runs instead."""
    from ..distributed.sharding import (batch_mesh_dims, current_mesh,
                                        mesh_group)

    mesh = current_mesh()
    if ep_width(cfg, mesh) > 1:
        return moe_apply_ep(p, cfg, x, mesh.get_group("model"),
                            mesh_group(mesh, batch_mesh_dims(mesh)))
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    xt = x.reshape(B * S, d)
    probs, gate_vals, eidx, slot, keep, buf = _dispatch(p, cfg, xt)
    ys = _experts(buf.reshape(E, -1, d), p["we_gate"]["kernel"],
                  p["we_up"]["kernel"], p["we_down"]["kernel"])
    y = _combine(ys.reshape(-1, d), slot, keep, gate_vals, k)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt, "swiglu",
                          cfg.moe_d_ff * cfg.num_shared_experts)
    return y.reshape(B, S, d), _aux(cfg, probs, eidx)


# -- expert parallelism ----------------------------------------------------------

#: exchanges of the expert-parallel path: ``forward`` (dispatch and return,
#: two per MoE layer per forward) and ``backward`` (their reverse exchanges)
ALL_TO_ALL: Dict[str, int] = {"forward": 0, "backward": 0}


class _AllToAll(torch.autograd.Function):
    """:func:`..distributed.sharding.all_to_all`, whose backward is the
    reverse exchange (the same operation).  Its output is kept by a
    ``remat(..., keep=True)`` region (``scan_layer_remat="save_moe"``), so
    that region's recompute does not exchange again."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group

        def exchange():
            ALL_TO_ALL["forward"] += 1
            return all_to_all(x, group)

        return kept(exchange)

    @staticmethod
    def backward(ctx, grad):
        ALL_TO_ALL["backward"] += 1
        return all_to_all(grad, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class _MeanValue(torch.autograd.Function):
    """The value of the group's mean, the gradient of the member's own
    term: each member backpropagates its share, as the data-parallel loss
    does."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().clone(), group) / dist.get_world_size(
            group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def moe_apply_ep(p: Params, cfg, x: torch.Tensor, group,
                 dp_group: Optional[Any] = None):
    """Expert parallelism over ``group`` (the model axis, M members, each
    holding ``E/M`` experts; the members share their tokens, as the model
    axis replicates the batch): local capacity dispatch of the member's
    tokens, an exchange of ``(M, E/M·cap, d)`` row blocks so that each
    member gets every member's rows for its own experts, the expert
    products on the member's ``E/M`` experts (never gathered), the reverse
    exchange and the local combine — ``repro.models.mlp.moe_apply_ep``'s
    schedule on ``all_to_all_single``.  The expert kernels are the member's
    ``(E/M, ...)`` blocks.
    Every member sends the same rows, so each expert sees them M times in
    the backward: its weights' gradient is scaled by 1/M.  The aux loss is
    this member's, valued at its mean over ``dp_group`` (the batch-sharded
    ranks; ``None``: no other)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    M = dist.get_world_size(group)
    e_loc = E // M
    if p["we_up"]["kernel"].shape[0] != e_loc:
        raise ValueError(f"expert parallelism over {M} members takes each "
                         f"member's {e_loc} experts, not "
                         f"{p['we_up']['kernel'].shape[0]}")
    xt = x.reshape(B * S, d)
    probs, gate_vals, eidx, slot, keep, buf = _dispatch(p, cfg, xt)
    cap = buf.shape[0] // E
    recv = _AllToAll.apply(buf.reshape(M, e_loc * cap, d), group)
    xs = recv.reshape(M, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, M * cap, d)
    ys = _experts(xs, *(_ScaleGrad.apply(p[name]["kernel"], 1.0 / M)
                        for name in ("we_gate", "we_up", "we_down")))
    back = ys.reshape(e_loc, M, cap, d).transpose(0, 1).reshape(
        M, e_loc * cap, d)
    rows = _AllToAll.apply(back, group).reshape(E * cap, d)
    y = _combine(rows, slot, keep, gate_vals, k)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xt, "swiglu",
                          cfg.moe_d_ff * cfg.num_shared_experts)
    aux = _aux(cfg, probs, eidx)
    if dp_group is not None:
        aux = _MeanValue.apply(aux, dp_group)
    return y.reshape(B, S, d), aux
