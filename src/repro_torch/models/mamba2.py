"""Mamba2 mixer (SSD — state-space duality, arXiv:2405.21060): the port of
``repro.models.mamba2``, its full-sequence forward (training and prefill,
which also returns the decode cache) and the O(1)-per-token recurrent
decode.  The chunked SSD runs on the within-chunk kernel
(:mod:`..kernels.ssd.ops`) when ``cfg.use_ssd_kernel`` is set, and
otherwise in plain PyTorch.

Numerics follow the JAX package: the depthwise causal conv is summed over K
shifted slices in the input dtype, ``dt = softplus(dt + dt_bias)`` and
``A = −exp(A_log)`` are float32, and ``A_log``, ``D`` and ``dt_bias`` are
float32 parameters whatever the parameter dtype.

Model-axis tensor parallelism (:mod:`..distributed.tensor_parallel`): a
mixer whose ``A_log`` holds this rank's share of the SSM heads runs split
by heads.  The fused ``in_proj`` is one kernel on the ``mlp`` axis whose
contiguous shard does not line up with ``z`` / ``xBC`` / ``dt``, so the
stage takes it whole (its gradient reduce-scattered over the model axis,
``sharding.gather``'s ``partial`` mode) and each rank computes only its
columns: its heads' ``z``, ``x`` and ``dt``, and ``B``, ``C`` whole (one
group does not divide).  K6 runs on the rank's heads.  The gated RMSNorm
normalises over the whole ``d_inner``: the gated input is gathered over
the model group, K4 runs on the whole row, and the rank keeps its columns
for the row-parallel ``out_proj`` (as GSPMD does around a custom call).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
from ..kernels.ssd import ops as ssd_ops
from ..kernels.ssd import ref as ssd_ref
from .common import dense_apply, dense_init, rms_norm

Params = Dict[str, Any]


def _dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, ssm heads H, groups G, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


def mamba2_init(gen: torch.Generator, cfg, dtype, device) -> Params:
    d = cfg.d_model
    d_inner, H, G, N = _dims(cfg)
    conv_dim = d_inner + 2 * G * N
    d_proj = 2 * d_inner + 2 * G * N + H     # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.empty((cfg.ssm_conv, conv_dim), **f32).normal_(
        generator=gen) * (1.0 / math.sqrt(cfg.ssm_conv))
    log_dt = torch.empty((H,), **f32).uniform_(math.log(1e-3), math.log(1e-1),
                                               generator=gen)
    return {
        "in_proj": dense_init(gen, d, d_proj, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "norm": {"scale": torch.ones((d_inner,), dtype=dtype, device=device)},
        "out_proj": dense_init(gen, d_inner, d, dtype, device,
                               scale=1.0 / math.sqrt(
                                   d_inner * max(cfg.num_layers, 1))),
    }



def mamba2_param_axes(cfg) -> Params:
    """Logical axes of :func:`mamba2_init`'s tree."""
    return {
        "in_proj": {"kernel": ("embed", "mlp")},
        "conv_w": ("conv", None),
        "conv_b": (None,),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": {"scale": ("mlp",)},
        "out_proj": {"kernel": ("mlp", "embed")},
    }

def _split_proj(cfg, proj: torch.Tensor):
    d_inner, H, G, N = _dims(cfg)
    z, xBC, dt = torch.split(proj, [d_inner, d_inner + 2 * G * N, H], dim=-1)
    return z, xBC, dt  # dt: (..., H)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xBC: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :].to(xBC.dtype)
              for i in range(K))
    return F.silu(out + b.to(xBC.dtype))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
    """SSD scan.  x: (B,S,H,P), dt: (B,S,H) (post-softplus), A: (H,) (<0),
    Bm/Cm: (B,S,G,N).  Returns (y: (B,S,H,P), final_state: (B,H,P,N))."""
    impl = ssd_ops.ssd_chunked if use_kernel else ssd_ref.ssd_chunked
    return impl(x, dt, A, Bm, Cm, chunk, init_state)


def mamba2_apply(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward (training)."""
    return mamba2_prefill(p, cfg, x, cache=False)[0]


def _split_index(cfg, axis: tp.ModelAxis, device):
    """The ``in_proj`` columns a split mixer computes (its heads' ``z`` and
    ``x``, ``B`` and ``C``, its heads' ``dt``) and the conv channels of its
    ``xBC`` (its ``x``, ``B`` and ``C``), as index tensors."""
    d_inner, H, G, N = _dims(cfg)
    if G != 1:
        raise NotImplementedError(f"a mixer split over the model axis takes "
                                  f"B and C whole: one group, not {G}")
    h0, h1 = axis.slice(H)
    c0, c1 = h0 * cfg.ssm_head_dim, h1 * cfg.ssm_head_dim

    def r(a, b):
        return torch.arange(a, b, device=device)

    cols = torch.cat([r(c0, c1), r(d_inner + c0, d_inner + c1),
                      r(2 * d_inner, 2 * d_inner + 2 * G * N),
                      r(2 * d_inner + 2 * G * N + h0,
                        2 * d_inner + 2 * G * N + h1)])
    channels = torch.cat([r(c0, c1), r(d_inner, d_inner + 2 * G * N)])
    return cols, channels


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor,
                axis: Optional[tp.ModelAxis]) -> torch.Tensor:
    """``rms_norm(y · silu(z))`` over the whole ``d_inner`` (K4): on a split
    mixer the rank's columns of the gated input are gathered over the model
    group, normalised whole with the gathered scale, and the rank's
    columns kept."""
    g = y * F.silu(z)
    if axis is None:
        return rms_norm(p["norm"], g)
    scale = tp.gather_from_model(p["norm"]["scale"], 0, axis)
    whole = rms_norm({"scale": scale}, tp.gather_from_model(g, g.ndim - 1,
                                                            axis))
    return tp.scatter_to_model(whole, g.ndim - 1, axis)


def mamba2_prefill(p: Params, cfg, x: torch.Tensor, cache: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward and the recurrent decode cache: ``conv`` the
    last K−1 *raw* xBC rows (zeros before the sequence), ``ssm`` the final
    SSD state (B, H, P, N) float32.  On a split mixer ``ssm`` holds the
    rank's heads and ``conv`` every channel (with ``cache``)."""
    B, S, d = x.shape
    d_inner, H, G, N = _dims(cfg)
    K = cfg.ssm_conv
    axis = tp.split_by(p["A_log"].shape[0], H)
    w, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
    if axis is not None:
        cols, channels = _split_index(cfg, axis, x.device)
        w = {"kernel": w["kernel"].index_select(1, cols)}
        conv_w = tp.copy_to_model(conv_w, axis).index_select(1, channels)
        conv_b = tp.copy_to_model(conv_b, axis).index_select(0, channels)
        d_inner, H = d_inner // axis.size, H // axis.size
    proj = dense_apply(w, tp.copy_to_model(x, axis))
    z, xBC_raw, dt = torch.split(proj, [d_inner, d_inner + 2 * G * N, H],
                                 dim=-1)
    conv_cache = None
    if axis is None:
        # a copy: a view would keep the whole projection alive
        conv_cache = F.pad(xBC_raw, (0, 0, max(K - 1 - S, 0), 0))[
            :, -(K - 1):].clone()
    elif cache:    # every channel of the last rows, from the whole weight
        whole = dense_apply(p["in_proj"], x[:, -(K - 1):])
        conv_cache = F.pad(_split_proj(cfg, whole)[1],
                           (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
    xBC = _causal_conv(xBC_raw, conv_w, conv_b)
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, cfg.ssm_head_dim)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk,
                                 use_kernel=cfg.use_ssd_kernel)
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = _gated_norm(p, y.reshape(B, S, d_inner), z, axis)
    out = tp.reduce_from_model(dense_apply(p["out_proj"], y), axis)
    return out, {"conv": conv_cache, "ssm": final_state}


def mamba2_init_cache(cfg, batch: int, dtype, device
                      ) -> Dict[str, torch.Tensor]:
    d_inner, H, G, N = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * G * N),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                               dtype=torch.float32, device=device)}


def mamba2_decode(p: Params, cfg, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step, x: (B, 1, d); the cache is updated in
    place and returned.  On a split mixer the cache holds the rank's SSM
    heads and its contiguous block of conv channels (``act_mlp``): each
    rank computes the whole projection and conv of the one token (the
    conv window gathered over the model group), its heads' state update,
    and the gated norm and ``out_proj`` as the forward does."""
    B = x.shape[0]
    d_inner, H, G, N = _dims(cfg)
    axis = tp.split_by(p["A_log"].shape[0], H)
    proj = dense_apply(p["in_proj"], x)[:, 0]            # (B, d_proj)
    z, xBC, dt = _split_proj(cfg, proj)
    conv = cache["conv"]
    held = tp.model_slice(xBC.shape[-1]) if conv.shape[-1] < xBC.shape[-1] \
        else None
    if held is not None:
        conv = tp.gather_from_model(conv, 2, axis or tp.model_axis())
    win = torch.cat([conv, xBC[:, None, :]], dim=1)   # (B, K, C)
    # summed over the K taps in the input dtype, as _causal_conv sums them
    # (the JAX package contracts the window in one einsum, which rounds
    # once: in bf16 the prefill and decode convs would differ)
    xBC = F.silu(sum(win[:, i] * p["conv_w"][i].to(xBC.dtype)
                     for i in range(win.shape[1]))
                 + p["conv_b"].to(xBC.dtype))
    cache["conv"].copy_(win[:, 1:] if held is None
                        else win[:, 1:, held[0]:held[1]])
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, cfg.ssm_head_dim)
    if axis is not None:
        h0, h1 = axis.slice(H)
        xs, dt, z = (xs[:, h0:h1], dt[:, h0:h1],
                     z[:, h0 * cfg.ssm_head_dim:h1 * cfg.ssm_head_dim])
        H, d_inner = h1 - h0, (h1 - h0) * cfg.ssm_head_dim
    Bm = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)  # (B, H, N)
    Cm = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"][None])           # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"])[None])
    st = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs.float(), Bm.float())
    cache["ssm"].copy_(st)
    y = torch.einsum("bhpn,bhn->bhp", st, Cm.float()).to(x.dtype)
    y = y + xs * p["D"][None, :, None].to(y.dtype)
    y = _gated_norm(p, y.reshape(B, d_inner), z, axis)
    out = tp.reduce_from_model(dense_apply(p["out_proj"], y), axis)
    return out[:, None, :], cache
