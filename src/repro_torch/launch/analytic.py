"""Analytic roofline terms of one step on one device of a mesh: the port of
``repro.launch.analytic``, term for term, priced on a :class:`Hardware`.

- **compute**: per-stage analytic FLOPs (``models/flops.py``, 2·N·M·K math)
  × the *schedule's* per-stage execution counts (recompute included — this
  is where rotor's time-for-memory trade shows up), ÷ devices ÷
  ``hw.peak_bf16``.
- **memory**: per-device HBM traffic = activation stream (each forward op
  reads ``ω_a``/writes its output, each backward reads ``ā`` + writes δ and
  parameter gradients) + per-execution parameter reads (post-all-gather TP
  shard) + optimizer state read/write; decode adds the KV/SSM cache read;
  ÷ ``hw.hbm_bw``.
- **collective**: FSDP all-gathers (param shard × executions), gradient
  reduce-scatter + cross-pod reduction, MoE all-to-alls (dispatch buffer ×
  2 directions × executions), the TP activation all-reduce of decode;
  each over the link its axis crosses (``hw.link_bw``): the model axis on
  NVLink, the data and pod axes on the network.

Parameter and cache bytes come from ``StagedLM.init`` and ``init_cache`` on
``meta`` (the cache's step counter, an int32 scalar in the reference's
cache, adds 4 bytes).  A mesh is anything
:func:`..distributed.sharding.mesh_shape` reads: a ``DeviceMesh`` with
named dimensions or an object whose ``shape`` maps axis names to sizes;
``None`` is one device.  Given the reference's constants, with both links
at its ``ICI_BW``, every term equals the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from ..core.schedule import F_ALL, F_CK, F_NONE, Schedule
from ..distributed.sharding import DATA, MODEL, POD, mesh_shape
from ..models.flops import _layer_flops, param_count, stage_flops
from ..models.lm import POS_BYTES
from ..tree import tree_bytes
from .mesh import H100_SXM, Hardware


def _sizes(mesh: Any) -> Dict[str, int]:
    return mesh_shape(mesh) if mesh is not None else {}


def _n_devices(sizes: Dict[str, int]) -> int:
    return math.prod(sizes.values())


def _param_bytes(model) -> tuple:
    """(total bytes, bytes per stage) of the model's parameters."""
    params = model.init(device="meta")
    return (tree_bytes(params),
            [tree_bytes(s) for s in model.stage_params(params)])


def _cache_bytes(model, B: int, S: int) -> int:
    return tree_bytes(model.init_cache(B, S, device="meta")) + POS_BYTES


def _terms(compute_flops: float, traffic: float, coll_network: float,
           coll_nvlink: float, n_dev: int, hw: Hardware) -> Dict[str, float]:
    return {"compute_s": compute_flops / n_dev / hw.peak_bf16,
            "memory_s": traffic / hw.hbm_bw,
            "collective_s": (coll_network / hw.link_bw(DATA)
                             + coll_nvlink / hw.link_bw(MODEL)),
            "flops_per_device": compute_flops / n_dev,
            "hbm_bytes_per_device": traffic,
            "collective_bytes_per_device": coll_network + coll_nvlink}


def train_terms(cfg, shape, mesh, model, chain,
                schedule: Optional[Schedule],
                hw: Hardware = H100_SXM) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    sizes = _sizes(mesh)
    n_dev = _n_devices(sizes)
    dp = sizes.get(POD, 1) * sizes.get(DATA, 1)
    tp = sizes.get(MODEL, 1)
    if B % dp:
        dp = 1
    fwd_flops, _ = stage_flops(cfg, B, S)
    sched = schedule or Schedule.store_all(chain.length)
    fwd_counts: Dict[int, int] = {}
    for kind, l in sched.ops:
        if kind in (F_ALL, F_CK, F_NONE):
            fwd_counts[l] = fwd_counts.get(l, 0) + 1

    # --- compute ---------------------------------------------------------
    total_flops = 0.0
    inner = 1.0 if cfg.scan_layer_remat in ("full", "save_moe") else 0.0
    for l in range(1, chain.length + 2):
        c = fwd_counts.get(l, 1)
        total_flops += c * fwd_flops[l - 1]
        # backward = 2×fwd (+1×fwd replay if inner per-layer remat)
        total_flops += (2.0 + inner) * fwd_flops[l - 1]

    # --- memory traffic (per device) --------------------------------------
    p_total, stage_pbytes = _param_bytes(model)
    traffic = 0.0
    for kind, l in sched.ops:
        pb = stage_pbytes[l - 1] / tp  # post-all-gather TP-local weights
        if kind in (F_ALL, F_CK, F_NONE):
            out = chain.wabar[l - 1] if kind == F_ALL else (
                chain.wa[l] if l <= chain.length else 0.0)
            traffic += chain.wa[l - 1] + out + pb
        else:  # backward: read ā + δ + params, write δ + param grads
            traffic += (chain.wabar[l - 1] + 2 * chain.wdelta[l - 1]
                        + 2 * pb)
    # optimizer: p(read+write) bf16 + m,v f32 (read+write), grads read — all
    # fully sharded (ZeRO-3): 2·2 + 2·8 + 2 = 22 bytes/param ÷ n_dev
    traffic += 22.0 * (p_total / 2) / n_dev

    # --- collectives (per device) ------------------------------------------
    coll_dp = 0.0
    fsdp = dp
    for kind, l in sched.ops:
        shard = stage_pbytes[l - 1] / n_dev
        if fsdp > 1:
            coll_dp += shard * (fsdp - 1)  # all-gather the FSDP dim per use
    # gradient reduce-scatter (ring: ~shard×(dp-1) per device) + pod reduce
    coll_dp += (p_total / n_dev) * (fsdp - 1)
    # MoE all-to-alls over the model axis: dispatch+return, fwd / bwd /
    # inner-remat replay
    coll_tp = 0.0
    n_moe = sum(1 for k in cfg.layer_kinds if k == "moe")
    if n_moe and cfg.num_experts % tp == 0 and tp > 1:
        Tl = B * S // dp
        cap = -(-max(4, math.ceil(Tl * cfg.moe_top_k / cfg.num_experts
                                  * cfg.moe_capacity_factor)) // 8) * 8
        buf = cfg.num_experts * cap * cfg.d_model * 2  # bf16
        passes = 2 + 2 + (2 if cfg.scan_layer_remat == "full" else 0)
        coll_tp += n_moe * buf * passes * (tp - 1) / tp
    return _terms(total_flops, traffic, coll_dp, coll_tp, n_dev, hw)


def decode_terms(cfg, shape, mesh, model,
                 hw: Hardware = H100_SXM) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    sizes = _sizes(mesh)
    n_dev = _n_devices(sizes)
    dp = sizes.get(POD, 1) * sizes.get(DATA, 1)
    if B % dp:
        dp = 1
    tp = sizes.get(MODEL, 1)
    p_bytes, _ = _param_bytes(model)
    c_bytes = _cache_bytes(model, B, S)
    # flops: one token through active params + attention over the cache
    flops = 2.0 * param_count(cfg) * B
    for kind, start, length in cfg.chunks:
        if kind in ("dense", "moe"):
            flops += length * (_layer_flops(cfg, "dense", B, 1, kv_len=S)
                               - _layer_flops(cfg, "dense", B, 1, kv_len=1))
    # memory: read the resident param shard + the whole cache; the cache
    # write-back is only the new token's slice (written in place)
    traffic = p_bytes / n_dev + c_bytes / n_dev * (1.0 + 1.0 / max(S, 1))
    # collectives: per-layer activation all-reduce for TP (y partial sums)
    coll = cfg.num_layers * B / dp * cfg.d_model * 2 * 2 * (tp - 1) / tp
    return _terms(flops, traffic, 0.0, coll, n_dev, hw)


def prefill_terms(cfg, shape, mesh, model,
                  hw: Hardware = H100_SXM) -> Dict[str, float]:
    B, S = shape.global_batch, shape.seq_len
    sizes = _sizes(mesh)
    n_dev = _n_devices(sizes)
    fwd_flops, _ = stage_flops(cfg, B, S)
    flops = float(sum(fwd_flops))
    p_bytes, _ = _param_bytes(model)
    c_bytes = _cache_bytes(model, B, S)
    act = B * S * cfg.d_model * 2 * (2 * cfg.num_layers)  # stream in/out
    traffic = (p_bytes + act + c_bytes) / n_dev
    tp = sizes.get(MODEL, 1)
    coll = (p_bytes / n_dev) * (n_dev / tp - 1)  # FSDP gathers
    return _terms(flops, traffic, coll, 0.0, n_dev, hw)


def dominant(terms: Dict[str, float]) -> str:
    """``compute``, ``memory`` or ``collective``: the largest term."""
    three = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(three, key=three.get).replace("_s", "")


def cell_terms(cfg, shape, mesh, model, chain=None, schedule=None,
               hw: Hardware = H100_SXM) -> Dict[str, Any]:
    """The terms of ``shape``'s kind (a train cell needs ``chain``), with
    ``dominant`` added, as a dry-run record holds them."""
    if shape.kind == "train":
        out: Dict[str, Any] = train_terms(cfg, shape, mesh, model, chain,
                                          schedule, hw)
    elif shape.kind == "decode":
        out = decode_terms(cfg, shape, mesh, model, hw)
    else:
        out = prefill_terms(cfg, shape, mesh, model, hw)
    out["dominant"] = dominant(out)
    return out
