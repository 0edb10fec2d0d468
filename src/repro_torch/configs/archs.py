"""Architecture configs (the ported subset of ``repro.configs.archs``) and
the smoke-reduction helper."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..models.lm import ModelConfig

_COMMON = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
               scan_layer_remat="full", logits_chunk=4096)


def qwen15_4b(**ov) -> ModelConfig:
    # [dense] QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
    return ModelConfig(name="qwen1.5-4b", num_layers=40, d_model=2560,
                       n_heads=20, n_kv_heads=20, d_ff=6912,
                       vocab_size=151936, qkv_bias=True, mlp_kind="swiglu",
                       rope_theta=5e6, n_chunks=10, **{**_COMMON, **ov})


def mamba2_13b(**ov) -> ModelConfig:
    # [ssm] SSD (state-space duality) [arXiv:2405.21060; unverified]
    return ModelConfig(name="mamba2-1.3b", num_layers=48, d_model=2048,
                       n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
                       head_dim=64,
                       layer_kinds=("mamba",) * 48, ssm_state=128,
                       ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
                       ssm_conv=4, ssm_chunk=256, n_chunks=12,
                       **{**_COMMON, **ov})


ARCHS: Dict[str, Callable[..., ModelConfig]] = {
    "qwen1.5-4b": qwen15_4b,
    "mamba2-1.3b": mamba2_13b,
}


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    cfg = ARCHS[arch]()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides) -> ModelConfig:
    """Reduced same-family config: small widths/depths, tiny vocab — runs a
    real forward/train step on the CPU."""
    full = get_config(arch)
    kinds = full.layer_kinds
    if full.hybrid_period:
        depth, period = 4, 2
        kinds = ("zamba",) * depth
    else:
        depth, period = 4, 0
        kinds = tuple(kinds[:1]) + tuple(kinds[-1] for _ in range(depth - 1))
    n_kv = max(1, (full.n_kv_heads * 4) // max(full.n_heads, 1)) or 1
    red = dict(
        num_layers=depth, layer_kinds=kinds,
        d_model=64, n_heads=4, n_kv_heads=min(4, max(n_kv, 1)),
        head_dim=16, d_ff=128, vocab_size=256,
        num_experts=8 if full.num_experts else 0, moe_top_k=2, moe_d_ff=32,
        num_shared_experts=min(full.num_shared_experts, 1),
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8, ssm_expand=2,
        hybrid_period=period, prefix_len=4 if full.modality == "vlm" else 0,
        n_chunks=3, dtype=torch.float32, param_dtype=torch.float32,
        scan_layer_remat="none", logits_chunk=0,
    )
    red.update(overrides)
    return dataclasses.replace(full, **red)
