"""Architecture configs — the ten of ``repro.configs.archs``: the dense
four, the audio decoder (MusicGen) and the VLM (PaliGemma), the two MoE
(one on MLA), Mamba2 and the Zamba2 hybrid — and the smoke-reduction
helper."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..models.lm import ModelConfig

_COMMON = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
               scan_layer_remat="full", logits_chunk=4096)


def codeqwen15_7b(**ov) -> ModelConfig:
    # [dense] qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf] — QKV bias, SwiGLU
    return ModelConfig(name="codeqwen1.5-7b", num_layers=32, d_model=4096,
                       n_heads=32, n_kv_heads=32, d_ff=13440,
                       vocab_size=92416, qkv_bias=True, mlp_kind="swiglu",
                       rope_theta=1e6, n_chunks=8, **{**_COMMON, **ov})


def qwen15_4b(**ov) -> ModelConfig:
    # [dense] QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
    return ModelConfig(name="qwen1.5-4b", num_layers=40, d_model=2560,
                       n_heads=20, n_kv_heads=20, d_ff=6912,
                       vocab_size=151936, qkv_bias=True, mlp_kind="swiglu",
                       rope_theta=5e6, n_chunks=10, **{**_COMMON, **ov})


def starcoder2_7b(**ov) -> ModelConfig:
    # [dense] GQA, RoPE [arXiv:2402.19173; hf] — GELU MLP, biases
    return ModelConfig(name="starcoder2-7b", num_layers=32, d_model=4608,
                       n_heads=36, n_kv_heads=4, d_ff=18432,
                       vocab_size=49152, qkv_bias=True, mlp_kind="gelu",
                       rope_theta=1e5, n_chunks=8, **{**_COMMON, **ov})


def qwen15_110b(**ov) -> ModelConfig:
    # [dense] QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
    return ModelConfig(name="qwen1.5-110b", num_layers=80, d_model=8192,
                       n_heads=64, n_kv_heads=8, d_ff=49152,
                       vocab_size=152064, qkv_bias=True, mlp_kind="swiglu",
                       rope_theta=1e6, n_chunks=10, **{**_COMMON, **ov})


def musicgen_medium(**ov) -> ModelConfig:
    # [audio] decoder-only over EnCodec tokens [arXiv:2306.05284; hf]
    # frontend (EnCodec) is a stub: the batch carries frame embeddings.
    return ModelConfig(name="musicgen-medium", num_layers=48, d_model=1536,
                       n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
                       use_rope=False, mlp_kind="gelu",
                       modality="audio_embed", n_chunks=8,
                       **{**_COMMON, **ov})


def paligemma_3b(**ov) -> ModelConfig:
    # [vlm] SigLIP + gemma [arXiv:2407.07726; hf] — MQA, GeGLU, 256-patch
    # bidirectional prefix; SigLIP frontend is a stub (patch embeddings in).
    return ModelConfig(name="paligemma-3b", num_layers=18, d_model=2048,
                       n_heads=8, n_kv_heads=1, d_ff=16384,
                       vocab_size=257216, head_dim=256, mlp_kind="geglu",
                       modality="vlm", prefix_len=256, embed_scale=True,
                       rope_theta=10000.0, n_chunks=6, **{**_COMMON, **ov})


def moonshot_16b_a3b(**ov) -> ModelConfig:
    # [moe] kimi/moonlight 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]
    # assignment sheet pins GQA kv=16 (not MLA) — we follow the sheet.
    return ModelConfig(name="moonshot-v1-16b-a3b", num_layers=48,
                       d_model=2048, n_heads=16, n_kv_heads=16,
                       d_ff=11264,  # first (dense) layer FFN
                       vocab_size=163840,
                       layer_kinds=("dense",) + ("moe",) * 47,
                       num_experts=64, moe_top_k=6, moe_d_ff=1408,
                       num_shared_experts=2, n_chunks=12,
                       **{**_COMMON, **ov})


def deepseek_v2_lite(**ov) -> ModelConfig:
    # [moe] MLA kv_lora=512, 64 routed experts top-6 + 2 shared
    # [arXiv:2405.04434; hf] (160 routed experts is the full V2)
    return ModelConfig(name="deepseek-v2-lite-16b", num_layers=27,
                       d_model=2048, n_heads=16, n_kv_heads=16,
                       d_ff=10944,  # first (dense) layer FFN
                       vocab_size=102400, attention_kind="mla",
                       kv_lora_rank=512, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128,
                       layer_kinds=("dense",) + ("moe",) * 26,
                       num_experts=64, moe_top_k=6, moe_d_ff=1408,
                       num_shared_experts=2, n_chunks=10,
                       **{**_COMMON, **ov})


def mamba2_13b(**ov) -> ModelConfig:
    # [ssm] SSD (state-space duality) [arXiv:2405.21060; unverified]
    return ModelConfig(name="mamba2-1.3b", num_layers=48, d_model=2048,
                       n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
                       head_dim=64,
                       layer_kinds=("mamba",) * 48, ssm_state=128,
                       ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
                       ssm_conv=4, ssm_chunk=256, n_chunks=12,
                       **{**_COMMON, **ov})


def zamba2_27b(**ov) -> ModelConfig:
    # [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242; hf]
    return ModelConfig(name="zamba2-2.7b", num_layers=54, d_model=2560,
                       n_heads=32, n_kv_heads=32, d_ff=10240,
                       vocab_size=32000,
                       layer_kinds=("zamba",) * 54, hybrid_period=6,
                       ssm_state=64, ssm_expand=2, ssm_head_dim=64,
                       ssm_groups=1, ssm_conv=4, ssm_chunk=256,
                       n_chunks=9, **{**_COMMON, **ov})


ARCHS: Dict[str, Callable[..., ModelConfig]] = {
    "codeqwen1.5-7b": codeqwen15_7b,
    "qwen1.5-4b": qwen15_4b,
    "starcoder2-7b": starcoder2_7b,
    "qwen1.5-110b": qwen15_110b,
    "musicgen-medium": musicgen_medium,
    "paligemma-3b": paligemma_3b,
    "moonshot-v1-16b-a3b": moonshot_16b_a3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "mamba2-1.3b": mamba2_13b,
    "zamba2-2.7b": zamba2_27b,
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
