"""Staged decoder LM — the text training surface of ``repro.models.lm``.

The model is a **chain of stages** — [embed] + [layer chunks] + [head+loss]
— which is exactly the structure the paper's checkpointing DP consumes.
Parameters are plain nested dicts of tensors with the JAX package's pytree
layout: each chunk's layer parameters are **stacked** along a leading
``(length, ...)`` axis, and the chunk stage loops over it (the JAX package
scans it).  With ``scan_layer_remat="full"`` each layer runs under its own
checkpoint.  Layer kinds:

- ``dense`` — attention (GQA, or MLA with ``attention_kind="mla"``) + MLP;
- ``moe``   — attention + the shared/routed MoE (its Switch aux loss is
  summed along the chain and added to the loss in the head);
- ``mamba`` — the Mamba2 SSD mixer;
- ``zamba`` — a Mamba2 layer; a chunk that starts a ``hybrid_period`` first
  runs the *shared* attention+MLP block (Zamba2, always GQA), whose one
  set of parameters every such chunk stage holds, so its gradient is the
  sum over the chunks.

VLM/audio stages and the serving methods are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.rematerialize import build_remat_fn, remat
from ..device import resolve_device
from ..tree import tensors_of, tree_map, with_tensors
from . import attention as attn
from . import mamba2 as m2
from . import mlp as mlp_mod
from .common import (dense_apply, dense_init, rms_norm, rms_norm_init,
                     softmax_cross_entropy, truncated_normal_init)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    num_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None
    # attention
    attention_kind: str = "gqa"          # gqa | mla
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    query_scale: Optional[float] = None
    sliding_window: Optional[int] = None  # windowed attention (long-context)
    # mlp
    mlp_kind: str = "swiglu"             # swiglu | geglu | gelu
    # block pattern
    layer_kinds: Optional[Tuple[str, ...]] = None   # default: all "dense"
    # MoE
    num_experts: int = 0
    moe_top_k: int = 2
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss: float = 0.01
    moe_norm_topk: bool = True
    # MLA
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # SSM (Mamba2)
    ssm_expand: int = 2
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid (Zamba2)
    hybrid_period: int = 0               # shared attn block every N layers
    # modality
    modality: str = "text"               # text | audio_embed | vlm
    prefix_len: int = 0                  # VLM image-token prefix (bidirectional)
    embed_scale: bool = False            # Gemma: embeddings * sqrt(d)
    # numerics / execution
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    n_chunks: int = 8
    scan_layer_remat: str = "none"       # none | full  (inner per-layer remat)
    remat_policy: str = "none"           # none|full|periodic:K|rotor:B
    use_flash_attention: bool = False
    use_ssd_kernel: bool = False
    logits_chunk: int = 0                # token-chunked xent if > 0
    z_loss: float = 0.0
    attn_block_q: int = 512              # q-block size of chunked attention
    kv_cache_dtype: Any = None           # e.g. torch.float8_e4m3fn (serving)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.layer_kinds is None:
            object.__setattr__(self, "layer_kinds",
                               ("dense",) * self.num_layers)
        assert len(self.layer_kinds) == self.num_layers

    @property
    def kind_runs(self) -> List[Tuple[str, int, int]]:
        """Contiguous (kind, start, length) runs of identical layer kinds."""
        runs = []
        start = 0
        for i in range(1, self.num_layers + 1):
            if i == self.num_layers or self.layer_kinds[i] != self.layer_kinds[start]:
                runs.append((self.layer_kinds[start], start, i - start))
                start = i
        return runs

    @property
    def layer_slices(self) -> List[Tuple[int, int]]:
        """Per global layer ``j``: ``(chunk index, offset)`` into the stacked
        per-chunk parameter pytrees."""
        out: List[Tuple[int, int]] = []
        for ci, (kind, start, length) in enumerate(self.chunks):
            out.extend((ci, off) for off in range(length))
        return out

    @property
    def chunks(self) -> List[Tuple[str, int, int]]:
        """(kind, start, length) chunks — the rotor chain's interior stages.

        Chunks never cross kind boundaries; for Zamba2 they align with
        ``hybrid_period`` so each chunk owns at most one shared-attn call."""
        runs = self.kind_runs
        total = self.num_layers
        out: List[Tuple[str, int, int]] = []
        budget = max(self.n_chunks, len(runs))
        for kind, start, length in runs:
            if kind == "zamba" and self.hybrid_period:
                per = self.hybrid_period
                n = max(1, length // per)
            else:
                n = max(1, round(budget * length / total))
            n = min(n, length)
            base, extra = divmod(length, n)
            pos = start
            for j in range(n):
                size = base + (1 if j < extra else 0)
                out.append((kind, pos, size))
                pos += size
        return out


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def _attn_block_init(gen: torch.Generator, cfg, dt, device,
                     ffn: str = "mlp", mla: bool = False) -> Params:
    """Pre-norm attention + feed-forward: the dense block (also Zamba2's
    shared block) and the MoE block (``ffn="moe"``), with MLA attention
    where ``mla``."""
    a_init = attn.mla_init if mla else attn.gqa_init
    p = {"ln1": rms_norm_init(cfg.d_model, dt, device),
         "attn": a_init(gen, cfg, dt, device),
         "ln2": rms_norm_init(cfg.d_model, dt, device)}
    if ffn == "moe":
        p["moe"] = mlp_mod.moe_init(gen, cfg, dt, device)
    else:
        p["mlp"] = mlp_mod.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device,
                                    cfg.mlp_kind, cfg.num_layers)
    return p


def _block_init(gen: torch.Generator, cfg, kind: str, device) -> Params:
    dt = cfg.param_dtype
    if kind in ("mamba", "zamba"):
        return {"ln": rms_norm_init(cfg.d_model, dt, device),
                "mixer": m2.mamba2_init(gen, cfg, dt, device)}
    return _attn_block_init(gen, cfg, dt, device,
                            "moe" if kind == "moe" else "mlp",
                            mla=cfg.attention_kind == "mla")


def _apply_block(p: Params, h: torch.Tensor, cfg, kind: str, mask=None,
                 positions=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer: ``(h, aux)`` — aux is the MoE's aux loss, ``None`` for
    the other kinds."""
    if kind in ("mamba", "zamba"):
        return h + m2.mamba2_apply(p["mixer"], cfg, rms_norm(p["ln"], h)), None
    a_apply = attn.mla_apply if cfg.attention_kind == "mla" else attn.gqa_apply
    h = h + a_apply(p["attn"], cfg, rms_norm(p["ln1"], h), positions, mask)
    if kind == "moe":
        y, aux = mlp_mod.moe_apply(p["moe"], cfg, rms_norm(p["ln2"], h))
        return h + y, aux
    return h + mlp_mod.mlp_apply(p["mlp"], rms_norm(p["ln2"], h),
                                 cfg.mlp_kind), None


def _stack(trees: List[Params]) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _check_supported(cfg) -> None:
    kinds = set(cfg.layer_kinds)
    allowed = ({"dense", "moe", "mamba", "zamba"}
               if cfg.attention_kind == "gqa" else {"dense", "moe"})
    if (cfg.modality != "text" or cfg.attention_kind not in ("gqa", "mla")
            or not kinds <= allowed
            or cfg.scan_layer_remat not in ("none", "full")):
        raise NotImplementedError(
            f"{cfg.name}: only text models with dense, MoE, Mamba2 and "
            f"Zamba2 layers on GQA attention, or dense and MoE layers on MLA, "
            f"are ported (modality={cfg.modality}, "
            f"attention={cfg.attention_kind}, kinds={sorted(kinds)}, "
            f"scan_layer_remat={cfg.scan_layer_remat})")


# ---------------------------------------------------------------------------
# the staged model
# ---------------------------------------------------------------------------

class StagedLM:
    """init/apply bundle; stages line up with the rotor chain."""

    def __init__(self, cfg: ModelConfig):
        _check_supported(cfg)
        self.cfg = cfg

    # -- parameters -------------------------------------------------------

    def init(self, seed: int = 0,
             device: Union[str, torch.device, None] = None) -> Params:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        target device; a ``meta`` device gives shapes only).  Leaves require
        grad."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
        gen.manual_seed(seed)
        dt = cfg.param_dtype
        params: Params = {"embed": {"table": truncated_normal_init(
            gen, (cfg.vocab_size, cfg.d_model), dt, 1.0, dev)}}
        params["chunks"] = [
            _stack([_block_init(gen, cfg, kind, dev) for _ in range(length)])
            for kind, start, length in cfg.chunks]
        if cfg.hybrid_period and "zamba" in cfg.layer_kinds:
            params["shared_attn"] = _attn_block_init(gen, cfg, dt, dev)
        params["final_norm"] = rms_norm_init(cfg.d_model, dt, dev)
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt, dev)
        return tree_map(lambda t: t.requires_grad_(), params)

    # -- stage functions (the rotor chain) ---------------------------------

    def n_stages(self) -> int:
        return len(self.cfg.chunks) + 2

    def stage_params(self, params: Params) -> List[Any]:
        """Per-stage parameters; with Zamba2's shared block every chunk stage
        holds it beside its own (``{"chunk", "shared"}``)."""
        shared = params.get("shared_attn")
        sp: List[Any] = [params["embed"]]
        sp.extend({"chunk": c} if shared is None
                  else {"chunk": c, "shared": shared}
                  for c in params["chunks"])
        sp.append({"final_norm": params["final_norm"], "head": params["head"]})
        return sp

    def combine_stage_grads(self, stage_grads: List[Any]) -> Params:
        """Inverse of :meth:`stage_params`: a params-shaped gradient tree,
        the shared block's gradient summed over the chunk stages."""
        out: Params = {"embed": stage_grads[0],
                       "chunks": [g["chunk"] for g in stage_grads[1:-1]]}
        shared = [g["shared"] for g in stage_grads[1:-1] if "shared" in g]
        if shared:
            out["shared_attn"] = with_tensors(shared[0], [
                sum(ts) for ts in zip(*map(tensors_of, shared))])
        out["final_norm"] = stage_grads[-1]["final_norm"]
        out["head"] = stage_grads[-1]["head"]
        return out

    def _embed_stage(self, p: Params, batch: Dict[str, torch.Tensor]) -> Dict:
        h = F.embedding(batch["tokens"], p["table"]).to(self.cfg.dtype)
        return {"h": h, "aux": torch.zeros((), dtype=torch.float32,
                                           device=h.device),
                "labels": batch["labels"], "mask": batch.get("loss_mask")}

    def _chunk_stage(self, chunk_idx: int, p: Params, a: Dict) -> Dict:
        cfg = self.cfg
        kind, start, length = cfg.chunks[chunk_idx]
        h, aux = a["h"], a["aux"]
        B, S = h.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        mask = attn.MaskSpec(causal=True, window=cfg.sliding_window)
        if "shared" in p and start % cfg.hybrid_period == 0:
            # Zamba2's shared block is a dense block; not under the
            # per-layer checkpoint, as in the reference
            h = _apply_block(p["shared"], h, cfg, "dense", mask, positions)[0]
        fn = functools.partial(_apply_block, cfg=cfg, kind=kind, mask=mask,
                               positions=positions)
        for j in range(length):
            lp = tree_map(lambda t: t[j], p["chunk"])
            h, layer_aux = (remat(fn, lp, h) if cfg.scan_layer_remat == "full"
                            else fn(lp, h))
            if layer_aux is not None:
                aux = aux + layer_aux
        return {"h": h, "aux": aux, "labels": a["labels"], "mask": a["mask"]}

    def _head_stage(self, p: Params, a: Dict) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(p["final_norm"], a["h"])
        if cfg.logits_chunk:
            from ..kernels.xent import ops as xent_ops
            loss = xent_ops.token_chunked_xent(
                h, p["head"]["kernel"], a["labels"], a["mask"],
                block=cfg.logits_chunk, z_loss=cfg.z_loss)
        else:
            loss = softmax_cross_entropy(dense_apply(p["head"], h),
                                         a["labels"], a["mask"], cfg.z_loss)
        return loss + a["aux"]

    def stage_fns(self) -> List[Any]:
        fns: List[Any] = [self._embed_stage]
        fns.extend(functools.partial(self._chunk_stage, i)
                   for i in range(len(self.cfg.chunks)))
        fns.append(self._head_stage)
        return fns

    # -- plain & rotor forward ---------------------------------------------

    def loss_fn(self, params: Params, batch: Dict, tree=None) -> torch.Tensor:
        """Full train loss; with ``tree`` (a rotor/remat schedule tree) the
        chain runs through its nested-checkpoint structure."""
        sp = self.stage_params(params)
        fns = self.stage_fns()
        if tree is None:
            a = batch
            for fn, p in zip(fns, sp):
                a = fn(p, a)
            return a
        return build_remat_fn(tree, fns)(sp, batch)
