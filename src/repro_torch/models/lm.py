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

Serving: :meth:`StagedLM.prefill` runs a prompt and fills the decode cache,
:meth:`StagedLM.decode_step` runs one token against it.  The cache is one
dict of tensors *per model layer* (``{"k", "v"}``, MLA's ``{"c_kv",
"k_rope"}`` or Mamba2's ``{"conv", "ssm"}``), one ``{"k", "v"}`` per Zamba2
shared-block invocation, and ``pos``, a Python int — the JAX package stacks
it per chunk.  So one layer's block can leave the card between its uses
(:mod:`..runtime.kv_residency`), and decode writes each new position in
place instead of rebuilding the cache.

Modalities (dense GQA layers only, as the JAX package's two configs):

- ``vlm`` (PaliGemma) — the batch carries ``image_embeds`` (B, P, d), a
  stand-in for the SigLIP tower, laid before the token embeddings; the
  first ``prefix_len`` positions attend to each other bidirectionally
  (so attention takes the plain path, never the causal flash kernel), and
  the head drops them before the loss;
- ``audio_embed`` (MusicGen) — the batch carries frame ``embeds`` (B, S, d),
  a stand-in for the EnCodec frontend, plus sinusoidal positions; the embed
  stage holds no parameters, and a decode step takes a frame (B, 1, d);
- ``embed_scale`` (Gemma) multiplies the embeddings by ``sqrt(d_model)``
  rounded to the model dtype, in training, prefill and decode.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.rematerialize import build_remat_fn, remat
from ..device import resolve_device
from ..tree import tensors_of, tree_bytes, tree_map, with_tensors
from . import attention as attn
from . import mamba2 as m2
from . import mlp as mlp_mod
from .common import (dense_apply, dense_init, rms_norm, rms_norm_init,
                     sinusoidal_positions, softmax_cross_entropy,
                     truncated_normal_init)

Params = Dict[str, Any]

#: the JAX package's cache holds ``pos`` as an int32 scalar; the port's is a
#: Python int, counted at the same 4 bytes so the layouts agree
POS_BYTES = 4


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Byte layout of a decode cache (see :meth:`StagedLM.cache_layout`).

    - ``block_bytes[j]`` — allocated bytes of model layer ``j``'s cache: its
      KV block padded to ``max_len`` (attention layers) or its recurrent
      state (SSM layers); the Zamba2 shared-attention KV is attributed
      evenly to the period-start layers that invoke it.
    - ``token_bytes`` — bytes logically appended per decoded token across
      all attention layers.
    - ``static_bytes`` — position-independent bytes (SSM conv/ssm states,
      the ``pos`` scalar).
    - ``allocated_bytes`` — total preallocated bytes; equals
      ``static_bytes + token_bytes * max_len`` exactly.
    """

    block_bytes: Tuple[int, ...]
    token_bytes: int
    static_bytes: int
    allocated_bytes: int
    max_len: int

    def logical_bytes(self, pos: int) -> int:
        """Bytes logically resident with ``pos`` tokens in the cache."""
        return self.static_bytes + int(pos) * self.token_bytes


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


def _ffn(p: Params, h: torch.Tensor, cfg, kind: str) -> torch.Tensor:
    """The feed-forward half of an attention block (MoE aux dropped)."""
    if kind == "moe":
        return h + mlp_mod.moe_apply(p["moe"], cfg, rms_norm(p["ln2"], h))[0]
    return h + mlp_mod.mlp_apply(p["mlp"], rms_norm(p["ln2"], h), cfg.mlp_kind)


def _fill(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    """Copy a prefill's cache tensors into the leading positions of the
    preallocated ones (in their dtype)."""
    for k, t in src.items():
        dst[k][:, :t.shape[1]].copy_(t)


def _stack(trees: List[Params]) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _check_supported(cfg) -> None:
    kinds = set(cfg.layer_kinds)
    allowed = ({"dense", "moe", "mamba", "zamba"}
               if cfg.attention_kind == "gqa" else {"dense", "moe"})
    if cfg.modality != "text":
        allowed = {"dense"} if cfg.attention_kind == "gqa" else set()
    if (cfg.modality not in ("text", "vlm", "audio_embed")
            or cfg.attention_kind not in ("gqa", "mla")
            or not kinds <= allowed
            or cfg.scan_layer_remat not in ("none", "full")):
        raise NotImplementedError(
            f"{cfg.name}: only text models with dense, MoE, Mamba2 and "
            f"Zamba2 layers on GQA attention, dense and MoE layers on MLA, "
            f"and VLM and audio models with dense GQA layers are ported "
            f"(modality={cfg.modality}, attention={cfg.attention_kind}, "
            f"kinds={sorted(kinds)}, scan_layer_remat={cfg.scan_layer_remat})")


def _train_mask(cfg) -> attn.MaskSpec:
    """Causal, the VLM's image prefix bidirectional, the sliding window."""
    return attn.MaskSpec(causal=True, prefix_len=cfg.prefix_len,
                         window=cfg.sliding_window)


def _scale_embeddings(cfg, h: torch.Tensor) -> torch.Tensor:
    """Gemma's ``h * sqrt(d_model)``, the factor rounded to the model dtype
    first (45.25 in bf16 at d_model 2048), as the JAX package does."""
    if not cfg.embed_scale:
        return h
    # a Python number: the product saves no tensor for its backward
    return h * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype).item()


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
        # an audio model takes frame embeddings: no table
        params: Params = {"embed": {} if cfg.modality == "audio_embed" else {
            "table": truncated_normal_init(gen, (cfg.vocab_size, cfg.d_model),
                                           dt, 1.0, dev)}}
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
        cfg = self.cfg
        if cfg.modality == "audio_embed":
            emb = batch["embeds"].to(cfg.dtype)
            h = emb + sinusoidal_positions(emb.shape[1], cfg.d_model,
                                           device=emb.device
                                           ).to(cfg.dtype)[None]
        else:
            h = F.embedding(batch["tokens"], p["table"]).to(cfg.dtype)
            if cfg.modality == "vlm":    # [image prefix] + [text tokens]
                h = torch.cat([batch["image_embeds"].to(cfg.dtype), h], dim=1)
        h = _scale_embeddings(cfg, h)
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
        mask = _train_mask(cfg)
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
        if cfg.modality == "vlm" and cfg.prefix_len:
            h = h[:, cfg.prefix_len:]    # no loss on the image prefix
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

    # -- logits forward and serving -----------------------------------------

    def _embed_stage_nolabel(self, p: Params, batch: Dict) -> Dict:
        x = batch["embeds" if self.cfg.modality == "audio_embed"
                  else "tokens"]
        return self._embed_stage(p, {
            **batch, "loss_mask": None,
            "labels": torch.zeros((x.shape[0], 1), dtype=torch.int32,
                                  device=x.device)})

    @torch.no_grad()
    def forward_logits(self, params: Params, batch: Dict,
                       at: Any = None) -> torch.Tensor:
        """Logits of every position of the sequence (a VLM's image prefix
        included), or only of the positions ``at`` indexes along it (the
        head's output is the largest tensor of a long sequence).  ``batch``
        holds ``tokens``, ``embeds`` (audio) or ``image_embeds`` and
        ``tokens`` (VLM)."""
        sp = self.stage_params(params)
        a = self._embed_stage_nolabel(params["embed"], batch)
        for i in range(len(self.cfg.chunks)):
            a = self._chunk_stage(i, sp[i + 1], a)
        h = a["h"] if at is None else a["h"][:, at]
        return dense_apply(params["head"], rms_norm(params["final_norm"], h))

    def _shared_starts(self) -> List[int]:
        """The layers that open a Zamba2 period: each invokes the shared
        block first (its KV is ``cache["shared"][i]`` for the i-th)."""
        cfg = self.cfg
        if not (cfg.hybrid_period and "zamba" in cfg.layer_kinds):
            return []
        return [start for kind, start, _ in cfg.chunks
                if kind == "zamba" and start % cfg.hybrid_period == 0]

    def _layer_params(self, params: Params, j: int) -> Params:
        ci, off = self.cfg.layer_slices[j]
        return tree_map(lambda t: t[off], params["chunks"][ci])

    def init_cache(self, batch: int, max_len: int, device=None) -> Dict:
        """A zeroed decode cache: attention KV in ``kv_cache_dtype`` (the
        model dtype if unset), the Zamba2 shared KV in the model dtype and
        the SSM states as :func:`..mamba2.mamba2_init_cache`, as the JAX
        package's ``init_cache`` lays them out; ``device="meta"`` allocates
        nothing."""
        cfg = self.cfg
        dev = resolve_device(device)
        cdt = cfg.kv_cache_dtype or cfg.dtype

        def zeros(*shape, dtype=cdt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        layers = []
        for kind in cfg.layer_kinds:
            if kind in ("mamba", "zamba"):
                layers.append(m2.mamba2_init_cache(cfg, batch, cfg.dtype, dev))
            elif cfg.attention_kind == "mla":
                layers.append({
                    "c_kv": zeros(batch, max_len, cfg.kv_lora_rank),
                    "k_rope": zeros(batch, max_len, 1, cfg.qk_rope_head_dim)})
            else:
                layers.append({
                    "k": zeros(batch, max_len, cfg.n_kv_heads, cfg.head_dim),
                    "v": zeros(batch, max_len, cfg.n_kv_heads, cfg.head_dim)})
        shared = [{k: zeros(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                            dtype=cfg.dtype) for k in ("k", "v")}
                  for _ in self._shared_starts()]
        return {"pos": 0, "layers": layers, "shared": shared}

    def cache_layout(self, batch: int, max_len: int) -> CacheLayout:
        """Byte layout of the decode cache, sized from :meth:`init_cache` on
        the ``meta`` device (nothing is allocated): the sizing base of the
        KV-residency planner (:mod:`..plan.serving`)."""
        cfg = self.cfg
        spec = self.init_cache(batch, max_len, device="meta")
        blocks = [tree_bytes(c) for c in spec["layers"]]
        attn_bytes = sum(b for b, kind in zip(blocks, cfg.layer_kinds)
                         if kind in ("dense", "moe"))
        static_bytes = POS_BYTES + sum(blocks) - attn_bytes
        shared_bytes = tree_bytes(spec["shared"])
        starts = self._shared_starts()
        for s in starts:
            blocks[s] += shared_bytes // len(starts)
        return CacheLayout(
            block_bytes=tuple(blocks),
            token_bytes=(attn_bytes + shared_bytes) // max_len,
            static_bytes=static_bytes,
            allocated_bytes=POS_BYTES + tree_bytes(spec["layers"])
            + shared_bytes,
            max_len=max_len)

    def cache_block(self, cache: Dict, j: int) -> List[Dict]:
        """The cache dicts that make up layer ``j``'s block: its own, and
        the shared block's KV where ``j`` opens a Zamba2 period."""
        starts = self._shared_starts()
        return [cache["layers"][j]] + ([cache["shared"][starts.index(j)]]
                                       if j in starts else [])

    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict,
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Run a full prompt (``batch`` as :meth:`forward_logits` takes it);
        returns ``(last-position logits (B, 1, V), decode cache)`` with room
        for ``max_len`` positions (a VLM's image prefix counts)."""
        cfg = self.cfg
        h = self._embed_stage_nolabel(params["embed"], batch)["h"]
        B, S = h.shape[:2]
        cache = self.init_cache(B, max_len or S, device=h.device)
        cache["pos"] = S
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        mask = _train_mask(cfg)
        starts = self._shared_starts()
        pf = attn.mla_prefill if cfg.attention_kind == "mla" \
            else attn.gqa_prefill
        for kind, start, length in cfg.chunks:
            if start in starts:
                sp = params["shared_attn"]
                y, kv = attn.gqa_prefill(sp["attn"], cfg,
                                         rms_norm(sp["ln1"], h), positions,
                                         mask)
                _fill(cache["shared"][starts.index(start)], kv)
                h = _ffn(sp, h + y, cfg, "dense")
            for j in range(start, start + length):
                lp = self._layer_params(params, j)
                if kind in ("mamba", "zamba"):
                    y, c = m2.mamba2_prefill(lp["mixer"], cfg,
                                             rms_norm(lp["ln"], h))
                    _fill(cache["layers"][j], c)
                    h = h + y
                else:
                    y, kv = pf(lp["attn"], cfg, rms_norm(lp["ln1"], h),
                               positions, mask)
                    _fill(cache["layers"][j], kv)
                    h = _ffn(lp, h + y, cfg, kind)
        h = rms_norm(params["final_norm"], h[:, -1:])
        return dense_apply(params["head"], h), cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Dict, tokens: torch.Tensor,
                    residency=None) -> Tuple[torch.Tensor, Dict]:
        """One greedy decode step.  ``tokens``: (B, 1) int, or for an audio
        model a frame embedding (B, 1, d_model), to which the sinusoidal
        code of the current position is added.  The cache is
        updated in place (the new position written, ``pos`` advanced) and
        returned with the logits (B, 1, V).  ``residency`` (a
        :mod:`..runtime.kv_residency` stager) is called around each layer:
        ``before_layer(cache, j)`` brings layer ``j``'s block to the card,
        ``after_layer(cache, j)`` may send it back."""
        cfg = self.cfg
        pos = cache["pos"]
        if cfg.modality == "audio_embed":
            h = tokens.to(cfg.dtype) + sinusoidal_positions(
                1, cfg.d_model, offset=pos, device=tokens.device
            ).to(cfg.dtype)[None]
        else:
            h = F.embedding(tokens, params["embed"]["table"]).to(cfg.dtype)
        h = _scale_embeddings(cfg, h)
        starts = self._shared_starts()
        dec = attn.mla_decode if cfg.attention_kind == "mla" \
            else attn.gqa_decode
        for j, kind in enumerate(cfg.layer_kinds):
            if residency is not None:
                residency.before_layer(cache, j)
            if j in starts:
                sp = params["shared_attn"]
                y, _ = attn.gqa_decode(sp["attn"], cfg,
                                       rms_norm(sp["ln1"], h),
                                       cache["shared"][starts.index(j)], pos)
                h = _ffn(sp, h + y, cfg, "dense")
            lp = self._layer_params(params, j)
            if kind in ("mamba", "zamba"):
                y, _ = m2.mamba2_decode(lp["mixer"], cfg,
                                        rms_norm(lp["ln"], h),
                                        cache["layers"][j])
                h = h + y
            else:
                y, _ = dec(lp["attn"], cfg, rms_norm(lp["ln1"], h),
                           cache["layers"][j], pos)
                h = _ffn(lp, h + y, cfg, kind)
            if residency is not None:
                residency.after_layer(cache, j)
        cache["pos"] = pos + 1
        h = rms_norm(params["final_norm"], h)
        return dense_apply(params["head"], h), cache
