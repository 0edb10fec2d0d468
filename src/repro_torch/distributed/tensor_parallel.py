"""Model-axis tensor parallelism: the collectives that split a block's heads,
MLP columns, SSM heads and vocabulary over the ``model`` axis of a mesh, as
GSPMD partitions the JAX package's matmuls under ``act_heads`` /
``act_mlp`` / ``act_ssm_heads`` / ``act_vocab``.

Megatron-LM's two operators carry a block:

- :func:`copy_to_model` (*f*): identity forward, the input gradient summed
  over the model group in the backward.  It goes before every
  column-parallel projection, and on every replicated weight that each
  rank uses only in part (MQA's one KV head, MLA's latent projection, the
  Mamba2 conv), so that every gradient leaving the split region is whole.
- :func:`reduce_from_model` (*g*): the partial outputs summed over the
  model group forward, identity backward.  It goes after every row-parallel
  projection.

:func:`gather_from_model` / :func:`scatter_to_model` concatenate or cut a
tensor along one dimension (all-gather forward and this rank's slice
backward, or the reverse).  :func:`model_slice` is a rank's share of ``n``
heads, columns or rows: the contiguous split that ``sharding.spec_for``'s
``Shard`` placement gives, or all ``n`` where the axis does not divide it
(``spec_for`` then replicates).

Activations stay plain tensors (``sharding.constrain`` does nothing to
them).  A block sees whether it is split from its weights: a stage under
tensor parallelism takes its model-sharded weights as this rank's shards
(``sharding.gather`` in the ``data`` mode), so the local head, column or
row count is below the config's.  The model group is the active mesh's
(``sharding.axis_rules``).  With a model axis of 1 there is no group and
every operator here is the identity and issues nothing.  Every collective
goes through the counting helpers of :mod:`.sharding`, as ``tp_<op>``.

Decode over a sequence-split KV cache (``DECODE_RULES`` /
``LONG_CONTEXT_RULES``: ``act_kv_seq`` on the model axis, or on the data
and model axes) combines each rank's partial attention by the log-sum-exp
merge (:func:`merge_partial_attention`) over the ranks that split the
sequence (:func:`kv_seq_shard`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from . import sharding as shd

PREFIX = "tp_"


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: its process group, the axis'
    size and this rank's coordinate along it."""

    group: Any
    size: int
    rank: int

    def slice(self, n: int) -> Tuple[int, int]:
        """This rank's ``(start, stop)`` of ``n`` (all of it when the axis
        does not divide ``n``)."""
        if n % self.size:
            return 0, n
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step


def model_axis(mesh: Any = None) -> Optional[ModelAxis]:
    """The model axis of ``mesh`` (the active one by default) when it has
    more than one member, else ``None``."""
    mesh = mesh if mesh is not None else shd.current_mesh()
    if mesh is None or shd.mesh_shape(mesh).get(shd.MODEL, 1) <= 1:
        return None
    return ModelAxis(mesh.get_group(shd.MODEL),
                     shd.mesh_shape(mesh)[shd.MODEL],
                     mesh.get_local_rank(shd.MODEL))


def model_slice(n: int, mesh: Any = None) -> Tuple[int, int]:
    """This rank's share ``(start, stop)`` of ``n`` heads, columns or
    vocabulary rows on ``mesh``'s model axis: the contiguous block that
    ``spec_for``'s ``Shard`` gives it, or ``(0, n)`` when the axis has one
    member or does not divide ``n``."""
    axis = model_axis(mesh)
    return (0, n) if axis is None else axis.slice(n)


def split_by(local: int, whole: int) -> Optional[ModelAxis]:
    """The active model axis when a weight's local extent ``local`` is its
    share of ``whole`` (the block runs split), else ``None``; raises when
    the extent is cut but no model axis is active or the counts disagree."""
    if local == whole:
        return None
    axis = model_axis()
    if axis is None or local * axis.size != whole:
        raise ValueError(f"a weight holds {local} of {whole} along its "
                         f"split dimension, which is not one rank's share on "
                         f"the active mesh's model axis")
    return axis


# ---------------------------------------------------------------------------
# Megatron's f and g, and the gather / scatter along a dimension
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return shd.all_reduce(grad, ctx.group, prefix=PREFIX), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        # a copy: the helper reduces a float32 tensor in place
        return shd.all_reduce(x.clone(), group, prefix=PREFIX)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return shd._all_gather(x, dim, axis.group, axis.size, prefix=PREFIX)

    @staticmethod
    def backward(ctx, grad):
        part = grad.chunk(ctx.axis.size, dim=ctx.dim)[ctx.axis.rank]
        return part.contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return x.chunk(axis.size, dim=dim)[axis.rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (shd._all_gather(grad, ctx.dim, ctx.axis.group, ctx.axis.size,
                                prefix=PREFIX), None, None)


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """*f*: ``x`` unchanged; its gradient summed over the model group
    (``axis`` ``None``: the identity)."""
    return x if axis is None else _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """*g*: the members' sum of ``x`` (reduced in float32, returned in
    ``x``'s dtype); the gradient passes unchanged."""
    return x if axis is None else _ReduceFromModel.apply(x, axis.group)


def gather_from_model(x: torch.Tensor, dim: int, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in rank order; the
    gradient of this rank's part is its slice of the gradient (every rank
    computes the same whole gradient)."""
    return x if axis is None else _GatherFromModel.apply(x, dim, axis)


def scatter_to_model(x: torch.Tensor, dim: int, axis: Optional[ModelAxis]
                     ) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``; the gradient is
    the members' slices gathered back into a whole one."""
    return x if axis is None else _ScatterToModel.apply(x, dim, axis)


def all_reduce_max(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """The members' elementwise maximum of ``x`` (no gradient)."""
    if axis is None:
        return x
    return shd.all_reduce(x.detach(), axis.group, op="max", prefix=PREFIX)


# ---------------------------------------------------------------------------
# vocab-parallel cross-entropy and embedding
# ---------------------------------------------------------------------------

def vocab_parallel_lse_gold(logits: torch.Tensor, labels: torch.Tensor,
                            start: int, axis: Optional[ModelAxis]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logsumexp, the label's logit)`` over the whole vocabulary, each
    rank holding the float32 logits of its rows ``start ..`` (``axis``
    ``None``: all of them): the row maxima max-reduced, the sums of
    exponentials summed, and the label's logit taken from the rank that
    holds it (zero on the others) and summed."""
    if axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return lse, gold
    m = all_reduce_max(logits.detach().amax(dim=-1), axis)
    s = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), axis)
    lse = m + torch.log(s)
    own = labels.long() - start
    inside = (own >= 0) & (own < logits.shape[-1])
    picked = torch.gather(logits, -1, own.clamp(0, logits.shape[-1] - 1)
                          [..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, picked, 0.0), axis)
    return lse, gold


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor,
                             vocab: int) -> torch.Tensor:
    """``table[tokens]`` with ``table`` this rank's rows of a ``vocab``-row
    table (or all of them): each rank looks up the tokens it holds, zeros
    elsewhere, and the members' lookups are summed."""
    axis = split_by(table.shape[0], vocab)
    if axis is None:
        return torch.nn.functional.embedding(tokens, table)
    start = axis.slice(vocab)[0]
    own = tokens.long() - start
    inside = (own >= 0) & (own < table.shape[0])
    rows = torch.nn.functional.embedding(own.clamp(0, table.shape[0] - 1),
                                         table)
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0), axis)


# ---------------------------------------------------------------------------
# decode over a sequence-split KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This rank's block of a tensor dimension cut over one or more mesh
    axes: ``count`` blocks, this rank's ``index`` among them (the first
    mesh axis most significant, as ``spec_for``'s tuple placements cut it)
    and the process group of the ranks that hold the others."""

    count: int
    index: int
    group: Any


def block_of(entry: Any, mesh: Any) -> Optional[SeqShard]:
    """The block of a dimension that a ``spec_for`` entry (``None``, a mesh
    axis or a tuple of them) gives this rank on ``mesh``; ``None`` when the
    dimension is not cut.  Two live axes (``LONG_CONTEXT_RULES``' data and
    model) take the default group, which the ``(data, model)`` mesh
    spans."""
    import torch.distributed as dist

    if entry is None:
        return None
    axes = entry if isinstance(entry, tuple) else (entry,)
    sizes = shd.mesh_shape(mesh)
    count, index = 1, 0
    for a in axes:
        count = count * sizes[a]
        index = index * sizes[a] + mesh.get_local_rank(a)
    group = (mesh.get_group(axes[0]) if len(axes) == 1
             else dist.group.WORLD)
    return SeqShard(count, index, group)


def kv_seq_shard(batch: int, max_len: int, mesh: Any = None, rules=None
                 ) -> Optional[SeqShard]:
    """How a decode cache of ``batch`` × ``max_len`` positions is cut along
    its sequence (``act_kv_seq``, after ``act_batch`` took its axes) on
    ``mesh`` under ``rules`` (the active ones by default); ``None`` when it
    is not (no axis of size > 1, or ``max_len`` does not divide, as
    ``spec_for`` drops it)."""
    mesh = mesh if mesh is not None else shd.current_mesh()
    if mesh is None:
        return None
    spec = shd.spec_for(("act_batch", "act_kv_seq"), (batch, max_len), mesh,
                        rules or shd.current_rules())
    return block_of(spec[1], mesh)


def batch_shard(batch: int, mesh: Any = None, rules=None
                ) -> Optional[SeqShard]:
    """How ``act_batch`` cuts a batch of ``batch`` rows on ``mesh``."""
    mesh = mesh if mesh is not None else shd.current_mesh()
    if mesh is None:
        return None
    return block_of(shd.spec_for(("act_batch",), (batch,), mesh,
                                 rules or shd.current_rules())[0], mesh)


def merge_partial_attention(m: torch.Tensor, l: torch.Tensor,
                            o: torch.Tensor, shard: Optional[SeqShard]
                            ) -> torch.Tensor:
    """Attention over the whole sequence from each rank's part of it:
    ``m`` (..., ) the rank's float32 row maxima (``-inf`` or ``NEG`` where it
    holds no allowed position), ``l`` its sums of ``exp(s - m)``, ``o`` its
    sums of ``exp(s - m) · v`` (..., D).  All-reduces the maximum, then the
    rescaled sums and values; returns ``o / l`` in float32."""
    if shard is not None:
        mx = shd.all_reduce(m.clone(), shard.group, op="max", prefix=PREFIX)
        scale = torch.exp(m - mx)
        l = shd.all_reduce(l * scale, shard.group, prefix=PREFIX)
        o = shd.all_reduce(o * scale[..., None], shard.group, prefix=PREFIX)
    return o / l[..., None]
