"""Logical-axis sharding rules (MaxText-style) on a ``torch.distributed``
``DeviceMesh`` with DTensor placements — the port of
``repro.distributed.sharding``.

Models name the dimensions of their parameters with *logical* axes
(``StagedLM.param_axes``); a rules table maps each logical axis to
physical mesh axes.  Resolution drops any mapping whose dimension does not
divide evenly across the mapped mesh axes (36 heads on a 16-wide model
axis, MQA's single KV head, batch 1), so every config shards as far as its
shapes allow.  :func:`spec_for` and :func:`shard_factor` are plain Python
over the mesh's axis sizes: any object whose ``shape`` maps axis names to
sizes is a mesh to them, and so is a ``DeviceMesh`` built with
``mesh_dim_names``.  :func:`placements_for` turns a spec into DTensor
placements: ``Shard(dim)`` on each mesh dimension a tensor dimension maps
to, ``Replicate()`` on the others.

Conventions:
- parameter logical names: ``embed`` (the FSDP axis), ``mlp``, ``heads``,
  ``kv``, ``vocab``, ``experts``, ``kv_lora``, ``stack`` (the stacked-layer
  dimension, never sharded), ``conv``, ``state``;
- activation logical names are prefixed ``act_``.

Execution is ZeRO-3 style (what ``"embed" → (pod, data)`` means): parameters
and moments live as DTensors, each rank holding its shards, and a stage
gathers its parameters (:func:`gather`) before it runs, so the kernels see
plain tensors; the gradient comes back summed over the batch-sharded mesh
dimensions, as the parameter's shard.  Under model-axis tensor parallelism
(:mod:`.tensor_parallel`) a stage gathers a weight over the batch-sharded
dimensions only and keeps its model shard (:data:`GATHER_MODES`).  The gathers and reductions are
explicit ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` /
``all_reduce`` calls on the mesh's groups (gradients summed in float32):
DTensor's own redistribution kills the ranks of a gloo group on CUDA
tensors, the plain collectives run.  Every collective of the port goes
through the helpers here, which count its calls and bytes
(:func:`collectives`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

Logical = Optional[str]
Spec = Tuple[Any, ...]

# physical axes of the production mesh
POD, DATA, MODEL = "pod", "data", "model"

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # parameters
    "embed": (POD, DATA),        # FSDP: shard the d_model dim of weights
    "mlp": (MODEL,),
    "heads": (MODEL,),
    "kv": (MODEL,),
    "vocab": (MODEL,),
    "experts": (MODEL,),
    "mlp_expert": (MODEL,),   # dropped when `experts` already took the axis
    "kv_lora": (),
    "stack": (),
    "conv": (),
    "state": (),
    "ssm_heads": (MODEL,),
    "heads_merged": (MODEL,),  # fused (H·Dh) input dim of the output proj
    # activations
    "act_batch": (POD, DATA),
    "act_seq": (),
    "act_embed": (),
    "act_heads": (MODEL,),
    "act_kv": (MODEL,),
    "act_mlp": (MODEL,),
    "act_vocab": (MODEL,),
    "act_group": (POD, DATA),   # MoE dispatch-buffer DP-group dim
    "act_experts": (MODEL,),
    "act_mlp_expert": (MODEL,),
    "act_kv_seq": (),           # KV-cache sequence dim
    "act_ssm_heads": (MODEL,),
}

# Serving: the KV cache dominates memory, and KV-head counts rarely divide
# the model axis — shard the cache's sequence dim on the model axis instead.
DECODE_RULES: Dict[str, Tuple[str, ...]] = dict(
    DEFAULT_RULES,
    act_kv_seq=(MODEL,),
)

# Long-context decode (batch too small to shard): the KV/seq dims go over
# the data axis as well.
LONG_CONTEXT_RULES: Dict[str, Tuple[str, ...]] = dict(
    DEFAULT_RULES,
    act_kv_seq=(DATA, MODEL),
    act_seq=(DATA,),
)


@dataclasses.dataclass
class AxisRules:
    mesh: Any
    rules: Dict[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """Where a tensor lives: a ``DeviceMesh`` and one placement per mesh
    dimension (the port's ``NamedSharding``)."""

    mesh: Any
    placements: Tuple[Any, ...]


_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def axis_rules(mesh: Any, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Activate a mesh and a logical rules table for the model's own
    choices (the MoE's expert-parallel path, :func:`constrain`)."""
    _stack().append(AxisRules(mesh, dict(rules or DEFAULT_RULES)))
    try:
        yield
    finally:
        _stack().pop()


class reentered:
    """A context manager that activates, on whatever thread and as often as
    it is entered, the meshes and rules active where it was made: a
    checkpoint's recompute runs the split blocks again on autograd's
    backward thread (its own on CUDA), whose stack is empty
    (``core.rematerialize.remat``)."""

    def __init__(self):
        self.frozen, self.depths = list(_stack()), []

    def __enter__(self):
        st = _stack()
        self.depths.append(len(st))
        st.extend(self.frozen)

    def __exit__(self, *exc):
        del _stack()[self.depths.pop():]
        return False


def current_mesh() -> Any:
    st = _stack()
    return st[-1].mesh if st else None


def current_rules() -> Dict[str, Tuple[str, ...]]:
    st = _stack()
    return st[-1].rules if st else DEFAULT_RULES


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (named dimensions) or of a
    duck-typed mesh whose ``shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes_size(shape: Dict[str, int], axes: Sequence[str]) -> int:
    return math.prod(shape[a] for a in axes if a in shape)


def spec_for(logical_axes: Sequence[Logical], shape: Sequence[int],
             mesh: Any = None,
             rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Spec:
    """Resolve logical axes to a partition spec (one entry per tensor
    dimension: ``None``, a mesh axis name, or a tuple of them), dropping
    non-divisible dimensions; ``()`` without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules()
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        phys = tuple(a for a in rules.get(name, ()) if a in sizes
                     and a not in used)
        size = _axes_size(sizes, phys)
        if not phys or size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(phys)
        out.append(phys if len(phys) > 1 else phys[0])
    return tuple(out)


def placements_for(logical_axes: Sequence[Logical], shape: Sequence[int],
                   mesh: Any = None,
                   rules: Optional[Dict[str, Tuple[str, ...]]] = None
                   ) -> Tuple[Any, ...]:
    """:func:`spec_for`'s answer as DTensor placements on ``mesh`` (a
    ``DeviceMesh`` with named dimensions): ``Shard(i)`` on each mesh
    dimension that tensor dimension ``i`` maps to, ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh if mesh is not None else current_mesh()
    spec = spec_for(logical_axes, shape, mesh, rules)
    where: Dict[str, int] = {}
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                where[axis] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def sharding_for(logical_axes: Sequence[Logical], shape: Sequence[int],
                 mesh: Any = None,
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None
                 ) -> Optional[MeshSharding]:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return MeshSharding(mesh, placements_for(logical_axes, shape, mesh,
                                             rules))


def constrain(x: torch.Tensor, *logical_axes: Logical) -> torch.Tensor:
    """Redistribute a DTensor to the placements of ``logical_axes`` on its
    own mesh; any other tensor (or no active mesh) passes unchanged."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or current_mesh() is None:
        return x
    return x.redistribute(x.device_mesh, placements_for(
        logical_axes, x.shape, x.device_mesh))


def shard_factor(*logical_axes: Logical,
                 shape: Optional[Sequence[int]] = None) -> int:
    """Total number of shards a tensor with these axes gets under the
    active mesh and rules (1 without a mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_shape(mesh)
    rules = current_rules()
    total = 1
    used: set = set()
    for i, name in enumerate(logical_axes):
        if name is None:
            continue
        phys = tuple(a for a in rules.get(name, ()) if a in sizes
                     and a not in used)
        size = _axes_size(sizes, phys)
        if size <= 1:
            continue
        if shape is not None and shape[i] % size != 0:
            continue
        used.update(phys)
        total *= size
    return total


# ---------------------------------------------------------------------------
# the mesh of a run
# ---------------------------------------------------------------------------

def make_mesh(shape: Tuple[int, int], device_type: str) -> Any:
    """A ``(data, model)`` ``DeviceMesh`` over the default process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=(DATA, MODEL))


def batch_mesh_dims(mesh: Any,
                    rules: Optional[Dict[str, Tuple[str, ...]]] = None
                    ) -> Tuple[str, ...]:
    """The mesh axes the batch is sharded over (``act_batch``'s, size > 1)."""
    sizes = mesh_shape(mesh)
    rules = rules or current_rules()
    return tuple(a for a in rules.get("act_batch", ())
                 if sizes.get(a, 1) > 1)


def data_position(mesh: Any,
                  rules: Optional[Dict[str, Tuple[str, ...]]] = None
                  ) -> Tuple[int, int]:
    """``(host_count, host_index)``: how many slices the batch is cut into
    on ``mesh`` and which one this rank takes (its coordinate on the batch
    axes, the first axis most significant)."""
    count, index = 1, 0
    for axis in batch_mesh_dims(mesh, rules):
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        count, index = count * size, index * size + mesh.get_local_rank(axis)
    return count, index


def mesh_group(mesh: Any, axes: Sequence[str]):
    """The process group of this rank's peers along ``axes`` (one axis of
    size > 1), or ``None`` when none of ``axes`` has more than one member."""
    live = [a for a in axes if mesh_shape(mesh).get(a, 1) > 1]
    if not live:
        return None
    if len(live) > 1:
        raise NotImplementedError(f"a group over several mesh axes {live}")
    return mesh.get_group(live[0])


# ---------------------------------------------------------------------------
# ZeRO-3: parameters as DTensors, gathered by the stage that runs them
# ---------------------------------------------------------------------------

def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


#: the collectives this process issued through the helpers below (the
#: ZeRO-3 gathers and gradient reductions, the expert exchange, the
#: optimizer's norm, compression): calls and the bytes this rank handed
#: in (a gather's shard, a reduction's whole input); calls by op, bytes by
#: (op, the process group they crossed: its ``group_name``, ``"default"``
#: for the default group), which says which link they took
COLLECTIVE_CALLS: Dict[str, int] = {}
COLLECTIVE_BYTES: Dict[Tuple[str, str], int] = {}


def _count(op: str, x: torch.Tensor, group) -> None:
    """Count one call of ``op`` handing in ``x`` on ``group``; the
    model-axis tensor-parallel operators (:mod:`.tensor_parallel`) count
    theirs as ``tp_<op>``."""
    key = (op, "default" if group is None else group.group_name)
    COLLECTIVE_CALLS[op] = COLLECTIVE_CALLS.get(op, 0) + 1
    COLLECTIVE_BYTES[key] = (COLLECTIVE_BYTES.get(key, 0)
                             + x.numel() * x.element_size())


def reset_collectives() -> None:
    COLLECTIVE_CALLS.clear()
    COLLECTIVE_BYTES.clear()


def collectives() -> Dict[str, Dict[str, int]]:
    """A copy of the counts: ``{"calls": {op: n}, "bytes": {op: n}}``."""
    by_op: Dict[str, int] = {}
    for (op, _), n in COLLECTIVE_BYTES.items():
        by_op[op] = by_op.get(op, 0) + n
    return {"calls": dict(COLLECTIVE_CALLS), "bytes": by_op}


def _all_gather(x: torch.Tensor, dim: int, group, n: int,
                prefix: str = "") -> torch.Tensor:
    """The ``n`` members' ``x`` concatenated along ``dim``."""
    import torch.distributed as dist

    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    _count(prefix + "all_gather", x0, group)
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The members' sum of ``x``, this member's ``1/n`` of it along ``dim``
    (summed in float32)."""
    import torch.distributed as dist

    x0 = x.movedim(dim, 0).float().contiguous()
    out = x0.new_empty((x0.shape[0] // n,) + tuple(x0.shape[1:]))
    _count("reduce_scatter", x0, group)
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


def all_reduce(x: torch.Tensor, group=None, op: str = "sum",
               prefix: str = "") -> torch.Tensor:
    """The members' sum (``op="max"``: maximum) of ``x``, reduced in
    float32 (in place when ``x`` is a contiguous float32 tensor); ``group``
    ``None`` is the default group."""
    import torch.distributed as dist

    out = x.float().contiguous()
    _count(prefix + "all_reduce", out, group)
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return out.to(x.dtype)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of equal blocks along dim 0: block ``m`` goes
    to member ``m``, block ``s`` of the result came from member ``s``."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", x, group)
    dist.all_to_all_single(out, x, group=group)
    return out


#: how a stage takes a DTensor parameter (:func:`gather`): ``full`` its
#: whole value; ``local`` this rank's shard (a MoE's routed experts under
#: expert parallelism); ``data`` gathered over the batch-sharded mesh
#: dimensions only, keeping its model-axis shard (a tensor-parallel block's
#: weights); ``partial`` whole, its gradient summed over the model axis as
#: well (a weight that each model rank uses only in part, Mamba2's fused
#: ``in_proj`` under tensor parallelism)
GATHER_MODES = ("full", "local", "data", "partial")


def _gather_local(local: torch.Tensor, mesh: Any, placements: Sequence[Any],
                  dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The full value of a DTensor from its shard (or its value gathered
    along the mesh dimensions ``dims`` only): gathered along each sharded
    mesh dimension, the last first (a DTensor is cut in mesh dimension
    order)."""
    from torch.distributed.tensor import Shard

    out = local
    for i in reversed(range(mesh.ndim)):
        if dims is not None and i not in dims:
            continue
        if isinstance(placements[i], Shard) and mesh.size(i) > 1:
            out = _all_gather(out, placements[i].dim, mesh.get_group(i),
                              mesh.size(i))
    return out


def _gathered_dims(mesh: Any, mode: str, batch: Sequence[str]) -> Tuple[int, ...]:
    """The mesh dimensions a :data:`GATHER_MODES` mode gathers along."""
    if mode not in GATHER_MODES:
        raise ValueError(f"gather mode {mode!r}: expected one of "
                         f"{GATHER_MODES}")
    names = mesh.mesh_dim_names
    if mode == "local":
        return ()
    if mode == "data":
        return tuple(i for i, a in enumerate(names) if a in batch)
    return tuple(range(mesh.ndim))


class _Gathered(torch.autograd.Function):
    """A DTensor's shard → its value gathered along the mesh dimensions of
    ``mode`` (:data:`GATHER_MODES`); the backward sums the gradient over
    the batch-sharded mesh dimensions (and over the model axis in the
    ``partial`` mode) and cuts this rank's shard out of it, with explicit
    collectives (``reduce_scatter_tensor``, ``all_reduce``) on the mesh's
    groups."""

    @staticmethod
    def forward(ctx, local_t, mesh, placements, mode, batch):
        ctx.mesh, ctx.placements, ctx.batch = mesh, placements, batch
        ctx.dims = _gathered_dims(mesh, mode, batch)
        ctx.partial = mode == "partial"
        if not ctx.dims:
            return local_t.view_as(local_t)
        return _gather_local(local_t, mesh, placements, ctx.dims)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Shard

        mesh, g = ctx.mesh, grad
        for i, p in enumerate(ctx.placements):
            n = mesh.size(i)
            if n == 1:
                continue
            shard, gathered = isinstance(p, Shard), i in ctx.dims
            if ctx.mesh.mesh_dim_names[i] in ctx.batch or ctx.partial:
                if not shard:
                    g = all_reduce(g, mesh.get_group(i))
                elif gathered:
                    g = _reduce_scatter(g, p.dim, mesh.get_group(i), n)
            elif shard and gathered:
                g = g.chunk(n, dim=p.dim)[mesh.get_local_rank(i)]
        return g.contiguous(), None, None, None, None


def gather_one(t: Any, mode: str = "full") -> Any:
    """A plain tensor of a DTensor's value as ``mode`` takes it
    (:data:`GATHER_MODES`; ``full``: the whole value); its gradient comes
    back summed over the batch-sharded mesh dimensions as the DTensor's
    shard.  Other leaves as they are."""
    if not _is_dtensor(t):
        return t
    mesh = t.device_mesh
    return _Gathered.apply(t.to_local(), mesh, tuple(t.placements), mode,
                           batch_mesh_dims(mesh))


def local(t: Any) -> Any:
    """This rank's shard of a DTensor as a plain tensor (its gradient summed
    over the batch-sharded mesh dimensions that replicate it); other
    leaves as they are."""
    return gather_one(t, "local")


def gather(tree: Any, mode_of: Callable[[str], str] = lambda _: "full"
           ) -> Any:
    """Every DTensor leaf of ``tree`` as a plain tensor, taken as
    ``mode_of(path)`` says (:data:`GATHER_MODES`)."""
    from ..tree import map_with_paths

    return map_with_paths(lambda path, t: gather_one(t, mode_of(path)), tree)


def distribute(t: torch.Tensor, mesh: Any, placements: Sequence[Any]) -> Any:
    """``t`` (the same full value on every rank) as a DTensor: each rank
    keeps its own shard, nothing is sent.  A leaf that required grad still
    does."""
    from torch.distributed.tensor import distribute_tensor

    out = distribute_tensor(t.detach(), mesh, list(placements),
                            src_data_rank=None)
    return out.requires_grad_(t.requires_grad)


def full_value(t: Any) -> Any:
    """A DTensor's full value as a plain tensor, gathered on every rank (a
    collective: every rank calls it); other leaves as they are."""
    if not _is_dtensor(t):
        return t
    with torch.no_grad():
        return _gather_local(t.to_local(), t.device_mesh, t.placements)


def local_tensor(t: Any) -> Any:
    """A view of this rank's shard of a DTensor (in-place updates to it,
    under ``torch.no_grad``, update the DTensor); other leaves as they
    are."""
    return t.to_local() if _is_dtensor(t) else t


def replication(t: Any) -> int:
    """How many ranks hold the same shard of ``t`` (1 for a plain tensor)."""
    if not _is_dtensor(t):
        return 1
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    return math.prod(mesh.size(i) for i, p in enumerate(t.placements)
                     if isinstance(p, Replicate))
