"""Roofline terms of one traced step (the port of ``repro.launch.roofline``).

The reference reads XLA's compiled module: ``cost_analysis`` for FLOPs and
bytes, the HLO text for the collectives' operand bytes, the buffer
assignment for the peak.  Eager PyTorch has no compiled module, so
:func:`trace_step` runs the step once — in the dry-run on fake tensors, so
nothing is allocated — and reads it as it runs:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products
  and convolutions; a kernel called through ``ctypes`` is invisible to it);
- ``bytes_accessed``: :class:`ByteCounter`, each aten op's input and output
  bytes, which is what eager PyTorch moves with no fusion; a kernel op of
  the port (K3, K4, K6) that runs its plain version off CUDA is booked as
  the kernel moves it (``counters.plain``: its arguments read once, its
  outputs written once), not by its plain version's score tensors;
- ``collective_bytes`` and ``collective_breakdown``: the port's own
  collective counts (``distributed/sharding.py::collectives``), under the
  reference's kinds, priced on the link each process group crosses (the
  model axis on NVLink, the others on the network);
- ``per_device_peak_bytes``: ``torch.distributed._tools.mem_tracker
  .MemTracker``'s peak over the step, the arguments included.

There is no HLO, so ``collective_bytes_from_hlo`` has no counterpart.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import counters
from ..distributed import sharding as shd
from .mesh import H100_SXM, Hardware

#: the reference's collective kinds, and the port's ops under each
COLLECTIVE_KINDS = {
    "all-reduce": ("all_reduce", "tp_all_reduce"),
    "all-gather": ("all_gather", "tp_all_gather"),
    "reduce-scatter": ("reduce_scatter",),
    "all-to-all": ("all_to_all",),
    "collective-permute": (),
    "ragged-all-to-all": (),
}


def _nbytes(t: Any) -> int:
    """Bytes of a tensor (a DTensor's local shard); 0 for anything else."""
    if not isinstance(t, torch.Tensor):
        return 0
    t = getattr(t, "_local_tensor", t)
    return t.numel() * t.element_size()


def _tensor_bytes(tree: Any) -> int:
    return sum(_nbytes(t) for t in tree_flatten(tree)[0])


class ByteCounter(TorchDispatchMode):
    """Sums the bytes each aten op reads and writes: its tensor arguments
    and its outputs, each counted whole.  Views and collectives move no
    device bytes here (the collectives are counted apart).  A kernel op's
    plain version runs :meth:`uncounted` and is booked (:meth:`book`) as
    the kernel moves it."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.kernel_bytes: Dict[str, int] = {}
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not self._inside and not func.is_view
                and func.namespace not in ("c10d", "_c10d_functional")):
            self.total += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out

    @contextlib.contextmanager
    def uncounted(self):
        """Count no op while in the block."""
        self._inside += 1
        try:
            yield
        finally:
            self._inside -= 1

    def book(self, name: str, args: tuple, out: Any) -> None:
        """Book kernel op ``name``: its tensor arguments read once, its
        outputs ``out`` written once."""
        n = _tensor_bytes(args) + _tensor_bytes(out)
        self.total += n
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + n


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device
    bytes_accessed: float        # per-device
    collective_bytes: float      # per-device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # 6·N_active·D (global)
    useful_ratio: float          # MODEL_FLOPS / (FLOPs · devices)
    per_device_peak_bytes: Optional[float] = None
    collective_breakdown: Optional[Dict[str, float]] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepTrace:
    """What :func:`trace_step` read from one step."""

    flops: float
    bytes_accessed: float
    kernel_bytes: Dict[str, int]         # booked by kernel op
    #: by (the port's op name, process-group name)
    collective_bytes: Dict[Tuple[str, str], int]
    peak_bytes: float


def trace_step(step: Callable, args: tuple) -> StepTrace:
    """Run ``step(*args)`` once under the counters and ``MemTracker``,
    which tracks the arguments as well."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    shd.reset_collectives()
    tracker = MemTracker()
    tracker.track_external(*[t for t in tree_flatten(args)[0]
                             if isinstance(t, torch.Tensor)])
    counter = ByteCounter()
    flop_counter = FlopCounterMode(display=False)
    with tracker, flop_counter, counter, counters.byte_sink(counter):
        step(*args)
    snap = tracker.get_tracker_snapshot("peak")
    return StepTrace(flops=float(flop_counter.get_total_flops()),
                     bytes_accessed=float(counter.total),
                     kernel_bytes=dict(counter.kernel_bytes),
                     collective_bytes=dict(shd.COLLECTIVE_BYTES),
                     peak_bytes=float(max(v.get("Total", 0)
                                          for v in snap.values())))


def analyze(trace: StepTrace, mesh, n_devices: int, model_flops: float,
            hw: Hardware = H100_SXM) -> Roofline:
    """The roofline of a traced step on one device of ``mesh`` (a
    ``DeviceMesh``, or ``None`` for one device) priced at ``hw``."""
    breakdown = {kind: float(sum(n for (op, _), n
                                 in trace.collective_bytes.items()
                                 if op in ops))
                 for kind, ops in COLLECTIVE_KINDS.items()}
    breakdown["total"] = float(sum(trace.collective_bytes.values()))
    model_group = None
    if mesh is not None and shd.MODEL in (mesh.mesh_dim_names or ()):
        model_group = mesh.get_group(shd.MODEL).group_name
    collective_s = sum(n / hw.link_bw(shd.MODEL if g == model_group
                                      else shd.DATA)
                       for (_, g), n in trace.collective_bytes.items())
    compute_s = trace.flops / hw.peak_bf16
    memory_s = trace.bytes_accessed / hw.hbm_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    return Roofline(
        flops=trace.flops, bytes_accessed=trace.bytes_accessed,
        collective_bytes=breakdown["total"], compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s,
        dominant=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=model_flops / max(trace.flops * n_devices, 1.0),
        per_device_peak_bytes=trace.peak_bytes,
        collective_breakdown=breakdown)
