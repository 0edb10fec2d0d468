"""KV-cache residency executors for the serve loop — the port of
``repro.runtime.kv_residency``.

Two policies move prefix-KV blocks (one model layer's cache, see
:meth:`..models.lm.StagedLM.cache_block`) between the card and the host
pool (:class:`..offload.host_buffer.HostBuffer`) around the layers of each
decode step (``StagedLM.decode_step(..., residency=)``):

- :class:`PlannedKV` executes a :func:`..plan.serving.plan_serving`
  decision: the planned layers live in pinned host memory between their
  uses.  Layer ``j+1``'s block is prefetched on a side stream while layer
  ``j`` runs; the compute stream waits on its event before the layer reads
  it, and copies it back (``Foff``) behind the layer.  At most two staged
  blocks are on the card at once: before a prefetch allocates, the host
  waits for the previous write-back to land and frees its block.
- :class:`LRUKV` is the baseline the planner must beat: at most
  ``budget_bytes`` of blocks on the card under per-access LRU.  It fetches
  only on demand, synchronously (nothing moves ahead of need), so with a
  budget short of the whole cache every access misses in a cyclic scan.

The byte, stall, hit and miss counts are the JAX package's, event for
event: they come from the link model
(:class:`..core.chain.HostTransferModel`), with the planned policy's
transfers credited against the step's wall clock as the reference credits
them.  Beside them each run reports what its copies moved
(``kv_copied_bytes``: the booked transfers, and for the planned policy the
write-back behind the last step, which the reference does not book) and
its measured wait (``kv_wait_s``): on CUDA the compute stream's wait on
prefetches (CUDA events), the host's wait on write-backs and the demand
copies (host clock); elsewhere the copies are host↔host clones and the
modeled times are the ones that mean anything.

Each booked transfer adds its bytes to the ``serve.kv_transfer_bytes``
counter, and each run's modeled stall lands in the
``serve.kv_stall_seconds`` histogram (:mod:`repro_torch.obs.metrics`);
with a tracer, each booked transfer is also a ``Foff``/``Prefetch`` span of
its modeled length, as the JAX package records it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from ..core.chain import HostTransferModel
from ..obs import metrics as obs_metrics
from ..offload.host_buffer import HostBuffer


class _KVStager:
    """Shared mechanics: park one layer's block in the host pool and
    release its device tensors, bring it back; the modeled accounting."""

    policy = "base"

    def __init__(self, model, layout, link: HostTransferModel,
                 buffer: Optional[HostBuffer] = None, tracer=None):
        self.model = model
        self.layout = layout
        self.link = link
        self.buffer = buffer if buffer is not None else HostBuffer(None)
        self.tracer = tracer
        self.offload_bytes = 0.0
        self.prefetch_bytes = 0.0
        self.stall_s = 0.0
        self.wait_s = 0.0           # the measured wait (see the docstring)
        self.copied_bytes = 0       # what the copies moved, both ways
        self._host: Dict[int, List[Dict[str, torch.Tensor]]] = {}
        self._side = None

    # -- physical block movement ------------------------------------------

    def _host_copy(self, j: int, blocks) -> List[Dict[str, torch.Tensor]]:
        """Layer ``j``'s host tensors, pinned on CUDA, allocated once."""
        if j not in self._host:
            self._host[j] = [{k: torch.empty(
                t.shape, dtype=t.dtype, device="cpu",
                pin_memory=t.is_cuda) for k, t in d.items()} for d in blocks]
        return self._host[j]

    def _store(self, cache: Dict, j: int, stream=None) -> Optional[Any]:
        """Copy layer ``j``'s block to the host pool (on ``stream``, after
        the compute stream's work so far) and take it out of the cache.
        Returns ``(event, device tensors)`` for an asynchronous copy: the
        caller holds the tensors until the event has passed."""
        blocks = self.model.cache_block(cache, j)
        host = self._host_copy(j, blocks)
        dev = [t for d in blocks for t in d.values()]
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for h, d in zip(host, blocks):
                    for k, t in d.items():
                        h[k].copy_(t, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
        else:
            for h, d in zip(host, blocks):
                for k, t in d.items():
                    h[k].copy_(t)
            ev = None
        self.buffer.put(("kv", j), host, nbytes=self.layout.block_bytes[j],
                        evict=True)
        self.copied_bytes += self.layout.block_bytes[j]
        for d in blocks:
            for k in d:
                d[k] = None
        return None if ev is None else (ev, dev)

    def _fetch(self, cache: Dict, j: int, stream=None):
        """Copy layer ``j``'s block back from the host pool into new device
        tensors (on ``stream``); returns ``(event or None, tensors)`` —
        installed in the cache by :meth:`_install`."""
        host = self.buffer.get(("kv", j))
        if host is None:
            raise RuntimeError(
                f"host pool no longer holds the KV block for layer {j} — "
                f"its capacity evicted a planned entry; size the HostBuffer "
                f"to hold every host-resident layer")
        self.copied_bytes += self.layout.block_bytes[j]
        device = self._device
        new = [{k: torch.empty(t.shape, dtype=t.dtype, device=device)
                for k, t in h.items()} for h in host]
        if stream is None:
            for n, h in zip(new, host):
                for k, t in h.items():
                    n[k].copy_(t)
            return None, new
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for n, h in zip(new, host):
                for k, t in h.items():
                    n[k].copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        return ev, new

    def _install(self, cache: Dict, j: int, new) -> None:
        for d, n in zip(self.model.cache_block(cache, j), new):
            d.update(n)

    def bind(self, cache: Dict) -> None:
        """Learn the cache's device."""
        self._device = next(iter(cache["layers"][0].values())).device

    # -- accounting --------------------------------------------------------

    def _count(self, direction: str, j: int, stall: bool) -> float:
        b = self.layout.block_bytes[j]
        if direction == "offload":
            self.offload_bytes += b
            t = self.link.offload_time(b)
        else:
            self.prefetch_bytes += b
            t = self.link.prefetch_time(b)
        obs_metrics.counter("serve.kv_transfer_bytes").inc(b)
        if stall:
            self.stall_s += t
        if self.tracer is not None and self.tracer.enabled:
            now = self.tracer.now()
            op = "Foff" if direction == "offload" else "Prefetch"
            self.tracer.record(op, j + 1, now, now + t, bytes=b,
                               extra={"modeled": True})
        return t

    def result_stats(self) -> Dict[str, Any]:
        obs_metrics.histogram("serve.kv_stall_seconds").observe(self.stall_s)
        return {
            "kv_policy": self.policy,
            "kv_offload_bytes": self.offload_bytes,
            "kv_prefetch_bytes": self.prefetch_bytes,
            "kv_transfer_bytes": self.offload_bytes + self.prefetch_bytes,
            "kv_stall_s": self.stall_s,
            "kv_wait_s": self.wait_s,
            "kv_copied_bytes": self.copied_bytes,
        }

    # -- the serve loop's hooks (no-ops unless a policy overrides them) -----

    def begin_step(self, cache: Dict) -> None:
        pass

    def before_layer(self, cache: Dict, j: int) -> None:
        pass

    def after_layer(self, cache: Dict, j: int) -> None:
        pass

    def end_step(self, cache: Dict, step_wall_s: float = 0.0) -> None:
        pass

    def settle(self) -> None:
        """Let the copies in flight land and free what they held (between
        steps)."""

    def finish(self) -> None:
        self.settle()


class PlannedKV(_KVStager):
    """Execute a planned residency set: the layers in ``host_layers`` live
    in host RAM between steps, prefetched ahead of their layer and written
    back behind it.  Modeled transfers overlap the step's compute; only the
    excess beyond the step's wall clock is booked as stall."""

    policy = "planned"

    def __init__(self, model, layout, host_layers: List[int],
                 link: HostTransferModel,
                 buffer: Optional[HostBuffer] = None, tracer=None):
        super().__init__(model, layout, link, buffer, tracer)
        self.host_layers = sorted(host_layers)
        self._staged = set(self.host_layers)
        self._inflight: Dict[int, Any] = {}   # j -> (event, tensors)
        self._writing: List[Any] = []         # (event, tensors) write-backs
        self._waits: List[Any] = []           # CUDA event pairs

    def settle(self) -> None:
        """Wait for the pending write-backs and free their device blocks."""
        if self._writing:
            t0 = time.perf_counter()
            for ev, _ in self._writing:
                ev.synchronize()
            self.wait_s += time.perf_counter() - t0
            self._writing.clear()

    def _prefetch(self, cache: Dict, j: int) -> None:
        self.settle()
        self._inflight[j] = self._fetch(cache, j, self._side)

    def stage_initial(self, cache: Dict) -> None:
        """Move the planned set to host right after prefill (off the decode
        critical path: no stall booked)."""
        self.bind(cache)
        if self._device.type == "cuda":
            self._side = torch.cuda.Stream(self._device)
        for j in self.host_layers:
            pending = self._store(cache, j, self._side)
            if pending is not None:
                self._writing.append(pending)
            self._count("offload", j, stall=False)
        self.settle()

    def begin_step(self, cache: Dict) -> None:
        """Book the prefetch of the planned set for this step (its time is
        reconciled against the step's wall in :meth:`end_step`)."""
        for j in self.host_layers:
            self._count("prefetch", j, stall=False)

    def before_layer(self, cache: Dict, j: int) -> None:
        if j in self._staged:
            if j not in self._inflight:
                self._prefetch(cache, j)
            ev, new = self._inflight.pop(j)
            if ev is not None:
                compute = torch.cuda.current_stream()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record(compute)
                compute.wait_event(ev)
                t1.record(compute)
                self._waits.append((t0, t1))
            self._install(cache, j, new)
        if j + 1 in self._staged:
            self._prefetch(cache, j + 1)

    def after_layer(self, cache: Dict, j: int) -> None:
        """Write the block back behind its layer — also after the last step,
        which books no write-back (nothing follows it) but must not leave
        the blocks on the card."""
        if j in self._staged:
            pending = self._store(cache, j, self._side)
            if pending is not None:
                self._writing.append(pending)

    def end_step(self, cache: Dict, step_wall_s: float = 0.0) -> None:
        """Book the write-back of the planned set; the round trip (this
        write-back and the next prefetch) overlaps the next step's compute,
        and its time beyond ``step_wall_s`` is booked as stall."""
        t = 0.0
        for j in self.host_layers:
            t += self._count("offload", j, stall=False)
            t += self.link.prefetch_time(self.layout.block_bytes[j])
        self.stall_s += max(0.0, t - step_wall_s)

    def finish(self) -> None:
        super().finish()
        if self._waits:
            self._waits[-1][1].synchronize()
            self.wait_s += sum(a.elapsed_time(b) for a, b in self._waits) / 1e3
            self._waits.clear()

    def result_stats(self) -> Dict[str, Any]:
        out = super().result_stats()
        out["kv_host_layers"] = list(self.host_layers)
        return out


class LRUKV(_KVStager):
    """Baseline: the card holds at most ``budget_bytes`` of KV blocks under
    per-access LRU, touched in layer order every step; a miss fetches the
    block on demand, synchronously, after evicting (writing back) the least
    recently used blocks until it fits, and both copies stall the step."""

    policy = "lru"

    def __init__(self, model, layout, budget_bytes: float,
                 link: HostTransferModel,
                 buffer: Optional[HostBuffer] = None, tracer=None):
        super().__init__(model, layout, link, buffer, tracer)
        self.budget_bytes = float(budget_bytes)
        self._resident: List[int] = []   # first = least recently used
        self.hits = 0
        self.misses = 0

    def _resident_bytes(self) -> float:
        return float(sum(self.layout.block_bytes[j] for j in self._resident))

    def _sync_copy(self, fn) -> Any:
        t0 = time.perf_counter()
        out = fn()
        if self._device.type == "cuda":
            torch.cuda.current_stream().synchronize()
        self.wait_s += time.perf_counter() - t0
        return out

    def _evict_to_fit(self, cache: Dict, incoming: float,
                      stall: bool) -> None:
        while (self._resident
               and self._resident_bytes() + incoming > self.budget_bytes):
            k = self._resident.pop(0)
            self._count("offload", k, stall=stall)
            self._sync_copy(lambda: self._store(cache, k))

    def stage_initial(self, cache: Dict) -> None:
        """After prefill every block is on the card; evict coldest-first
        (layer 0 was filled first) down to the budget, off the critical
        path (no stall booked)."""
        self.bind(cache)
        self._resident = list(range(len(self.layout.block_bytes)))
        self._evict_to_fit(cache, 0.0, stall=False)

    def before_layer(self, cache: Dict, j: int) -> None:
        if j in self._resident:
            self.hits += 1
            self._resident.remove(j)
            self._resident.append(j)     # refresh recency
            return
        self.misses += 1
        self._evict_to_fit(cache, self.layout.block_bytes[j], stall=True)
        self._count("prefetch", j, stall=True)
        self._install(cache, j, self._sync_copy(
            lambda: self._fetch(cache, j))[1])
        self._resident.append(j)

    def result_stats(self) -> Dict[str, Any]:
        out = super().result_stats()
        out["kv_lru_hits"] = self.hits
        out["kv_lru_misses"] = self.misses
        out["kv_budget_bytes"] = self.budget_bytes
        return out
