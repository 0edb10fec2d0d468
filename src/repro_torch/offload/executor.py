"""Eager op walker for (offload-bearing) schedules — the port of
``repro.offload.executor``: it runs the op sequence literally.

- ``F_all^l``  → the stage under ``torch.enable_grad()`` on a detached copy
  of its input that requires grad; ``(output, input)`` is ``ā^l`` (autograd
  keeps the residuals).
- ``F_ck^l`` / ``F_∅^l`` → the stage under ``torch.no_grad()``; ``F_∅``
  drops its input.
- ``B^l``      → ``torch.autograd.grad(output, [input, *params], δ^l)``,
  seeded through ``core.planner.seeded`` so that δ^l and an output the
  stage did not save die as autograd is done with them, as the measured
  ``ob`` counts them; parameter gradients accumulate, the input gradient
  is ``δ^{l-1}``.
- ``F_off^i``  → on CUDA, a copy of ``a^i`` into pinned host memory with
  ``non_blocking=True`` on a side stream, so it overlaps the compute that
  follows (as the simulator assumes); elsewhere a ``.clone()`` into fresh
  CPU storage.  The device copy stays for the following ``F_∅``/``B``.
- ``Prefetch^i`` → the host copy back to the device on the side stream; the
  compute stream waits on that copy's event, so the prefetch is charged in
  full, as the simulator charges it.  The wait is measured with CUDA events
  (the host clock off CUDA).

The host copies live in a :class:`~repro_torch.offload.host_buffer.HostBuffer`;
pass one in to bound host memory or read its byte-exact peak.

On CUDA, asked for ``stats``, the walker also reads the allocator's peak
over each op's span and resets the counter after it.  A parameter gradient
counts from the end of the autograd node that makes it
(``core.planner.grad_with_peaks`` runs each ``B``), so the activation peak
it reports leaves out only the gradients already made, as the measured
chain's ``ob`` does.

``tracer`` (a :class:`~repro_torch.obs.trace.Tracer`, opt-in) records one
span per op, with the bytes it produced or moved.  On CUDA each span is a
timing-event pair on the stream that runs the op — the compute stream for
``F*``/``B``, the side stream for ``F_off`` (the copy) and ``Prefetch``
(from where the compute stream stood, through the wait for the ``F_off`` to
land, to the copy's end) — so no op waits for tracing; the tracer reads
the events after the step.  Off CUDA a span is the op's host-clock time.
Untraced, the walker is unchanged.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..core.planner import _fresh_input, grad_with_peaks, seeded
from ..core.schedule import BWD, F_ALL, F_CK, F_NONE, F_OFF, PREFETCH, Schedule
from ..obs import metrics
from ..tree import tensors_of, tree_bytes, tree_map, with_tensors
from .host_buffer import HostBuffer


def _float_leaves(tree: Any) -> List[torch.Tensor]:
    return [t for t in tensors_of(tree) if t.is_floating_point()]


def _unique_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _copy_into(dst: Any, src: Any) -> None:
    """Copy ``src``'s tensors into ``dst``'s, asynchronously (a function,
    so that no loop variable keeps a tensor alive after the copy)."""
    for d, t in zip(tensors_of(dst), tensors_of(src)):
        d.copy_(t, non_blocking=True)


def execute_offload_schedule(
    schedule: Schedule,
    stages: Sequence[Callable],
    params: Sequence[Any],
    x: Any,
    loss_cotangent: Optional[torch.Tensor] = None,
    track_live_bytes: bool = False,
    host_buffer: Optional[HostBuffer] = None,
    stats: Optional[dict] = None,
    tracer=None,
):
    """Run forward and backward per ``schedule``; returns ``(loss_output,
    param_grads, input_grad)`` — per-stage gradients shaped like
    ``params[l-1]``, the input gradient shaped like ``x`` (``None`` at
    non-floating leaves) — plus, with ``track_live_bytes``, the peak bytes of
    the walker's device-side saved set (activations, ``ā`` outputs and
    autograd residuals, pending gradients; parameters excluded).  ``stats``,
    if given, receives ``prefetch_wait_s`` (seconds the compute stream
    waited on prefetches) and ``prefetches``; on CUDA also ``peak_bytes``,
    the allocator's largest peak over the ops' spans, and
    ``act_peak_bytes``, the largest of each span's peak less the parameter
    gradients made by then (both absolute: the memory before the call
    included), for which the peak counter is reset at every op; the
    prefetch waits also land in the ``offload.prefetch_stall_seconds``
    histogram.  ``tracer`` records one span per op (module docstring)."""
    L = schedule.length
    hb = host_buffer if host_buffer is not None else HostBuffer()
    first = tensors_of(x)[0]
    cuda = first.is_cuda
    if cuda:
        compute = torch.cuda.current_stream(first.device)
        side = torch.cuda.Stream(first.device)
        landed: Dict[int, torch.cuda.Event] = {}
    acts: Dict[int, Any] = {0: x}          # bare a^i
    saved: Dict[int, tuple] = {}           # ā^l: (output, input, residuals)
    deltas: Dict[int, List] = {}           # δ^l, aligned with a^l's floats
    grads: List[Any] = [None] * (L + 1)
    waits: list = []
    final_out = None
    peak_live = 0
    param_ids = {t.untyped_storage().data_ptr()
                 for t in tensors_of(list(params))}
    # the allocator's peaks: the largest, and the largest less the parameter
    # gradients made by then
    peaks = {"peak": 0, "act": 0, "grads": 0}
    track_peaks = cuda and stats is not None
    if track_peaks:
        torch.cuda.reset_peak_memory_stats(first.device)

    def get_act(i: int):
        if i in acts:
            return acts[i]
        if i in saved:                     # a^i readable from ā^i
            return saved[i][0]
        raise RuntimeError(f"a^{i} not available — invalid schedule")

    rec = tracer is not None and tracer.enabled
    for kind, l in schedule.ops:
        # the stream the op runs on, for its span (None: the host clock)
        stream = (side if kind in (F_OFF, PREFETCH) else compute) \
            if cuda else None
        moved = None                       # bytes the op produced or moved
        if rec and kind not in (F_OFF, PREFETCH):
            mark = tracer.begin(stream)
        if kind == F_OFF:
            i = int(l)
            if i not in acts:
                raise RuntimeError(f"Foff: a^{i} not live as a bare "
                                   f"activation")
            if cuda:
                side.wait_stream(compute)
                if rec:
                    mark = tracer.begin(side)
                with torch.cuda.stream(side):
                    def to_host(t):
                        if not isinstance(t, torch.Tensor):
                            return t
                        h = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                        h.copy_(t, non_blocking=True)
                        t.record_stream(side)
                        return h
                    host = tree_map(to_host, acts[i])
                landed[i] = torch.cuda.Event()
                landed[i].record(side)
            else:
                if rec:
                    mark = tracer.begin()
                host = tree_map(lambda t: t.clone()
                                if isinstance(t, torch.Tensor) else t,
                                acts[i])
            moved = tree_bytes(host)
            if rec:
                tracer.end(mark, kind, i, stream, bytes=moved,
                           host_mem=float(hb.bytes_in_use + moved))
            hb.put(i, host, nbytes=moved)
            del host
        elif kind == PREFETCH:
            i = int(l)
            if i in acts:
                raise RuntimeError(f"Prefetch: a^{i} already on device")
            host = hb.pop(i)
            if cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record(compute)
                # destinations are allocated on the compute stream, so the
                # copy waits for it (memory it recycles may still be read)
                dst = tree_map(
                    lambda t: torch.empty_like(t, device=first.device)
                    if isinstance(t, torch.Tensor) else t, host)
                side.wait_stream(compute)
                if rec:
                    mark = tracer.begin(side)
                side.wait_event(landed.pop(i))
                with torch.cuda.stream(side):
                    _copy_into(dst, host)
                if rec:
                    tracer.end(mark, kind, i, side, bytes=tree_bytes(host),
                               host_mem=float(hb.bytes_in_use))
                done = torch.cuda.Event()
                done.record(side)
                compute.wait_event(done)
                t1.record(compute)
                waits.append((t0, t1))
                acts[i] = dst
                del dst
            else:
                if rec:
                    mark = tracer.begin()
                t0 = time.perf_counter()
                acts[i] = host
                waits.append(time.perf_counter() - t0)
                if rec:
                    tracer.end(mark, kind, i, bytes=tree_bytes(host),
                               host_mem=float(hb.bytes_in_use))
            del host
        elif kind in (F_NONE, F_CK, F_ALL):
            a_in = get_act(l - 1)
            if kind == F_ALL:
                inp = _fresh_input(a_in)
                res: list = []
                with torch.enable_grad():
                    if track_live_bytes:
                        with torch.autograd.graph.saved_tensors_hooks(
                                lambda t: res.append(t) or t, lambda t: t):
                            out = stages[l - 1](params[l - 1], inp)
                    else:
                        out = stages[l - 1](params[l - 1], inp)
                saved[l] = (out, inp, res)
            else:
                with torch.no_grad():
                    out = stages[l - 1](params[l - 1], a_in)
                acts[l] = out
            if l == L + 1:
                # the value only: the loss's graph would keep its
                # AccumulateGrad nodes, so the head's input, alive
                final_out = tree_map(lambda t: t.detach()
                                     if isinstance(t, torch.Tensor) else t,
                                     out)
            if kind == F_NONE:
                acts.pop(l - 1, None)
            if rec:
                moved = tree_bytes(out)
            del a_in, out
        elif kind == BWD:
            out, inp, _ = saved.pop(l)
            outs = _float_leaves(out)
            if l == L + 1:
                delta = ([loss_cotangent] if loss_cotangent is not None
                         else [torch.ones_like(o) for o in outs])
            else:
                delta = deltas.pop(l)
            pairs = [(o, g) for o, g in zip(outs, delta) if o.requires_grad]
            ins = _float_leaves(inp)
            ps = tensors_of(params[l - 1])
            # δ^l and an unsaved a^l die as autograd is done with them
            seed = seeded([o for o, _ in pairs], [g for _, g in pairs])
            del out, outs, delta, pairs
            if track_peaks:
                got, peak, act = grad_with_peaks([seed], ins + ps, None,
                                                 params=ps,
                                                 allow_unused=True)
            else:
                got = torch.autograd.grad([seed], ins + ps,
                                          allow_unused=True)
            got = [torch.zeros_like(t) if g is None else g
                   for t, g in zip(ins + ps, got)]
            dps = got[len(ins):]
            if grads[l - 1] is not None:
                dps = [a + b for a, b in zip(tensors_of(grads[l - 1]), dps)]
            grads[l - 1] = with_tensors(params[l - 1], dps)
            deltas[l - 1] = got[:len(ins)]
            acts.pop(l - 1, None)          # B^l consumes a^{l-1}
            # B^l's seed holds its graph, whose AccumulateGrad nodes hold
            # the input leaves: drop it before the next op
            del seed, inp, ins, got
        else:
            raise ValueError(f"offload executor cannot run op kind {kind}")
        if track_peaks:
            if kind != BWD:
                peak = act = torch.cuda.max_memory_allocated(first.device)
            peaks["peak"] = max(peaks["peak"], peak)
            peaks["act"] = max(peaks["act"], act - peaks["grads"])
            if kind == BWD:       # stage l-1's gradients exist from here
                peaks["grads"] += tree_bytes(dps)
            torch.cuda.reset_peak_memory_stats(first.device)
        live = None
        if track_live_bytes:
            live = tensors_of([acts, deltas]) + [
                t for o, i_, r in saved.values()
                for t in tensors_of([o, i_]) + r]
            live = _unique_bytes(
                t for t in live
                if t.untyped_storage().data_ptr() not in param_ids)
            peak_live = max(peak_live, live)
        if rec and kind not in (F_OFF, PREFETCH):
            tracer.end(mark, kind, int(l), stream, bytes=moved,
                       device_mem=None if live is None else float(live))

    if 0 not in deltas:
        raise RuntimeError("schedule did not produce δ^0")
    if stats is not None:
        if cuda and waits:
            waits[-1][1].synchronize()
            waits = [a.elapsed_time(b) / 1e3 for a, b in waits]
        stall = metrics.histogram("offload.prefetch_stall_seconds")
        for w in waits:
            stall.observe(w)
        stats["prefetch_wait_s"] = float(sum(waits))
        stats["prefetches"] = len(waits)
        if track_peaks:
            stats["peak_bytes"] = peaks["peak"]
            stats["act_peak_bytes"] = peaks["act"]
    dx = with_tensors(x, deltas[0], floating_only=True)
    if track_live_bytes:
        return final_out, grads, dx, peak_live
    return final_out, grads, dx
