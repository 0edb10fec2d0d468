"""Span recorder for planned execution — the port of ``repro.obs.trace``.

The op walker (:func:`repro_torch.offload.executor.execute_offload_schedule`,
reached through ``MemoryPlan.execute`` and a traced ``MemoryPlan.bind``)
emits one :class:`Span` per schedule op into a :class:`Tracer`: op kind
(``Fall``/``Fck``/``Fnone``/``B``/``Foff``/``Prefetch``, plus ``Decode``
and ``Step`` from the serve and train loops), op index, bytes moved or
produced where cheap to know, and its time.  The exporters are the JAX
package's: :meth:`Tracer.to_perfetto` (Chrome/Perfetto ``trace.json``, one
complete ``"X"`` event per span, one track per category) and
:meth:`Tracer.to_timeline` (the ``MemoryPlan.timeline`` schema, so a
measured timeline sits beside the simulator's and feeds
:mod:`repro_torch.obs.drift`).

Where the port differs: the JAX tracer fences every op with
``jax.block_until_ready`` (and swallows any error the fence raises).  On
CUDA that would be a ``torch.cuda.synchronize`` per op, which serializes
the walker's side-stream copies with compute and hides the very overlap a
trace is for.  Here an op on a CUDA stream is bracketed by a
``torch.cuda.Event(enable_timing=True)`` pair recorded on the stream that
runs it (:meth:`Tracer.begin` / :meth:`Tracer.end`): the compute stream for
``F*``/``B``, the side stream for ``Foff``/``Prefetch``.  Nothing waits
while the step runs; the pairs are resolved together the first time
:attr:`Tracer.spans` is read after them (the host waits for their end
events then), against one epoch event, into seconds on the tracer's
clock.  Off CUDA (``stream=None``) a span is read on the host clock,
``time.perf_counter`` seconds from the tracer's epoch.

Because spans on two streams overlap, :meth:`Tracer.to_perfetto` emits the
events in start-time order (the Chrome format wants them so, and both
packages' :func:`validate_perfetto` check it); :attr:`Tracer.spans` keeps
the order the ops ran in.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: span categories, used as Perfetto track (tid) names
CAT_FORWARD = "forward"
CAT_BACKWARD = "backward"
CAT_TRANSFER = "transfer"
CAT_STEP = "step"
CAT_DECODE = "decode"

#: track order in the Perfetto export ("misc" catches unknown op kinds)
_CATEGORIES = (CAT_FORWARD, CAT_BACKWARD, CAT_TRANSFER, CAT_STEP, CAT_DECODE)

_OP_CATEGORY = {
    "Fall": CAT_FORWARD,
    "Fck": CAT_FORWARD,
    "Fnone": CAT_FORWARD,
    "B": CAT_BACKWARD,
    "Foff": CAT_TRANSFER,
    "Prefetch": CAT_TRANSFER,
    "Step": CAT_STEP,
    "Decode": CAT_DECODE,
}


def category_of(op: str) -> str:
    return _OP_CATEGORY.get(op, "misc")


@dataclasses.dataclass
class Span:
    """One timed operation: ``[t_start, t_end]`` in tracer-epoch seconds."""

    op: str  # op kind (Fall/Fck/Fnone/B/Foff/Prefetch/...)
    arg: Any  # op index (stage l or activation i)
    t_start: float
    t_end: float
    bytes: Optional[int] = None  # bytes produced/moved, when known
    device_mem: Optional[float] = None
    host_mem: Optional[float] = None
    extra: Optional[Dict[str, Any]] = None

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def category(self) -> str:
        return category_of(self.op)


class Tracer:
    """Append-only span recorder with Perfetto / timeline exporters.

    ``enabled=False`` makes every call a no-op, so call sites can thread
    one tracer object unconditionally."""

    def __init__(self, enabled: bool = True, name: str = "repro"):
        self.enabled = enabled
        self.name = name
        self._spans: List[Span] = []
        # CUDA spans waiting for their events: (span, start event, end event)
        self._pending: List[Tuple[Span, Any, Any]] = []
        self._epoch = time.perf_counter()
        self._epoch_event = None      # the CUDA epoch, recorded at first use
        self._epoch_event_t = 0.0     # its host-clock reading

    # -- recording ---------------------------------------------------------

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def record(self, op: str, arg: Any, t_start: float, t_end: float,
               **kw) -> None:
        """Append a span with explicit epoch-relative times."""
        if not self.enabled:
            return
        self._spans.append(Span(op, arg, t_start, t_end, **kw))

    def begin(self, stream=None):
        """Mark the start of an op: a timing event recorded on ``stream``
        (a ``torch.cuda.Stream``), or the host clock with ``stream=None``.
        Pass the mark to :meth:`end`."""
        if not self.enabled:
            return None
        if stream is None:
            return self.now()
        import torch

        if self._epoch_event is None:
            self._epoch_event = torch.cuda.Event(enable_timing=True)
            self._epoch_event.record(stream)
            self._epoch_event_t = self.now()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def end(self, mark, op: str, arg: Any, stream=None, **kw) -> None:
        """Close the op opened by ``mark`` (:meth:`begin` on the same
        ``stream``) as one span.  On a CUDA stream the span's times are
        filled in when :attr:`spans` is next read."""
        if not self.enabled:
            return
        if stream is None:
            self.record(op, arg, mark, self.now(), **kw)
            return
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        span = Span(op, arg, float("nan"), float("nan"), **kw)
        self._spans.append(span)
        self._pending.append((span, mark, ev))

    def resolve(self) -> None:
        """Fill in the pending CUDA spans: wait for each end event, then read
        both events against the epoch event."""
        if not self._pending:
            return
        epoch, t0 = self._epoch_event, self._epoch_event_t
        for span, start, stop in self._pending:
            stop.synchronize()
            span.t_start = t0 + epoch.elapsed_time(start) / 1e3
            span.t_end = t0 + epoch.elapsed_time(stop) / 1e3
        self._pending.clear()

    @property
    def spans(self) -> List[Span]:
        """The recorded spans in the order they were opened (pending CUDA
        spans resolved first)."""
        self.resolve()
        return self._spans

    def __len__(self) -> int:
        return len(self._spans)

    # -- exporters ---------------------------------------------------------

    def to_perfetto(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: one complete ("X") event per span, with
        microsecond timestamps, grouped into one named track per category,
        in start-time order."""
        tids = {}
        events: List[Dict[str, Any]] = []
        for cat in _CATEGORIES + ("misc",):
            tids[cat] = len(tids) + 1
        for cat, tid in tids.items():
            meta = {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid}
            meta["args"] = {"name": cat}
            events.append(meta)
        for s in sorted(self.spans, key=lambda s: s.t_start):
            args: Dict[str, Any] = {"arg": s.arg}
            if s.bytes is not None:
                args["bytes"] = s.bytes
            if s.device_mem is not None:
                args["device_mem"] = s.device_mem
            if s.host_mem is not None:
                args["host_mem"] = s.host_mem
            if s.extra:
                args.update(s.extra)
            events.append(
                {
                    "name": f"{s.op}^{s.arg}" if s.arg is not None else s.op,
                    "cat": s.category,
                    "ph": "X",
                    "pid": 1,
                    "tid": tids.get(s.category, tids["misc"]),
                    "ts": s.t_start * 1e6,
                    "dur": max(s.duration, 0.0) * 1e6,
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tracer": self.name},
        }

    def to_timeline(self) -> List[Dict[str, Any]]:
        """The measured timeline in the ``MemoryPlan.timeline`` schema
        (memory fields are ``None`` unless the executor recorded them)."""
        return [
            {
                "op": s.op,
                "arg": s.arg,
                "t_start": s.t_start,
                "t_end": s.t_end,
                "device_mem": s.device_mem,
                "host_mem": s.host_mem,
            }
            for s in self.spans
        ]

    def save(self, path: str) -> None:
        """Write the Perfetto ``trace.json`` (load at ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_timeline(
        rows: Iterable[Dict[str, Any]], name: str = "simulator"
    ) -> "Tracer":
        """A tracer replaying a predicted timeline (``MemoryPlan.timeline``
        rows) as spans: the simulator against itself gives zero drift, and a
        predicted timeline renders through the same Perfetto exporter."""
        tr = Tracer(name=name)
        for r in rows:
            tr.record(
                r["op"],
                r["arg"],
                float(r["t_start"]),
                float(r["t_end"]),
                device_mem=r.get("device_mem"),
                host_mem=r.get("host_mem"),
            )
        return tr


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def validate_perfetto(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Validate a Perfetto trace document: returns the complete ("X")
    events, raising ``ValueError`` on an empty, malformed, or
    non-monotone trace."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome trace document (no traceEvents)")
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    if not events:
        raise ValueError("trace has no complete ('X') span events")
    last_ts = None
    for e in events:
        for key in ("name", "ts", "dur", "pid", "tid"):
            if key not in e:
                raise ValueError(f"span event missing {key!r}: {e}")
        ts, dur = float(e["ts"]), float(e["dur"])
        if dur < 0:
            raise ValueError(f"negative duration: {e}")
        if last_ts is not None and ts + 1e-9 < last_ts:
            raise ValueError(f"non-monotone span start: {ts} after {last_ts}")
        last_ts = ts
    return events


def validate_trace_file(path: str) -> int:
    """Validate a ``trace.json`` on disk; returns the span count."""
    with open(path) as f:
        doc = json.load(f)
    return len(validate_perfetto(doc))


# ---------------------------------------------------------------------------
# what a trace measures
# ---------------------------------------------------------------------------


def measured_stage_times(spans: Sequence[Span], length: int):
    """Aggregate spans into per-stage mean forward/backward times.

    Returns ``(uf, ub)`` — two float lists of length ``length + 1`` (stage
    ``l`` of the paper at index ``l - 1``, loss stage last), ``nan`` where
    the trace holds no sample — the shape :meth:`Chain.calibrate
    <repro_torch.core.chain.Chain.calibrate>` takes.  Forward samples pool
    every execution of the stage (``Fall``/``Fck``/``Fnone``, recomputes
    included); backward samples come from ``B`` spans.
    """
    n = length + 1
    fwd_sum = [0.0] * n
    fwd_cnt = [0] * n
    bwd_sum = [0.0] * n
    bwd_cnt = [0] * n
    for s in spans:
        if s.op in ("Fall", "Fck", "Fnone"):
            stage = int(s.arg)
            if 1 <= stage <= n:
                fwd_sum[stage - 1] += s.duration
                fwd_cnt[stage - 1] += 1
        elif s.op == "B":
            stage = int(s.arg)
            if 1 <= stage <= n:
                bwd_sum[stage - 1] += s.duration
                bwd_cnt[stage - 1] += 1
    nan = float("nan")
    uf = [fwd_sum[i] / fwd_cnt[i] if fwd_cnt[i] else nan for i in range(n)]
    ub = [bwd_sum[i] / bwd_cnt[i] if bwd_cnt[i] else nan for i in range(n)]
    return uf, ub


def transfer_overlap(spans: Sequence[Span]) -> Tuple[float, float]:
    """``(transfer seconds, the part of them that overlaps compute)``: the
    summed length of the ``Foff``/``Prefetch`` spans, and of their
    intersection with the union of the ``F*``/``B`` spans.  On CUDA the
    copies run on a side stream, so the second over the first is the share
    of copy time hidden behind compute."""
    compute = sorted((s.t_start, s.t_end) for s in spans
                     if s.category in (CAT_FORWARD, CAT_BACKWARD))
    merged: List[List[float]] = []
    for a, b in compute:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = covered = 0.0
    for s in spans:
        if s.category != CAT_TRANSFER:
            continue
        total += s.duration
        for a, b in merged:
            covered += max(0.0, min(b, s.t_end) - max(a, s.t_start))
    return total, covered
