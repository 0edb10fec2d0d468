"""Process-wide metrics registry: counters, gauges, histograms — the port
of ``repro.obs.metrics``, with the same JSON snapshot schema.

The port's seams report here: the host buffer's pinned-pool occupancy and
evictions (``host_buffer.*``), the offload walker's prefetch waits
(``offload.prefetch_stall_seconds``), the train loop's step time and loss
(``train.*``) and the serve loop's KV residency (``serve.kv_bytes`` is the
cache's *logical* size at its position, ``serve.kv_bytes_allocated`` the
padded allocation, ``serve.decode_tokens`` live tokens only, and the
KV-residency policies add ``serve.kv_transfer_bytes`` /
``serve.kv_stall_seconds``).  The kernel launch counts that prove a path
went through the hand-written kernels stay in :mod:`repro_torch.counters`.

Usage::

    from repro_torch.obs import metrics
    metrics.counter("host_buffer.evictions").inc()
    metrics.gauge("host_buffer.bytes_in_use").set(pool.bytes_in_use)
    with metrics.histogram("train.step_seconds").time():
        step()
    snap = metrics.snapshot()          # JSON-serializable dict

All operations are thread-safe and O(1); a disabled registry (env
``REPRO_METRICS=0``) turns every operation into a no-op so instrumented
loops pay only an attribute check.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

_FALSEY = {"0", "off", "false", "no"}


class Counter:
    """Monotonically increasing count (plus a value sum for byte counters)."""

    __slots__ = ("name", "count", "total", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.count += 1
            self.total += n

    @property
    def value(self) -> float:
        return self.total

    def to_json(self) -> Dict[str, Any]:
        return {"type": "counter", "count": self.count, "total": self.total}


class Gauge:
    """Last-write-wins value, tracking its max over the process lifetime."""

    __slots__ = ("name", "value", "max", "updates", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.max = 0.0
        self.updates = 0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            self.max = max(self.max, self.value)
            self.updates += 1

    def to_json(self) -> Dict[str, Any]:
        return {
            "type": "gauge",
            "value": self.value,
            "max": self.max,
            "updates": self.updates,
        }


class Histogram:
    """Streaming summary of observed samples: count / sum / min / max / last.

    No buckets — the consumers here want wall-time aggregates, not
    percentiles, and a fixed-size summary keeps ``observe`` allocation-free.
    """

    __slots__ = ("name", "count", "total", "min", "max", "last", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self.last = v

    def time(self) -> "_Timer":
        """Context manager observing the block's wall time in seconds."""
        return _Timer(self)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "type": "histogram",
            "count": self.count,
            "total": self.total,
            "mean": self.mean,
            "last": self.last,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.perf_counter() - self._t0)


class _Noop:
    """Stands in for any metric when the registry is disabled."""

    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def time(self) -> "_NoopTimer":
        return _NOOP_TIMER


class _NoopTimer:
    __slots__ = ()

    def __enter__(self) -> "_NoopTimer":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP = _Noop()
_NOOP_TIMER = _NoopTimer()


class MetricsRegistry:
    """Thread-safe name → metric map with a JSON snapshot."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            flag = os.environ.get("REPRO_METRICS", "1").strip().lower()
            enabled = flag not in _FALSEY
        self.enabled = enabled
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls):
        if not self.enabled:
            return _NOOP
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def get(self, name: str):
        """The registered metric, or ``None`` (never creates)."""
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default: float = 0.0) -> float:
        """Scalar reading of a metric: counter count, gauge value,
        histogram count; ``default`` when absent."""
        m = self.get(name)
        if m is None:
            return default
        if isinstance(m, Counter):
            return m.count
        if isinstance(m, Gauge):
            return m.value
        return m.count

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable dump of every registered metric."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.to_json() for name, m in items}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def reset(self) -> None:
        """Drop every registered metric (tests / bench isolation)."""
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# process-wide default registry
# ---------------------------------------------------------------------------

_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def registry() -> MetricsRegistry:
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def reset() -> None:
    """Drop the process-wide registry; the next use rebuilds from the env."""
    global _default
    with _default_lock:
        _default = None


def counter(name: str) -> Counter:
    return registry().counter(name)


def gauge(name: str) -> Gauge:
    return registry().gauge(name)


def histogram(name: str) -> Histogram:
    return registry().histogram(name)


def value(name: str, default: float = 0.0) -> float:
    return registry().value(name, default)


def snapshot() -> Dict[str, Any]:
    return registry().snapshot()


def save(path: str) -> None:
    registry().save(path)
