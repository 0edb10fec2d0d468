"""Host-RAM pool for offloaded activations and staged KV blocks (the port of
``repro.offload.host_buffer``).

The walker parks activation copies here between ``F_off`` and ``Prefetch``;
on CUDA it allocates them in pinned host memory, which is what lets the
copies run asynchronously.  Entries are accounted byte-exactly.  Checkpoint
copies are precious — losing one would force a recompute the solver never
planned — so by default an insert that would overflow ``capacity_bytes``
raises.  The serving path's KV stagers (:mod:`..runtime.kv_residency`) put
with ``evict=True``: the least recently touched entries make room, and a
planned block that was evicted is found missing at restore time.

Every change of occupancy is mirrored into the process metrics: the gauge
``host_buffer.bytes_in_use`` (its ``max`` is the high-water mark across
buffers) and the counter ``host_buffer.evictions``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, List, Optional, Tuple

from ..obs import metrics


@dataclasses.dataclass
class HostBufferStats:
    puts: int = 0
    gets: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    evicted_bytes: int = 0
    peak_bytes: int = 0


class HostBuffer:
    """Keyed, byte-accounted pool with opt-in LRU eviction;
    ``capacity_bytes=None`` is unbounded."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.capacity_bytes = capacity_bytes
        self._entries: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.stats = HostBufferStats()

    @property
    def bytes_in_use(self) -> int:
        return self._bytes

    @property
    def peak_bytes(self) -> int:
        return self.stats.peak_bytes

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, key, value, nbytes: int, evict: bool = False) -> List[Any]:
        """Insert (or replace) an entry of ``nbytes``; returns the keys
        evicted to fit.  Without ``evict`` an insert that would overflow the
        capacity raises ``MemoryError``."""
        size = int(nbytes)
        self.stats.puts += 1
        if key in self._entries:
            self._bytes -= self._entries.pop(key)[1]
        evicted: List[Any] = []
        if self.capacity_bytes is not None:
            if size > self.capacity_bytes:
                raise MemoryError(
                    f"host buffer: entry of {size} B exceeds capacity "
                    f"{self.capacity_bytes} B")
            while self._bytes + size > self.capacity_bytes:
                if not evict:
                    raise MemoryError(
                        f"host buffer: {size} B put overflows capacity "
                        f"{self.capacity_bytes} B ({self._bytes} B in use)")
                old_key, (_, old_size) = self._entries.popitem(last=False)
                self._bytes -= old_size
                self.stats.evictions += 1
                self.stats.evicted_bytes += old_size
                evicted.append(old_key)
        self._entries[key] = (value, size)
        self._bytes += size
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._bytes)
        if evicted:
            metrics.counter("host_buffer.evictions").inc(len(evicted))
        self._publish()
        return evicted

    def get(self, key, default=None):
        """Fetch without removing; refreshes the entry's LRU recency."""
        self.stats.gets += 1
        if key not in self._entries:
            self.stats.misses += 1
            return default
        self.stats.hits += 1
        self._entries.move_to_end(key)
        return self._entries[key][0]

    def pop(self, key):
        """Fetch and release the entry's bytes (the Prefetch path)."""
        if key not in self._entries:
            raise KeyError(f"host buffer: no entry {key!r}")
        value, size = self._entries.pop(key)
        self._bytes -= size
        self._publish()
        return value

    def _publish(self) -> None:
        metrics.gauge("host_buffer.bytes_in_use").set(self._bytes)
