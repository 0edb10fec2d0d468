"""Host-RAM pool for offloaded activations (the training part of
``repro.offload.host_buffer``: no LRU eviction, which only serving uses).

The walker parks activation copies here between ``F_off`` and ``Prefetch``;
on CUDA it allocates them in pinned host memory, which is what lets the
copies run asynchronously.  Entries are accounted byte-exactly.  Checkpoint
copies are precious — losing one would force a recompute the solver never
planned — so an insert that would overflow ``capacity_bytes`` raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class HostBuffer:
    """Keyed, byte-accounted pool; ``capacity_bytes=None`` is unbounded."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.capacity_bytes = capacity_bytes
        self._entries: Dict[Any, Tuple[Any, int]] = {}
        self._bytes = 0
        self._peak = 0

    @property
    def bytes_in_use(self) -> int:
        return self._bytes

    @property
    def peak_bytes(self) -> int:
        return self._peak

    def __contains__(self, key) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, key, value, nbytes: int) -> None:
        """Insert (or replace) an entry of ``nbytes``; raises
        ``MemoryError`` if it would overflow the capacity."""
        size = int(nbytes)
        if key in self._entries:
            self._bytes -= self._entries.pop(key)[1]
        if self.capacity_bytes is not None and \
                self._bytes + size > self.capacity_bytes:
            raise MemoryError(
                f"host buffer: {size} B put overflows capacity "
                f"{self.capacity_bytes} B ({self._bytes} B in use)")
        self._entries[key] = (value, size)
        self._bytes += size
        self._peak = max(self._peak, self._bytes)

    def pop(self, key):
        """Fetch and release the entry's bytes (the Prefetch path)."""
        if key not in self._entries:
            raise KeyError(f"host buffer: no entry {key!r}")
        value, size = self._entries.pop(key)
        self._bytes -= size
        return value
