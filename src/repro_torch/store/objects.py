"""Typed object access over a byte :class:`~repro_torch.store.backend.Backend`.

:class:`ObjectStore` is the layer every caller actually uses: it runs the
:mod:`repro_torch.store.codec` envelope on the way in and out, quarantines
corrupted entries on first contact (so a bad byte range on a shared
directory is served exactly once, to exactly one process, as a miss), and
mirrors every outcome into the :mod:`repro_torch.obs` metrics registry
(``store.hits`` / ``store.misses`` / ``store.puts`` /
``store.corrupt_quarantined`` / ``store.errors``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..obs import metrics as _metrics

from .backend import Backend, StoreError
from .codec import CorruptEntryError, decode, encode


class ObjectStore:
    """Envelope-checked, metrics-instrumented object store."""

    def __init__(self, backend: Backend, *, name: str = "store"):
        self.backend = backend
        self.name = name
        self._lock = threading.Lock()
        self._stats: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "puts": 0,
            "corrupt": 0,
            "errors": 0,
        }

    def _bump(self, stat: str, metric: str) -> None:
        with self._lock:
            self._stats[stat] += 1
        _metrics.counter(f"{self.name}.{metric}").inc()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def reset_stats(self) -> None:
        with self._lock:
            for k in self._stats:
                self._stats[k] = 0

    def get(self, key: str, *, kind: Optional[str] = None) -> Optional[Any]:
        """The stored object, or None on miss.  A corrupted / tampered /
        wrong-kind entry is quarantined and reported as a miss."""
        try:
            data = self.backend.get(key)
        except StoreError:
            self._bump("errors", "errors")
            return None
        if data is None:
            self._bump("misses", "misses")
            return None
        try:
            _, _, obj = decode(data, kind=kind, key=key)
        except CorruptEntryError:
            self.backend.quarantine(key)
            self._bump("corrupt", "corrupt_quarantined")
            self._bump("misses", "misses")
            return None
        self._bump("hits", "hits")
        return obj

    def put(self, key: str, obj: Any, *, kind: str = "object") -> bool:
        """Store an object; False (and a ``store.errors`` tick) when the
        backend cannot take the write."""
        data = encode(kind, key, obj)
        try:
            self.backend.put(key, data)
        except StoreError:
            self._bump("errors", "errors")
            return False
        self._bump("puts", "puts")
        return True

    def delete(self, key: str) -> bool:
        return self.backend.delete(key)

    def keys(self, prefix: str = "") -> List[str]:
        return self.backend.keys(prefix)

    def clear(self, prefix: str = "") -> None:
        self.backend.clear(prefix)

    def uri(self) -> str:
        return self.backend.uri()
