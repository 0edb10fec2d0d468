"""Byte-level store backends: where content-addressed entries physically live.

A :class:`Backend` is a tiny key→bytes map with three implementations:

- :class:`MemoryBackend` — an in-process LRU, for tests and single-process
  services (``memory://``);
- :class:`LocalDirectoryBackend` — one file per entry under a local
  directory, written atomically (``tempfile`` + ``os.replace``) so a crash
  mid-write never leaves a torn entry (``file://<path>``);
- :class:`SharedDirectoryBackend` — the same layout on a *shared* directory
  (NFS mount, host-local cache shared by many fleet processes): writes are
  additionally fsynced (file and directory) before the atomic rename, so an
  entry observed by one process is durable for every other
  (``shared://<path>``).

Backends store opaque bytes and never deserialize anything — typed access
(and the pickle envelope) is confined to :mod:`repro_torch.store.codec` /
:class:`repro_torch.store.ObjectStore`, which is also where corrupted entries are
detected and routed to :meth:`Backend.quarantine` (directory backends move
the bad file into a ``_quarantine/`` subdirectory for forensics instead of
serving it ever again).

Keys are ``/``-separated namespace paths of ``[A-Za-z0-9._-]`` segments
(``plans/tenant-a/<digest>``); directory backends flatten ``/`` to ``__``
in filenames, so a key segment may not contain ``__``.
"""

from __future__ import annotations

import abc
import os
import re
import tempfile
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

_SEGMENT_RE = re.compile(r"^[A-Za-z0-9._-]+$")
QUARANTINE_DIR = "_quarantine"
#: Filename suffix for directory-backed entries (the payload is a pickle
#: envelope, see :mod:`repro_torch.store.codec`).
ENTRY_SUFFIX = ".pkl"


class StoreError(RuntimeError):
    """A backend operation failed (bad key, unwritable directory, ...)."""


def validate_key(key: str) -> str:
    """Reject keys that cannot round-trip through every backend."""
    if not key:
        raise StoreError("empty store key")
    for seg in key.split("/"):
        if (
            not _SEGMENT_RE.match(seg)
            or "__" in seg
            or seg.strip(".") == ""  # "." / ".." path components
        ):
            raise StoreError(
                f"bad store key {key!r}: segments must match "
                f"[A-Za-z0-9._-]+ (not all dots) and may not contain '__'"
            )
    return key


class Backend(abc.ABC):
    """Abstract byte store: the one persistence API of the repo.

    Every persistent surface (solver-cache Solutions, saved MemoryPlans,
    warm-start frontiers) goes through a Backend — there is no other
    sanctioned way to put bytes on disk and read them back.
    """

    scheme: str = ""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]:
        """The stored bytes, or None when absent/unreadable."""

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None:
        """Store bytes under ``key`` (atomic: readers see old or new)."""

    @abc.abstractmethod
    def delete(self, key: str) -> bool:
        """Remove an entry; True if it existed."""

    @abc.abstractmethod
    def keys(self, prefix: str = "") -> List[str]:
        """All stored keys under a ``/``-path prefix."""

    def quarantine(self, key: str) -> bool:
        """Retire a corrupted entry so it is never served again (directory
        backends keep a forensics copy under ``_quarantine/``); True when
        an entry was actually retired."""
        return self.delete(key)

    def clear(self, prefix: str = "") -> None:
        for key in self.keys(prefix):
            self.delete(key)

    def uri(self) -> str:
        return f"{self.scheme}://"


class MemoryBackend(Backend):
    """In-process LRU over bytes (``memory://``)."""

    scheme = "memory"

    def __init__(self, capacity: int = 1024):
        self.capacity = max(int(capacity), 1)
        self._data: "OrderedDict[str, bytes]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[bytes]:
        validate_key(key)
        with self._lock:
            data = self._data.get(key)
            if data is not None:
                self._data.move_to_end(key)
            return data

    def put(self, key: str, data: bytes) -> None:
        validate_key(key)
        with self._lock:
            self._data[key] = bytes(data)
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def delete(self, key: str) -> bool:
        validate_key(key)
        with self._lock:
            return self._data.pop(key, None) is not None

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            names = list(self._data)
        if not prefix:
            return names
        return [k for k in names if k == prefix or k.startswith(prefix + "/")]


def _fname(key: str) -> str:
    return validate_key(key).replace("/", "__") + ENTRY_SUFFIX


def _unfname(name: str) -> str:
    return name[: -len(ENTRY_SUFFIX)].replace("__", "/")


class LocalDirectoryBackend(Backend):
    """One file per entry under a local directory (``file://<path>``).

    Writes are atomic (temp file + ``os.replace``) so concurrent writers —
    or a crash mid-write — can never produce a torn entry: readers observe
    either the old bytes or the new bytes, never a mix.  ``max_entries``
    bounds the store by evicting the oldest entries (mtime order).
    """

    scheme = "file"
    _fsync = False

    def __init__(self, path, max_entries: Optional[int] = None):
        self.path = Path(path)
        self.max_entries = max_entries

    def uri(self) -> str:
        return f"{self.scheme}://{self.path}"

    def _file(self, key: str) -> Path:
        return self.path / _fname(key)

    def get(self, key: str) -> Optional[bytes]:
        try:
            return self._file(key).read_bytes()
        except OSError:
            return None

    def put(self, key: str, data: bytes) -> None:
        path = self._file(key)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                    if self._fsync:
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
            if self._fsync:
                self._fsync_dir()
        except OSError as e:
            raise StoreError(f"cannot write {path}: {e}") from e
        if self.max_entries is not None:
            self._prune()

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.path, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass

    def _prune(self) -> None:
        try:
            entries = sorted(
                self.path.glob("*" + ENTRY_SUFFIX),
                key=lambda p: p.stat().st_mtime,
            )
            for p in entries[: max(len(entries) - self.max_entries, 0)]:
                p.unlink()
        except OSError:
            pass

    def delete(self, key: str) -> bool:
        try:
            self._file(key).unlink()
            return True
        except OSError:
            return False

    def keys(self, prefix: str = "") -> List[str]:
        try:
            names = [
                _unfname(p.name)
                for p in self.path.glob("*" + ENTRY_SUFFIX)
            ]
        except OSError:
            return []
        if not prefix:
            return sorted(names)
        return sorted(
            k for k in names if k == prefix or k.startswith(prefix + "/")
        )

    def quarantine(self, key: str) -> bool:
        """Move the entry into ``_quarantine/`` (kept for forensics) so the
        corrupted bytes are never served again; best-effort."""
        src = self._file(key)
        qdir = self.path / QUARANTINE_DIR
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            os.replace(src, qdir / f"{src.name}.{int(time.time() * 1e6)}")
            return True
        except OSError:
            try:
                src.unlink()
                return True
            except OSError:
                return False


class SharedDirectoryBackend(LocalDirectoryBackend):
    """A :class:`LocalDirectoryBackend` hardened for cross-process /
    cross-host sharing (``shared://<path>``): every write is fsynced (file
    and directory) before the atomic rename, so once any fleet process
    observes an entry it is durable for all of them."""

    scheme = "shared"
    _fsync = True


def from_uri(uri: str) -> Backend:
    """Resolve a store URI to a backend: ``memory://`` (in-process LRU),
    ``file://<path>`` (local directory), ``shared://<path>`` (shared
    directory with durable writes).  A bare path means ``file://``."""
    uri = uri.strip()
    if not uri:
        raise StoreError("empty store URI")
    if uri.startswith("memory://"):
        return MemoryBackend()
    for scheme, cls in (
        ("file://", LocalDirectoryBackend),
        ("shared://", SharedDirectoryBackend),
    ):
        if uri.startswith(scheme):
            path = uri[len(scheme):]
            if not path:
                raise StoreError(f"store URI {uri!r} has no path")
            return cls(path)
    if "://" in uri:
        raise StoreError(
            f"unknown store URI scheme {uri!r}: expected memory://, "
            f"file://<path> or shared://<path>"
        )
    return LocalDirectoryBackend(uri)
