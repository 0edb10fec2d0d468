"""Process-wide store configuration: env resolution and default instances.

One environment variable drives everything:

- ``REPRO_STORE=<uri>`` — the default store location (``memory://``,
  ``file://<dir>``, ``shared://<dir>``); ``off``/``0`` disables persistent
  storage entirely.  Unset → ``file://$XDG_CACHE_HOME/repro_torch/solver-cache``
  — the port's own directory, not the JAX package's ``repro/solver-cache``,
  so the two packages never share entries.
- ``REPRO_STORE_MEM_ENTRIES`` / ``REPRO_STORE_MAX_ENTRIES`` — in-memory
  LRU and on-backend entry caps.

The pre-store env vars (``REPRO_SOLVER_CACHE``, ``REPRO_SOLVER_CACHE_DIR``,
``REPRO_SOLVER_CACHE_SIZE``, ``REPRO_SOLVER_CACHE_DISK_SIZE``) are still
honored when ``REPRO_STORE*`` is unset — mapped onto the equivalent store
settings with a :class:`DeprecationWarning` naming the replacement.  The
names are the JAX package's, so one environment configures both packages'
stores (each in its own default directory).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import warnings
from pathlib import Path
from typing import Optional

from .backend import Backend, MemoryBackend, StoreError, from_uri
from .objects import ObjectStore

FALSEY = {"0", "off", "false", "no"}

_DEPRECATIONS = {
    "REPRO_SOLVER_CACHE": "REPRO_STORE=off",
    "REPRO_SOLVER_CACHE_DIR": "REPRO_STORE=file://<dir>",
    "REPRO_SOLVER_CACHE_SIZE": "REPRO_STORE_MEM_ENTRIES",
    "REPRO_SOLVER_CACHE_DISK_SIZE": "REPRO_STORE_MAX_ENTRIES",
}


def _warn_legacy(var: str) -> None:
    warnings.warn(
        f"{var} is deprecated; use {_DEPRECATIONS[var]} (store URIs: "
        f"memory://, file://<dir>, shared://<dir>)",
        DeprecationWarning, stacklevel=3)


def _int_env(var: str, default: int, *, legacy: Optional[str] = None) -> int:
    raw = os.environ.get(var)
    if raw is None and legacy is not None:
        raw = os.environ.get(legacy)
        if raw is not None:
            _warn_legacy(legacy)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def default_cache_dir() -> Path:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(base) / "repro_torch" / "solver-cache"


@dataclasses.dataclass(frozen=True)
class StoreSettings:
    """Resolved store configuration (env → concrete values)."""

    enabled: bool
    uri: Optional[str]          # None when disabled or memory-only
    directory: Optional[Path]   # backing directory for file:///shared://
    mem_entries: int
    max_entries: int

    def make_backend(self) -> Optional[Backend]:
        if not self.enabled:
            return None
        if self.uri is None:
            return MemoryBackend(capacity=self.mem_entries)
        backend = from_uri(self.uri)
        if hasattr(backend, "max_entries"):
            backend.max_entries = self.max_entries
        return backend


def resolve_settings() -> StoreSettings:
    """Resolve the store env surface (new vars first, legacy fallback)."""
    mem_entries = max(_int_env("REPRO_STORE_MEM_ENTRIES", 128,
                               legacy="REPRO_SOLVER_CACHE_SIZE"), 1)
    max_entries = max(_int_env("REPRO_STORE_MAX_ENTRIES", 512,
                               legacy="REPRO_SOLVER_CACHE_DISK_SIZE"), 1)

    uri = os.environ.get("REPRO_STORE")
    if uri is not None:
        uri = uri.strip()
        if uri.lower() in FALSEY or not uri:
            return StoreSettings(False, None, None, mem_entries, max_entries)
    else:
        legacy_on = os.environ.get("REPRO_SOLVER_CACHE")
        if legacy_on is not None:
            _warn_legacy("REPRO_SOLVER_CACHE")
            if legacy_on.strip().lower() in FALSEY:
                return StoreSettings(False, None, None,
                                     mem_entries, max_entries)
        legacy_dir = os.environ.get("REPRO_SOLVER_CACHE_DIR")
        if legacy_dir is not None:
            _warn_legacy("REPRO_SOLVER_CACHE_DIR")
            # empty legacy dir meant "memory-only": enabled, no disk tier
            uri = f"file://{legacy_dir}" if legacy_dir else None
        else:
            uri = f"file://{default_cache_dir()}"

    directory: Optional[Path] = None
    if uri is not None:
        if uri.startswith("memory://"):
            uri_dir = None
        else:
            uri_dir = uri.split("://", 1)[1] if "://" in uri else uri
        directory = Path(uri_dir) if uri_dir else None
    return StoreSettings(True, uri, directory, mem_entries, max_entries)


# ---------------------------------------------------------------------------
# process-wide default store (rebuilt lazily so env changes take effect)
# ---------------------------------------------------------------------------

_default: Optional[ObjectStore] = None
_configured_off = False
_default_lock = threading.Lock()


def default_store(required: bool = False) -> Optional[ObjectStore]:
    """The process-wide :class:`ObjectStore` resolved from the environment;
    None when the store is disabled (or raises with ``required=True``)."""
    global _default
    with _default_lock:
        if _default is None and not _configured_off:
            backend = resolve_settings().make_backend()
            if backend is not None:
                _default = ObjectStore(backend, name="store")
    if _default is None and required:
        raise StoreError(
            "the default store is disabled (REPRO_STORE=off) — enable it or "
            "pass an explicit store")
    return _default


def configure(uri: Optional[str]) -> Optional[ObjectStore]:
    """Replace the process-wide default store (None/'off' disables it)."""
    global _default, _configured_off
    with _default_lock:
        if uri is None or uri.strip().lower() in FALSEY:
            _default, _configured_off = None, True
        else:
            _default = ObjectStore(from_uri(uri), name="store")
            _configured_off = False
    return _default


def reset() -> None:
    """Drop the process default; next use re-resolves from the env."""
    global _default, _configured_off
    with _default_lock:
        _default, _configured_off = None, False
