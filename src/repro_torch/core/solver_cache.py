"""Persistent memoization for the DP solvers: in-memory LRU + on-disk store
(the port of ``repro.core.solver_cache``).

Every public solver entry point (``solve_optimal``, ``solve_min_memory``,
``solve_optimal_offload``, ``solve_min_device_memory``) keys its inputs by a
content hash of the *discretized* problem — the slot-rounded size arrays, the
continuous stage times, the host-link model, the budget/slot count, the fill
(``impl``) and the branch flags — and memoizes the returned
:class:`~repro_torch.core.solver.Solution`.  A repeated plan (the same chain,
budget and fill) therefore skips the table fill entirely: on the card, a hit
launches no fill kernel.  A Solution holds only host objects (the schedule,
the recursion tree, floats and ints; no tensor, whatever fill made it), so
an entry written next to the card loads on a host without one.

The persistent tier is a :mod:`repro_torch.store` directory backend: entries
are tamper-evident :mod:`repro_torch.store.codec` envelopes written
atomically; a corrupted, truncated, or version-skewed entry is quarantined
and treated as a miss — the caller simply re-solves and overwrites it.

Environment knobs (see :mod:`repro_torch.store.config`; the names are the
JAX package's):

- ``REPRO_STORE=<uri>`` — the store location (``file://<dir>``,
  ``shared://<dir>``, ``memory://``); ``off`` disables caching entirely.
  Default: ``file://$XDG_CACHE_HOME/repro_torch/solver-cache``.
- ``REPRO_STORE_MEM_ENTRIES=<n>`` caps the in-memory LRU (default 128);
  ``REPRO_STORE_MAX_ENTRIES=<n>`` the on-disk store (default 512 entries,
  oldest evicted).
- Deprecated (mapped onto the above with a ``DeprecationWarning``):
  ``REPRO_SOLVER_CACHE=0`` → ``REPRO_STORE=off``;
  ``REPRO_SOLVER_CACHE_DIR=<dir>`` → ``REPRO_STORE=file://<dir>`` (empty
  value → memory-only); ``REPRO_SOLVER_CACHE_SIZE`` →
  ``REPRO_STORE_MEM_ENTRIES``; ``REPRO_SOLVER_CACHE_DISK_SIZE`` →
  ``REPRO_STORE_MAX_ENTRIES``.

Keys include a content hash of the solver sources and of the fill kernels'
CUDA sources (:func:`code_fingerprint`), so editing either invalidates stale
on-disk entries.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ..obs import metrics as _obs
from ..store.backend import LocalDirectoryBackend, StoreError
from ..store.codec import CorruptEntryError, decode, encode

_MAGIC = "repro-solver-cache"
_VERSION = 1
#: Envelope kind tag for cached solver Solutions.
SOLUTION_KIND = "solution"

# the sources that define what a Solution means, relative to the package
# root: the solvers, the chain and schedule model, the fills and their two
# CUDA sources with the header that holds their bodies (the impl="cuda" /
# "cuda_fused" fills make cached Solutions).
# They are read by path, never imported, so fingerprinting builds nothing.
_FINGERPRINT_FILES = ("core/chain.py", "core/schedule.py",
                      "core/dp_kernels.py", "core/solver.py",
                      "offload/solver.py", "kernels/dp_fill/ops.py",
                      "kernels/csrc/dp_band_min.cu",
                      "kernels/csrc/dp_fused_fill.cu",
                      "kernels/csrc/dp_fill_index.cuh")
_code_fingerprint: Optional[str] = None


def _hash_sources(pkg_root: Path) -> str:
    h = hashlib.sha256()
    for rel in _FINGERPRINT_FILES:
        try:
            with open(pkg_root / rel, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(rel.encode())  # missing file: still deterministic
    return h.hexdigest()


def code_fingerprint() -> str:
    """Content hash of the solver implementation and the fill kernels'
    sources (computed once)."""
    global _code_fingerprint
    if _code_fingerprint is None:
        # src/repro_torch/
        _code_fingerprint = _hash_sources(Path(__file__).resolve().parents[1])
    return _code_fingerprint


def _hash_host(h, host) -> None:
    if host is None:
        h.update(b"nohost")
    else:
        h.update(np.array(
            [host.bandwidth_d2h,
             -1.0 if host.bandwidth_h2d is None else host.bandwidth_h2d,
             host.latency], dtype=np.float64).tobytes())


def chain_fingerprint(chain) -> str:
    """Content hash of a :class:`~repro_torch.core.chain.Chain` — all
    continuous cost/size arrays plus the host-link model, byte for byte the
    JAX package's ``chain_fingerprint``.  Shared by the solver cache and by
    :mod:`repro_torch.plan` plan serialization, so a saved ``MemoryPlan``
    validates against exactly the chain it was solved for."""
    h = hashlib.sha256()
    h.update(b"repro-chain\0")
    for arr in (chain.uf, chain.ub, chain.wa, chain.wabar, chain.wdelta,
                chain.of, chain.ob):
        h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
        h.update(b"\0")
    _hash_host(h, chain.host)
    return h.hexdigest()


class SolverCache:
    """Thread-safe LRU of solver Solutions with an optional persistent tier
    (a :mod:`repro_torch.store` directory backend)."""

    def __init__(self, capacity: Optional[int] = None,
                 directory: Optional[Path] = "auto",
                 enabled: Optional[bool] = None):
        from ..store.config import resolve_settings
        settings = resolve_settings()
        if enabled is None:
            enabled = settings.enabled
        if capacity is None:
            capacity = settings.mem_entries
        self.enabled = enabled
        self.capacity = max(capacity, 1)
        self.disk_capacity = settings.max_entries
        if directory == "auto":
            backend = settings.make_backend() if self.enabled else None
            # a memory:// default store adds nothing over the LRU tier
            if backend is not None and not hasattr(backend, "path"):
                backend = None
        elif directory and self.enabled:
            backend = LocalDirectoryBackend(
                Path(directory), max_entries=self.disk_capacity)
        else:
            backend = None
        self._backend = backend
        self.directory = Path(backend.path) if backend is not None else None
        self._mem: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self._disk_failures = 0     # consecutive; disk tier pauses after 8
        self.stats = {"hits": 0, "misses": 0, "disk_hits": 0,
                      "disk_errors": 0, "puts": 0, "evictions": 0}

    def _bump(self, stat: str, n: int = 1) -> None:
        """Count in the instance stats and the process metrics registry
        (``solver_cache.*``)."""
        self.stats[stat] += n
        _obs.counter(f"solver_cache.{stat}").inc(n)

    # -- keying ------------------------------------------------------------

    def key_for(self, kind: str, impl: str, chain, dchain,
                num_slots: int, allow_fall: bool) -> str:
        """Content hash of the discretized problem + solve flags."""
        h = hashlib.sha256()
        for part in (_MAGIC, str(_VERSION), code_fingerprint(), kind, impl,
                     str(num_slots), str(int(allow_fall))):
            h.update(part.encode())
            h.update(b"\0")
        h.update(np.float64(dchain.slot_size).tobytes())
        for arr in (dchain.wa, dchain.wabar, dchain.wdelta, dchain.of,
                    dchain.ob):
            h.update(np.ascontiguousarray(arr, dtype=np.int64).tobytes())
        for arr in (chain.uf, chain.ub, chain.wa):
            h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
        _hash_host(h, chain.host)
        return h.hexdigest()

    # -- lookup / store ----------------------------------------------------

    def get(self, key: str) -> Optional[Any]:
        if not self.enabled:
            return None
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                self._bump("hits")
                return self._mem[key]
        value = self._disk_get(key)
        if value is not None:
            with self._lock:
                self._bump("hits")
                self._bump("disk_hits")
                self._mem_put(key, value)
            return value
        with self._lock:
            self._bump("misses")
        return None

    def put(self, key: str, value: Any, kind: str = SOLUTION_KIND) -> None:
        """Store a value under its content key.  ``kind`` tags the codec
        envelope (``"solution"`` for DP Solutions); lookups are
        kind-agnostic — the key is a content hash, so kinds can never
        collide."""
        if not self.enabled:
            return
        with self._lock:
            self._bump("puts")
            self._mem_put(key, value)
        self._disk_put(key, value, kind)

    def _mem_put(self, key: str, value: Any) -> None:
        self._mem[key] = value
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self._bump("evictions")

    # -- persistent tier (store backend) -----------------------------------

    def _disk_get(self, key: str) -> Optional[Any]:
        if self._backend is None:
            return None
        data = self._backend.get(key)
        if data is None:
            return None
        try:
            _, _, value = decode(data, key=key)
            return value
        except CorruptEntryError:
            # tampered / truncated / version-skewed / foreign-format entry:
            # quarantine it and fall back to a fresh solve
            with self._lock:
                self._bump("disk_errors")
            self._backend.quarantine(key)
            return None

    def _disk_put(self, key: str, value: Any,
                  kind: str = SOLUTION_KIND) -> None:
        if self._backend is None or self._disk_failures >= 8:
            return
        try:
            self._backend.put(key, encode(kind, key, value))
            self._disk_failures = 0
        except (StoreError, OSError):
            # best-effort tier: count the failure and keep trying (a burst of
            # consecutive failures pauses disk writes for this process)
            with self._lock:
                self._bump("disk_errors")
            self._disk_failures += 1

    # -- maintenance -------------------------------------------------------

    def clear(self, memory_only: bool = False) -> None:
        with self._lock:
            self._mem.clear()
        if not memory_only and self._backend is not None:
            self._backend.clear()

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0


# ---------------------------------------------------------------------------
# process-wide default cache (rebuilt lazily so env changes take effect)
# ---------------------------------------------------------------------------

_default: Optional[SolverCache] = None
_default_lock = threading.Lock()


def get_cache() -> SolverCache:
    global _default
    with _default_lock:
        if _default is None:
            _default = SolverCache()
        return _default


def configure(**kwargs) -> SolverCache:
    """Replace the process-wide cache (kwargs as for :class:`SolverCache`)."""
    global _default
    with _default_lock:
        _default = SolverCache(**kwargs)
        return _default


def reset() -> None:
    """Drop the process-wide cache; the next use rebuilds it from the env."""
    global _default
    with _default_lock:
        _default = None


def stats() -> dict:
    return dict(get_cache().stats)


def memoize_solve(kind: str, impl: str, chain, dchain, num_slots: int,
                  allow_fall: bool, use_cache: bool, solve):
    """Shared lookup/store wrapper for the solver entry points: returns the
    cached Solution for this discretized problem, or runs ``solve()`` and
    stores its result.  ``use_cache=False`` bypasses the cache entirely
    (benchmarks time real fills)."""
    if not use_cache:
        return solve()
    sc = get_cache()
    if not sc.enabled:
        return solve()
    key = sc.key_for(kind, impl, chain, dchain, num_slots, allow_fall)
    hit = sc.get(key)
    if hit is not None:
        return hit
    sol = solve()
    sc.put(key, sol)
    return sol
