"""The one (de)serialization point of the port: a tamper-evident pickle
envelope, laid out as the JAX package's ``repro.store.codec`` lays it out
(same magic, version and tuple), so an entry whose payload is plain Python
decodes in either package.

Every object that crosses a process/host boundary through a
:class:`repro_torch.store.Backend` — solver Solutions, saved MemoryPlans,
warm-start frontiers — is wrapped by :func:`encode` and read back by
:func:`decode`.  The envelope carries a magic tag, format version,
the entry *kind*, the store key it was written under, and a SHA-256 digest
of the payload bytes, so

- a byte-tampered or truncated entry fails the digest/structure check and
  raises :class:`CorruptEntryError` instead of deserializing garbage;
- an entry copied under the wrong key (cache-poisoning by rename) is
  rejected by the key cross-check;
- kind confusion (a frontier where a plan was expected) is caught before
  the caller touches the object.

Note the envelope authenticates *integrity*,
not *origin*: a store shared across trust domains still requires the
semantic gate (``MemoryPlan.verify()``) on every admitted plan, which is
exactly what :class:`repro_torch.store.PlanStore` does.
"""

from __future__ import annotations

import hashlib
import pickle
import sys
from typing import Any, Optional, Tuple

MAGIC = "repro-store"
VERSION = 1

#: Deep schedule/solution objects (L≈339 chains) can exceed the default
#: recursion limit while pickling; match the old solver_cache headroom.
_PICKLE_RECURSION_LIMIT = 100_000


class CorruptEntryError(ValueError):
    """The stored bytes are not a valid envelope (tampered, truncated,
    foreign format, digest mismatch, or wrong kind/key)."""


def _payload_digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def encode(kind: str, key: str, obj: Any) -> bytes:
    """Serialize ``obj`` into a tamper-evident envelope for store ``key``."""
    limit = sys.getrecursionlimit()
    if limit < _PICKLE_RECURSION_LIMIT:
        sys.setrecursionlimit(_PICKLE_RECURSION_LIMIT)
    try:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        envelope = (MAGIC, VERSION, str(kind), str(key),
                    _payload_digest(payload), payload)
        return pickle.dumps(envelope, protocol=pickle.HIGHEST_PROTOCOL)
    finally:
        if sys.getrecursionlimit() != limit:
            sys.setrecursionlimit(limit)


def decode(
    data: bytes,
    *,
    kind: Optional[str] = None,
    key: Optional[str] = None,
) -> Tuple[str, str, Any]:
    """Open an envelope, verifying structure, digest, and (when given) the
    expected ``kind``/``key``.  Returns ``(kind, key, obj)``; raises
    :class:`CorruptEntryError` on any mismatch."""
    try:
        envelope = pickle.loads(data)
    except Exception as e:  # noqa: BLE001 - any unpickle failure is corrupt
        raise CorruptEntryError(f"undecodable store entry: {e}") from e
    if (
        not isinstance(envelope, tuple)
        or len(envelope) != 6
        or envelope[0] != MAGIC
    ):
        raise CorruptEntryError("not a repro-store envelope")
    _, version, got_kind, got_key, digest, payload = envelope
    if version != VERSION:
        raise CorruptEntryError(
            f"unsupported envelope version {version!r} (expected {VERSION})"
        )
    if not isinstance(payload, bytes) or _payload_digest(payload) != digest:
        raise CorruptEntryError("payload digest mismatch (tampered entry)")
    if kind is not None and got_kind != kind:
        raise CorruptEntryError(
            f"entry kind {got_kind!r} where {kind!r} was expected"
        )
    if key is not None and got_key != key:
        raise CorruptEntryError(
            f"entry written for key {got_key!r} served under {key!r}"
        )
    limit = sys.getrecursionlimit()
    if limit < _PICKLE_RECURSION_LIMIT:
        sys.setrecursionlimit(_PICKLE_RECURSION_LIMIT)
    try:
        obj = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001
        raise CorruptEntryError(f"undecodable payload: {e}") from e
    finally:
        if sys.getrecursionlimit() != limit:
            sys.setrecursionlimit(limit)
    return got_kind, got_key, obj
