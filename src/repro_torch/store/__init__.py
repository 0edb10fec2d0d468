"""`repro_torch.store` — the port's one persistence API (a copy of the JAX
package's ``repro.store``, which the port does not import).

Content-addressed storage for everything the planning stack persists:
solver Solutions, saved MemoryPlans, and warm-start frontiers.  Layers, bottom to top:

- :mod:`~repro_torch.store.backend` — byte backends (``memory://`` LRU,
  ``file://`` local directory, ``shared://`` fsync-hardened shared
  directory), all with atomic writes and corruption quarantine;
- :mod:`~repro_torch.store.codec` — the tamper-evident pickle envelope, the
  one place in the port that (de)serializes, in the JAX package's layout;
- :mod:`~repro_torch.store.objects` — :class:`ObjectStore`, typed access with
  metrics and quarantine-on-corrupt;
- :mod:`~repro_torch.store.keys` — the chain × request × code content address
  (:class:`PlanKey`, :func:`request_digest`);
- :mod:`~repro_torch.store.plans` — :class:`PlanStore`, where every foreign
  plan is admitted only through ``MemoryPlan.verify()``;
- :mod:`~repro_torch.store.frontier` — :class:`WarmStartFrontier`, persisted
  ``sweep()`` results answering any budget query with ≤1 solve;
- :mod:`~repro_torch.store.config` — ``REPRO_STORE`` env resolution, legacy
  ``REPRO_SOLVER_CACHE*`` mapping, and the process default store (the
  port's own directory, never the JAX package's).

Exports resolve lazily (PEP 562) so ``repro.core.solver_cache`` can import
the backend/codec submodules without initializing the higher layers.
"""

from typing import TYPE_CHECKING

_EXPORTS = {
    "Backend": "backend",
    "MemoryBackend": "backend",
    "LocalDirectoryBackend": "backend",
    "SharedDirectoryBackend": "backend",
    "StoreError": "backend",
    "from_uri": "backend",
    "validate_key": "backend",
    "QUARANTINE_DIR": "backend",
    "CorruptEntryError": "codec",
    "encode": "codec",
    "decode": "codec",
    "ObjectStore": "objects",
    "PlanKey": "keys",
    "request_digest": "keys",
    "PLAN_NAMESPACE": "keys",
    "FRONTIER_NAMESPACE": "keys",
    "PlanStore": "plans",
    "WarmStartFrontier": "frontier",
    "FrontierAnswer": "frontier",
    "template_digest": "frontier",
    "StoreSettings": "config",
    "resolve_settings": "config",
    "default_store": "config",
    "default_cache_dir": "config",
    "configure": "config",
    "reset": "config",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:
    from .backend import (Backend, LocalDirectoryBackend, MemoryBackend,
                          SharedDirectoryBackend, StoreError, from_uri,
                          validate_key, QUARANTINE_DIR)
    from .codec import CorruptEntryError, decode, encode
    from .config import (StoreSettings, configure, default_cache_dir,
                         default_store, reset, resolve_settings)
    from .frontier import FrontierAnswer, WarmStartFrontier, template_digest
    from .keys import (FRONTIER_NAMESPACE, PLAN_NAMESPACE, PlanKey,
                       request_digest)
    from .objects import ObjectStore
    from .plans import PlanStore


def __getattr__(name):
    try:
        submodule = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.store' has no attribute {name!r}") from None
    import importlib
    mod = importlib.import_module(f".{submodule}", __name__)
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
