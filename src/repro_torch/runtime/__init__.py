"""Runtime loops and services.

Lazy exports (PEP 562), as the JAX package has them: importing
``repro_torch.runtime`` for :class:`PlanService` does not import the train
and serve loops.
"""

_EXPORTS = {
    "TrainLoopConfig": ("train_loop", "TrainLoopConfig"),
    "run_training": ("train_loop", "run_training"),
    "ServeLoopConfig": ("serve_loop", "ServeLoopConfig"),
    "run_serving": ("serve_loop", "run_serving"),
    "PlannedKV": ("kv_residency", "PlannedKV"),
    "LRUKV": ("kv_residency", "LRUKV"),
    "PlanService": ("plan_service", "PlanService"),
    "TenantQuota": ("plan_service", "TenantQuota"),
    "QuotaExceededError": ("plan_service", "QuotaExceededError"),
    "DEFAULT_TENANT": ("plan_service", "DEFAULT_TENANT"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(f".{module}", __name__), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
