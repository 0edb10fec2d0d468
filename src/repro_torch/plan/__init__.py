"""Planning: policy strings to :class:`MemoryPlan`\\ s."""

from .compat import resolve_policy
from .plan import (DEFAULT_NUM_SLOTS, BoundPlan, Budget, InfeasiblePlanError,
                   MemoryPlan, parse_size)

__all__ = ["BoundPlan", "Budget", "DEFAULT_NUM_SLOTS", "InfeasiblePlanError",
           "MemoryPlan", "parse_size", "resolve_policy"]
