"""Observability for planned execution — the port of ``repro.obs``:

- :mod:`.trace` — the span recorder the op walker and the train and serve
  loops write into (CUDA-event pairs on the stream that runs each op, the
  host clock off CUDA), with the Perfetto and timeline exporters;
- :mod:`.metrics` — the process-wide counters, gauges and histograms;
- :mod:`.drift` — a plan's predicted numbers against a trace, and the chain
  re-priced with the trace's stage times (``Chain.calibrate``).
"""

from . import metrics
from .drift import DriftReport, LayerDrift, calibrate_from_trace, compare
from .trace import (Span, Tracer, measured_stage_times, transfer_overlap,
                    validate_perfetto, validate_trace_file)

__all__ = [
    "metrics",
    "Span",
    "Tracer",
    "measured_stage_times",
    "transfer_overlap",
    "validate_perfetto",
    "validate_trace_file",
    "DriftReport",
    "LayerDrift",
    "compare",
    "calibrate_from_trace",
]
