"""Plan-vs-actual drift — the port of ``repro.obs.drift``: compare a
:class:`~repro_torch.plan.plan.MemoryPlan`'s simulator-predicted numbers
against a measured trace, and feed measured per-stage times back into the
:class:`~repro_torch.core.chain.Chain` cost model.

1. run the plan with a :class:`~repro_torch.obs.trace.Tracer`
   (``plan.execute(..., tracer=tr)`` or ``plan.bind(stages, tracer=tr)``),
2. ``report = drift.compare(plan, tr)`` — per-stage and aggregate drift,
3. ``chain2 = drift.calibrate_from_trace(plan.chain, tr)`` — the chain
   re-priced with the measured forward/backward times
   (:meth:`Chain.calibrate`),
4. re-plan on ``chain2``: the simulator now sums measured per-op costs.

Replaying the plan's own predicted timeline
(``Tracer.from_timeline(plan.timeline())``) through :func:`compare` gives
``makespan_ratio == 1`` and zero per-stage drift.  ``measured_stall`` is
the summed length of the ``Prefetch`` spans: on CUDA those are the copies
on the side stream, from the point the compute stream reached to the copy's
end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union

from ..core.chain import Chain
from .trace import Span, Tracer, measured_stage_times


def _spans_of(trace: Union[Tracer, Sequence[Span]]) -> List[Span]:
    return list(trace.spans if isinstance(trace, Tracer) else trace)


def _ratio(measured: float, predicted: float) -> float:
    if predicted <= 0:
        return float("inf") if measured > 0 else 1.0
    return measured / predicted


@dataclasses.dataclass
class LayerDrift:
    """Predicted vs measured compute times for one paper stage."""

    stage: int  # paper stage l (1..L+1)
    uf_predicted: float
    uf_measured: float  # nan when the trace holds no sample
    ub_predicted: float
    ub_measured: float

    @property
    def fwd_ratio(self) -> float:
        return _ratio(self.uf_measured, self.uf_predicted)

    @property
    def bwd_ratio(self) -> float:
        return _ratio(self.ub_measured, self.ub_predicted)

    def to_json(self) -> Dict[str, Any]:
        return {
            "stage": self.stage,
            "uf_predicted": self.uf_predicted,
            "uf_measured": self.uf_measured,
            "ub_predicted": self.ub_predicted,
            "ub_measured": self.ub_measured,
            "fwd_ratio": self.fwd_ratio,
            "bwd_ratio": self.bwd_ratio,
        }


@dataclasses.dataclass
class DriftReport:
    """Aggregate + per-layer drift of one executed plan.

    ``makespan_ratio`` is measured/predicted (1.0 = the simulator was
    exact); ``layer_mape`` is the mean absolute percentage error over every
    per-stage time the trace sampled (paper §5.3: 7.8 % on a GPU).
    Peak fields are ``None`` when the executor did not record memory.
    """

    predicted_makespan: float
    measured_makespan: float
    layers: List[LayerDrift]
    predicted_stall: float = 0.0
    measured_stall: Optional[float] = None
    predicted_device_peak: Optional[float] = None
    measured_device_peak: Optional[float] = None
    predicted_host_peak: Optional[float] = None
    measured_host_peak: Optional[float] = None
    span_count: int = 0

    @property
    def makespan_ratio(self) -> float:
        return _ratio(self.measured_makespan, self.predicted_makespan)

    @property
    def layer_mape(self) -> float:
        """Mean |measured - predicted| / predicted over sampled stage times,
        in percent; ``nan`` when nothing was sampled."""
        errs = []
        for ld in self.layers:
            pairs = (
                (ld.uf_measured, ld.uf_predicted),
                (ld.ub_measured, ld.ub_predicted),
            )
            for meas, pred in pairs:
                if math.isnan(meas) or pred <= 0:
                    continue
                errs.append(abs(meas - pred) / pred)
        if not errs:
            return float("nan")
        return 100.0 * sum(errs) / len(errs)

    def to_json(self) -> Dict[str, Any]:
        return {
            "predicted_makespan_s": self.predicted_makespan,
            "measured_makespan_s": self.measured_makespan,
            "makespan_ratio": self.makespan_ratio,
            "layer_mape_percent": self.layer_mape,
            "predicted_stall_s": self.predicted_stall,
            "measured_stall_s": self.measured_stall,
            "predicted_device_peak": self.predicted_device_peak,
            "measured_device_peak": self.measured_device_peak,
            "predicted_host_peak": self.predicted_host_peak,
            "measured_host_peak": self.measured_host_peak,
            "span_count": self.span_count,
            "layers": [ld.to_json() for ld in self.layers],
        }

    def summary(self) -> str:
        head = (
            f"DriftReport: predicted {self.predicted_makespan:.4f}s, "
            f"measured {self.measured_makespan:.4f}s "
            f"(x{self.makespan_ratio:.2f})"
        )
        lines = [head]
        mape = self.layer_mape
        if not math.isnan(mape):
            msg = f"  per-layer time MAPE: {mape:.1f}% over {self.span_count} spans"
            lines.append(msg)
        if self.measured_stall is not None:
            msg = (
                f"  transfer stall: predicted {self.predicted_stall:.4f}s, "
                f"measured {self.measured_stall:.4f}s"
            )
            lines.append(msg)
        worst = [
            ld
            for ld in self.layers
            if not math.isnan(ld.uf_measured) and ld.uf_predicted > 0
        ]
        if worst:
            w = max(worst, key=lambda ld: abs(math.log(max(ld.fwd_ratio, 1e-12))))
            msg = (
                f"  worst forward drift: stage {w.stage} "
                f"(predicted {w.uf_predicted:.2e}s, measured "
                f"{w.uf_measured:.2e}s)"
            )
            lines.append(msg)
        return "\n".join(lines)


def compare(plan, trace: Union[Tracer, Sequence[Span]]) -> DriftReport:
    """Drift of one executed plan: ``plan`` is a
    :class:`~repro_torch.plan.plan.MemoryPlan` (needs a profiled chain for
    the per-stage rows), ``trace`` the tracer (or span list) its execution
    filled."""
    spans = _spans_of(trace)
    chain: Optional[Chain] = plan.chain
    if spans:
        t0 = min(s.t_start for s in spans)
        t1 = max(s.t_end for s in spans)
        measured_makespan = t1 - t0
    else:
        measured_makespan = 0.0
    measured_stall = None
    stall_samples = [s for s in spans if s.op == "Prefetch"]
    if stall_samples:
        measured_stall = sum(s.duration for s in stall_samples)
    layers: List[LayerDrift] = []
    if chain is not None:
        uf_m, ub_m = measured_stage_times(spans, chain.length)
        for i in range(chain.length + 1):
            layers.append(
                LayerDrift(
                    stage=i + 1,
                    uf_predicted=float(chain.uf[i]),
                    uf_measured=uf_m[i],
                    ub_predicted=float(chain.ub[i]),
                    ub_measured=ub_m[i],
                )
            )
    dev_peaks = [s.device_mem for s in spans if s.device_mem is not None]
    host_peaks = [s.host_mem for s in spans if s.host_mem is not None]
    return DriftReport(
        predicted_makespan=float(plan.expected_time),
        measured_makespan=measured_makespan,
        layers=layers,
        predicted_stall=float(plan.transfer_stall),
        measured_stall=measured_stall,
        predicted_device_peak=float(plan.peak_device_mem),
        measured_device_peak=max(dev_peaks) if dev_peaks else None,
        predicted_host_peak=float(plan.peak_host_mem),
        measured_host_peak=max(host_peaks) if host_peaks else None,
        span_count=len(spans),
    )


def calibrate_from_trace(chain: Chain, trace: Union[Tracer, Sequence[Span]]) -> Chain:
    """The chain re-priced with measured per-stage times
    (:meth:`Chain.calibrate`): stages the trace never sampled keep their
    modeled costs.  Feed the result back into ``build_plan`` to re-plan on
    measured ground truth."""
    spans = _spans_of(trace)
    uf, ub = measured_stage_times(spans, chain.length)
    return chain.calibrate(uf=uf, ub=ub)
