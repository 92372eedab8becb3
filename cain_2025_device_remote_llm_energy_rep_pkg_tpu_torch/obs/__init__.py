"""Host-side observability: metrics, spans, flight events, anomaly
detection and live energy attribution (copies of the JAX package's
modules; ``energy.py`` prices with the H100 energy model).

- :mod:`.metrics` — counters / gauges / fixed-bucket histograms with
  Prometheus text exposition; one process-wide ``REGISTRY`` and the kill
  switch (env ``TPU_LLM_OBS=0``).
- :mod:`.trace` — monotonic-clock spans with parent links; one
  process-wide ``TRACER``.
- :mod:`.flight` — a bounded ring of schema'd structured events with
  crash dumps; one process-wide ``FLIGHT``.
- :mod:`.detect` — the per-cell run CV of the study (``CELL_CV``),
  step-time spikes and goodput accounting.
- :mod:`.energy` — the energy model folded into live per-request J and
  J/token estimates, attached to each solo result as
  ``extras["energy_model"]``.
- :mod:`.tenants` — per-tenant accounting.
- :mod:`.timeseries` — a fixed-capacity time-series ring of registry
  snapshots, and :mod:`.slo` — objectives with burn-rate alerting over it.
"""

from .flight import FLIGHT, FlightRecorder
from .metrics import (
    REGISTRY,
    MetricsRegistry,
    bucket_fraction_below,
    disable,
    enable,
    enabled,
    merge_expositions,
    parse_exposition,
    quantile_from_buckets,
)
from .slo import Objective, SLOEngine, parse_slo_spec
from .timeseries import SamplerThread, TimeSeriesRing
from .trace import TRACER, Span, SpanTracer, TraceContext, mint_trace_id

__all__ = [
    "REGISTRY",
    "MetricsRegistry",
    "TRACER",
    "Span",
    "SpanTracer",
    "TraceContext",
    "mint_trace_id",
    "FLIGHT",
    "FlightRecorder",
    "enabled",
    "enable",
    "disable",
    "merge_expositions",
    "parse_exposition",
    "quantile_from_buckets",
    "bucket_fraction_below",
    "TimeSeriesRing",
    "SamplerThread",
    "SLOEngine",
    "Objective",
    "parse_slo_spec",
]
