"""Per-run host-span trace plugin (the host-side twin of torch_trace).

``profilers/torch_trace.py`` captures the run's DEVICE activity; this
profiler captures the HOST side — the obs span tree (request → queue →
prefill → decode, plus any spans the workload opens) recorded during the
measurement window — and writes it as ``<run_dir>/span_trace.json`` in
Chrome trace-event format, next to ``torch_trace/``. The two open side by
side in Perfetto/chrome://tracing, so a run's artifacts show both what
the card did and what the serving stack did around it.

A copy of the JAX package's module. Hardware-free and cheap (spans are
recorded anyway while telemetry is on), so unlike the torch trace it can
ride the full sweep. Honors the obs kill switch: with telemetry off
there are no spans and the column is None.
"""

from __future__ import annotations

from typing import Any, Dict

from ..runner.context import RunContext
from .base import Profiler


class SpanTraceProfiler(Profiler):
    data_columns = ("span_trace",)

    def __init__(self) -> None:
        self._since = 0
        self._path: "str | None" = None

    def on_start(self, context: RunContext) -> None:
        from ..obs.trace import TRACER

        self._since = TRACER.seq()
        self._path = None

    def on_stop(self, context: RunContext) -> None:
        from ..obs.trace import TRACER

        spans = TRACER.spans(since=self._since)
        if not spans:
            self._path = None
            return
        path = context.run_dir / "span_trace.json"
        TRACER.export(path, spans)
        self._path = str(path)

    def collect(self, context: RunContext) -> Dict[str, Any]:
        # Same honesty rule as trace_dir: only report an artifact that
        # was actually written.
        return {"span_trace": self._path}
