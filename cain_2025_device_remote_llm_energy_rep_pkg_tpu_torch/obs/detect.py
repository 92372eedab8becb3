"""Streaming anomaly detection and goodput accounting.

Three detectors, all stdlib-only and honoring the shared kill switch:

- **Per-cell run CV** (:class:`CellCvTracker`). The paper's headline
  claims rest on run-to-run stability (30 repetitions per cell; the
  study targets ≤5% CV, BASELINE.md) — but CV was only computed
  post-hoc by the analysis pipeline. A Welford rolling mean/variance
  per (model, length, location) cell over each run's modelled Joules
  and wall time makes the target observable *during* a study:
  ``llm_run_cell_cv{metric,model,length,location}`` gauges update per
  run, and a cell whose CV breaches the threshold after enough
  repetitions fires an anomaly event (once per cell per breach episode
  — re-arming only after the CV recovers — so a noisy cell cannot
  flood the ring). Wired in ``experiments/llm_energy.py``'s
  ``populate_run_data``.

- **Step-time spikes** (:class:`SpikeDetector`). A decode slice that
  takes a rolling-median multiple of its predecessors is exactly the
  "why did this cell's CV blow up" moment — a GC pause, a surprise
  recompile, a relay hiccup. The detector keeps a bounded window of
  recent durations and fires an anomaly event carrying the offending
  duration, the median it was judged against, AND the last few
  flight-recorder events as an exemplar — the forensic context a
  histogram cannot carry. Wired around the continuous scheduler's
  decode slices.

- **Goodput accounting** (``observe_slice_tokens`` /
  ``observe_retired_tokens``). A stepped decode slice steps EVERY row
  of the batch bucket — live rows, rows that finished mid-slice, and
  padding rows alike. ``llm_engine_goodput_tokens_total`` counts
  tokens on rows that actually completed; ``llm_engine_stepped_tokens_
  total`` counts every (row × step) the device executed. Their ratio
  is the wasted-step fraction the continuous scheduler exists to
  minimize — the number that shows whether iteration-level retirement
  is actually paying for its host round-trips.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

from .flight import EV_ANOMALY, FLIGHT
from .metrics import REGISTRY, enabled

# The study's stability target: flag cells whose run-to-run CV exceeds
# this once enough repetitions exist to estimate it.
CELL_CV_THRESHOLD = float(os.environ.get("TPU_LLM_CV_THRESHOLD", 0.05))
CELL_CV_MIN_RUNS = int(os.environ.get("TPU_LLM_CV_MIN_RUNS", 3))
# A slice slower than this multiple of the rolling median is a spike.
SPIKE_MEDIAN_MULTIPLE = float(os.environ.get("TPU_LLM_SPIKE_MULTIPLE", 4.0))
SPIKE_MIN_SAMPLES = 8
SPIKE_WINDOW = 64
# Flight events attached to a spike anomaly as the exemplar context.
SPIKE_EXEMPLAR_EVENTS = 8

CELL_CV_G = REGISTRY.gauge(
    "llm_run_cell_cv",
    "Run-to-run coefficient of variation of one study cell, by metric "
    "(energy_J: modelled Joules; wall_s: request wall time). The study "
    "targets <= 0.05",
    labels=("metric", "model", "length", "location"),
)
CELL_RUNS_G = REGISTRY.gauge(
    "llm_run_cell_runs",
    "Repetitions observed so far for one study cell",
    labels=("model", "length", "location"),
)
ANOMALY_C = REGISTRY.counter(
    "llm_anomaly_total",
    "Anomalies fired by the streaming detectors, by kind "
    "(cell_cv: a study cell's run-to-run CV breached the threshold; "
    "step_spike: a decode slice took a rolling-median multiple)",
    labels=("kind",),
)
GOODPUT_C = REGISTRY.counter(
    "llm_engine_goodput_tokens_total",
    "Generated tokens on rows that COMPLETED (retired eos/budget) — the "
    "numerator of the stepped decode path's goodput fraction",
)
STEPPED_C = REGISTRY.counter(
    "llm_engine_stepped_tokens_total",
    "Row-steps the stepped decode path executed (every batch-bucket row "
    "of every step: live, done-but-not-retired and padding rows alike) "
    "— the denominator of the goodput fraction",
)


def observe_slice_tokens(steps: int, bucket_rows: int) -> None:
    """Bill one decode slice's device work: ``steps`` loop iterations ran
    and each stepped all ``bucket_rows`` rows of the batch bucket."""
    if steps > 0 and bucket_rows > 0:
        STEPPED_C.inc(steps * bucket_rows)


def observe_retired_tokens(generated_tokens: int) -> None:
    """Credit a COMPLETED row's tokens as goodput (error/shutdown rows
    never credit — their tokens were wasted work by definition)."""
    if generated_tokens > 0:
        GOODPUT_C.inc(generated_tokens)


class Welford:
    """Streaming mean/variance (Welford 1962): one pass, O(1) state."""

    __slots__ = ("count", "mean", "_m2")

    def __init__(self) -> None:
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0

    def update(self, x: float) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        """Sample variance (n-1 denominator); 0 before two observations."""
        return self._m2 / (self.count - 1) if self.count > 1 else 0.0

    @property
    def std(self) -> float:
        return self.variance**0.5

    @property
    def cv(self) -> Optional[float]:
        """Coefficient of variation; None until two runs or at zero mean."""
        if self.count < 2 or self.mean == 0.0:
            return None
        return abs(self.std / self.mean)


class CellCvTracker:
    """Welford rolling CV per (model, length, location) study cell (see
    the module docstring). ``observe_run`` is the one entry point."""

    def __init__(
        self,
        threshold: float = CELL_CV_THRESHOLD,
        min_runs: int = CELL_CV_MIN_RUNS,
    ) -> None:
        self.threshold = threshold
        self.min_runs = min_runs
        self._lock = threading.Lock()
        # (metric, model, length, location) -> Welford
        self._cells: Dict[Tuple[str, str, str, str], Welford] = {}
        # cells currently in breach (re-arm only after recovery)
        self._breached: set = set()

    def observe_run(
        self,
        model: str,
        length,
        location: str,
        energy_J: Optional[float] = None,
        wall_s: Optional[float] = None,
    ) -> Dict[str, Optional[float]]:
        """Fold one run into its cell; returns {metric: cv} (values may
        be None while the cell has < 2 runs). No-op when telemetry is
        off."""
        out: Dict[str, Optional[float]] = {}
        if not enabled():
            return out
        model, length, location = str(model), str(length), str(location)
        samples = (("energy_J", energy_J), ("wall_s", wall_s))
        with self._lock:
            for metric, value in samples:
                if value is None:
                    continue
                key = (metric, model, length, location)
                cell = self._cells.get(key)
                if cell is None:
                    cell = self._cells[key] = Welford()
                cell.update(float(value))
                out[metric] = cell.cv
                if metric == "energy_J":
                    CELL_RUNS_G.labels(
                        model=model, length=length, location=location
                    ).set(cell.count)
                if cell.cv is None:
                    continue
                CELL_CV_G.labels(
                    metric=metric,
                    model=model,
                    length=length,
                    location=location,
                ).set(round(cell.cv, 6))
                if cell.count < self.min_runs:
                    continue
                if cell.cv > self.threshold:
                    if key not in self._breached:
                        self._breached.add(key)
                        self._fire_cell(key, cell)
                else:
                    self._breached.discard(key)
        return out

    def _fire_cell(
        self, key: Tuple[str, str, str, str], cell: Welford
    ) -> None:
        metric, model, length, location = key
        ANOMALY_C.labels(kind="cell_cv").inc()
        FLIGHT.emit(
            EV_ANOMALY,
            kind="cell_cv",
            metric=metric,
            model=model,
            length=length,
            location=location,
            cv=round(cell.cv or 0.0, 6),
            threshold=self.threshold,
            runs=cell.count,
            mean=round(cell.mean, 6),
        )

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state of every tracked cell (the /debug/state and
        mid-study introspection surface)."""
        with self._lock:
            return {
                "|".join(key): {
                    "runs": cell.count,
                    "mean": round(cell.mean, 6),
                    "cv": round(cell.cv, 6) if cell.cv is not None else None,
                    "breached": key in self._breached,
                }
                for key, cell in self._cells.items()
            }

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._cells.clear()
            self._breached.clear()


class SpikeDetector:
    """Rolling-median spike detection over a stream of durations (see
    the module docstring). One instance per monitored stream."""

    def __init__(
        self,
        name: str = "decode_slice",
        multiple: float = SPIKE_MEDIAN_MULTIPLE,
        min_samples: int = SPIKE_MIN_SAMPLES,
        window: int = SPIKE_WINDOW,
    ) -> None:
        self.name = name
        self.multiple = multiple
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._window: "deque[float]" = deque(maxlen=window)

    @staticmethod
    def _median(values) -> float:
        ordered = sorted(values)
        n = len(ordered)
        mid = n // 2
        return (
            ordered[mid]
            if n % 2
            else (ordered[mid - 1] + ordered[mid]) / 2.0
        )

    def observe(self, dur_s: float, trace: Optional[int] = None) -> bool:
        """Fold one duration in; returns True (and fires the anomaly)
        when it is a spike against the PRIOR window. Spikes are excluded
        from the window so one outlier cannot drag the median up and
        mask its successors. No-op when telemetry is off."""
        if not enabled():
            return False
        with self._lock:
            is_spike = False
            median = 0.0
            if len(self._window) >= self.min_samples:
                median = self._median(self._window)
                is_spike = median > 0 and dur_s > self.multiple * median
            if not is_spike:
                self._window.append(dur_s)
        if is_spike:
            ANOMALY_C.labels(kind="step_spike").inc()
            # the exemplar: what the recorder saw just before the spike —
            # the joins/slices/retirements the histogram cannot name
            exemplar = [
                {"seq": e["seq"], "type": e["type"], "trace": e.get("trace")}
                for e in FLIGHT.events(n=SPIKE_EXEMPLAR_EVENTS)
            ]
            FLIGHT.emit(
                EV_ANOMALY,
                trace=trace,
                kind="step_spike",
                stream=self.name,
                dur_s=round(dur_s, 6),
                median_s=round(median, 6),
                multiple=self.multiple,
                exemplar=exemplar,
            )
        return is_spike

    def reset(self) -> None:
        with self._lock:
            self._window.clear()


# Process-wide instances: the study's cell tracker and the serving
# path's slice-time monitor (the continuous scheduler feeds it).
CELL_CV = CellCvTracker()
SLICE_SPIKES = SpikeDetector("decode_slice")
