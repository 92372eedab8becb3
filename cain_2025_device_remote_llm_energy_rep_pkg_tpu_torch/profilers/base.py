"""The profiler plugin contract and a sampling-thread base class.

Reference mechanism being generalised: CodeCarbon's three hook points —
start tracker in START_MEASUREMENT (CodecarbonWrapper.py:43-59), stop in
STOP_MEASUREMENT (:61-68), inject ``codecarbon__*`` columns in
POPULATE_RUN_DATA (:82-99) — and the hand-rolled psutil polling loop in the
reference experiment (experiment/RunnerConfig.py:153-178), which blocked the
run because it sampled on the main thread. :class:`SamplingProfiler` moves
sampling to a daemon thread so the measured activity and the sampler are
independent (fixing the "interact is dead code" quirk, SURVEY.md §7).
"""

from __future__ import annotations

import csv
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..runner.context import RunContext


class Profiler:
    """Base profiler: three phases around the measurement window.

    - ``on_start(context)``  — measurement window opens (before the user's
      ``start_measurement`` hook runs).
    - ``on_stop(context)``   — window closes (after the user's
      ``stop_measurement`` hook).
    - ``collect(context)``   — return ``{column: value}`` for the run row;
      keys must be in ``data_columns``.

    ``data_columns`` are appended to the run table at generation time
    (reference: CodecarbonWrapper.py:70-80).
    """

    data_columns: Sequence[str] = ()
    # True when this profiler reads real hardware energy/power/utilisation
    # counters (vs deriving modelled values). Drives the experiment's
    # cooldown policy: measured channels need the reference's 90 s thermal
    # discipline (a hot chip throttles and skews real Joules); modelled
    # energy is thermal-state-free.
    measured_channel: bool = False

    def on_start(self, context: RunContext) -> None:  # pragma: no cover - trivial
        pass

    def on_stop(self, context: RunContext) -> None:  # pragma: no cover - trivial
        pass

    def collect(self, context: RunContext) -> Dict[str, Any]:
        return {}


class SamplingProfiler(Profiler):
    """A profiler that polls ``sample()`` on a daemon thread at a fixed period.

    Subclasses implement ``sample() -> dict`` (one reading) and
    ``summarise(samples) -> dict`` (run-table values). Raw samples are written
    to ``<run_dir>/<artifact_name>.csv`` — the per-run artifact convention the
    reference uses for ``cpu_mem_usage.csv`` and ``powermetrics.txt``
    (experiment/RunnerConfig.py:147-151,140-143).
    """

    artifact_name: str = "samples"

    def __init__(self, period_s: float = 0.1) -> None:
        self.period_s = period_s
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._samples: List[Dict[str, Any]] = []
        self._t0: float = 0.0

    # -- subclass surface -----------------------------------------------------
    def sample(self) -> Dict[str, Any]:
        raise NotImplementedError

    def summarise(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        raise NotImplementedError

    # -- Profiler interface ---------------------------------------------------
    def on_start(self, context: RunContext) -> None:
        self._samples = []
        self._stop_event.clear()
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name=f"{type(self).__name__}-sampler", daemon=True
        )
        self._thread.start()

    def on_stop(self, context: RunContext) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        # One final reading so even a window shorter than the period has data.
        self._take_sample()
        self._write_artifact(context)

    def collect(self, context: RunContext) -> Dict[str, Any]:
        return self.summarise(self._samples)

    # -- internals ------------------------------------------------------------
    def _take_sample(self) -> None:
        reading = self.sample()
        reading.setdefault("t_s", time.monotonic() - self._t0)
        self._samples.append(reading)

    def _loop(self) -> None:
        while not self._stop_event.wait(self.period_s):
            self._take_sample()

    def _write_artifact(self, context: RunContext) -> None:
        if not self._samples:
            return
        path = context.run_dir / f"{self.artifact_name}.csv"
        columns = list(self._samples[0].keys())
        with path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns)
            writer.writeheader()
            writer.writerows(self._samples)


def integrate_power_to_joules(samples: List[Dict[str, Any]], power_key: str) -> float:
    """Trapezoidal ∫W·dt over a sample trace → Joules.

    The reference never integrates itself (CodeCarbon reports kWh which the
    experiment converts ×3.6e6, experiment/RunnerConfig.py:250-259); a
    device's power samples are integrated here.
    """
    pts = [(s["t_s"], float(s[power_key])) for s in samples if s.get(power_key) is not None]
    if len(pts) < 2:
        return 0.0
    joules = 0.0
    for (t0, w0), (t1, w1) in zip(pts, pts[1:]):
        joules += 0.5 * (w0 + w1) * (t1 - t0)
    return joules
