"""Per-run ``torch.profiler`` trace plugin.

The counterpart of the JAX package's ``profilers/jax_trace.py``: the
device-side twin of the reference's per-run raw artifacts
(powermetrics.txt, cpu_mem_usage.csv). Wraps the measurement window in
``torch.profiler.profile``, started at ``on_start`` and stopped at
``on_stop``, and writes the trace as Chrome trace events to
``<run_dir>/torch_trace/trace.json`` (Perfetto, chrome://tracing). It
records the card's kernels whenever CUDA is present. Opt-in: traces are
large, so attach it to debugging runs, not to the 1,260-run sweep.

``torch.profiler`` can lose a trace's device records (the port's
``scripts/torch_profiler_loss.py`` counts how often): read a trace for
the kernels it names, not for exact counts.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ..runner import term
from ..runner.context import RunContext
from .base import Profiler


class TorchTraceProfiler(Profiler):
    data_columns = ("trace_dir",)

    def __init__(self, activities: Optional[Sequence[Any]] = None) -> None:
        """``activities``: ``torch.profiler.ProfilerActivity`` values; by
        default the CPU, and CUDA when a card is present."""
        self.activities = activities
        self._prof = None
        self._dir: str = ""
        self._wrote = False

    def on_start(self, context: RunContext) -> None:
        self._dir = str(context.run_dir / "torch_trace")
        self._wrote = False
        self._prof = None
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = self.activities
            if activities is None:
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=list(activities))
            prof.start()
            self._prof = prof
        except Exception as exc:  # noqa: BLE001 - platform-dependent
            term.log_warn(f"torch trace unavailable: {exc}")

    def on_stop(self, context: RunContext) -> None:
        if self._prof is None:
            return
        from pathlib import Path

        try:
            self._prof.stop()
            path = Path(self._dir)
            path.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(path / "trace.json"))
            self._wrote = True
        except Exception as exc:  # noqa: BLE001 - a failed export claims no trace
            term.log_warn(f"torch trace not written: {exc}")
        finally:
            self._prof = None

    def collect(self, context: RunContext) -> Dict[str, Any]:
        # Only claim a trace that was written: a failed start or export
        # must not put a phantom path in the run table.
        return {"trace_dir": self._dir if self._wrote else None}
