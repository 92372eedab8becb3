"""Host CPU / memory sampling profiler.

Reference: the hand-rolled psutil loop in ``experiment/RunnerConfig.py:153-178``
(cpu_percent(interval=0.1) + virtual_memory().percent roughly every 1.1 s,
streamed to ``run_dir/cpu_mem_usage.csv``, means reported in
populate_run_data :227-233). Here it is a SamplingProfiler on a daemon thread
with a non-blocking cpu_percent call.
"""

from __future__ import annotations

from typing import Any, Dict, List

from .base import SamplingProfiler

try:
    import psutil
except ImportError:  # pragma: no cover - psutil is a baked-in dep
    psutil = None


def _mean(values: List[float]) -> float:
    return sum(values) / len(values) if values else 0.0


class HostResourceProfiler(SamplingProfiler):
    # Same column set as NativeHostProfiler's cpu/mem/rate subset so swapping
    # implementations never changes the run-table schema (resume's
    # column-equality check would otherwise refuse a restart on a host where
    # the native sampler's availability flipped).
    data_columns = ("cpu_usage", "memory_usage", "host_sample_rate_hz")
    artifact_name = "cpu_mem_usage"

    def __init__(self, period_s: float = 0.5) -> None:
        super().__init__(period_s=period_s)
        if psutil is not None:
            psutil.cpu_percent(interval=None)  # prime the non-blocking counter

    def sample(self) -> Dict[str, Any]:
        if psutil is None:
            return {"cpu_percent": None, "memory_percent": None}
        return {
            "cpu_percent": psutil.cpu_percent(interval=None),
            "memory_percent": psutil.virtual_memory().percent,
        }

    def summarise(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        cpu = [s["cpu_percent"] for s in samples if s["cpu_percent"] is not None]
        mem = [s["memory_percent"] for s in samples if s["memory_percent"] is not None]
        span = samples[-1]["t_s"] - samples[0]["t_s"] if len(samples) > 1 else 0.0
        rate = round((len(samples) - 1) / span, 1) if span > 0 else None
        return {
            "cpu_usage": round(_mean(cpu), 3),
            "memory_usage": round(_mean(mem), 3),
            "host_sample_rate_hz": rate,
        }
