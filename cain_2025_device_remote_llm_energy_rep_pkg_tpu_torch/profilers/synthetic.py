"""Deterministic synthetic power profiler for hermetic tests.

SURVEY.md §4 calls for "a fake energy sampler (synthetic power trace) so the
full lifecycle runs hermetically" — the reference has no test suite and no
fake backends at all. The trace is a deterministic function of time
(``base_w + amp_w·sin``) so integrated Joules are predictable to the test.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

from .base import SamplingProfiler, integrate_power_to_joules


class SyntheticPowerProfiler(SamplingProfiler):
    data_columns = ("energy_J", "avg_power_W")
    artifact_name = "synthetic_power"

    def __init__(self, period_s: float = 0.01, base_w: float = 10.0, amp_w: float = 0.0) -> None:
        super().__init__(period_s=period_s)
        self.base_w = base_w
        self.amp_w = amp_w

    def sample(self) -> Dict[str, Any]:
        import time

        t = time.monotonic() - self._t0
        return {"power_W": self.base_w + self.amp_w * math.sin(t)}

    def summarise(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        joules = integrate_power_to_joules(samples, "power_W")
        span = samples[-1]["t_s"] - samples[0]["t_s"] if len(samples) > 1 else 0.0
        avg = joules / span if span > 0 else self.base_w
        return {"energy_J": round(joules, 6), "avg_power_W": round(avg, 3)}
