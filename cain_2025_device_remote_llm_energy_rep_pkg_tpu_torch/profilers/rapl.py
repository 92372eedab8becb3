"""Host CPU package energy via Linux RAPL counters.

Replaces the reference's CodeCarbon dependency (CodecarbonWrapper.py) with a
direct read of ``/sys/class/powercap/intel-rapl*/energy_uj`` — the same
counters CodeCarbon itself reads on Linux — with no third-party library.
Cumulative microjoule counters are snapshotted at window open/close; wrap-
around is corrected with ``max_energy_range_uj``.

On hosts without RAPL (no permission, non-x86) every column is None; the
experiment still runs (the reference hard-fails if codecarbon is missing).
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from .base import Profiler
from ..runner.context import RunContext

RAPL_GLOB = "/sys/class/powercap/intel-rapl:*"


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


class RaplEnergyProfiler(Profiler):
    data_columns = ("host_energy_J", "host_avg_power_W")

    def __init__(self, rapl_glob: str = RAPL_GLOB) -> None:
        self._domains = sorted(
            d for d in glob.glob(rapl_glob) if os.path.exists(os.path.join(d, "energy_uj"))
        )
        self._start: List[Tuple[str, int]] = []
        self._t0 = 0.0
        self._energy_uj: Optional[int] = None
        self._elapsed_s: float = 0.0

    @property
    def available(self) -> bool:
        return bool(self._domains) and _read_int(
            os.path.join(self._domains[0], "energy_uj")
        ) is not None

    @property
    def measured_channel(self) -> bool:  # real host Joules when readable
        return self.available

    def on_start(self, context: RunContext) -> None:
        self._t0 = time.monotonic()
        self._start = []
        for d in self._domains:
            v = _read_int(os.path.join(d, "energy_uj"))
            if v is not None:
                self._start.append((d, v))

    def on_stop(self, context: RunContext) -> None:
        self._elapsed_s = time.monotonic() - self._t0
        total_uj = 0
        any_read = False
        for d, v0 in self._start:
            v1 = _read_int(os.path.join(d, "energy_uj"))
            if v1 is None:
                continue
            delta = v1 - v0
            if delta < 0:  # counter wrapped
                rng = _read_int(os.path.join(d, "max_energy_range_uj"))
                if rng:
                    delta += rng
                else:
                    continue
            total_uj += delta
            any_read = True
        self._energy_uj = total_uj if any_read else None

    def collect(self, context: RunContext) -> Dict[str, Any]:
        if self._energy_uj is None:
            return {"host_energy_J": None, "host_avg_power_W": None}
        joules = self._energy_uj / 1e6
        watts = joules / self._elapsed_s if self._elapsed_s > 0 else None
        return {
            "host_energy_J": round(joules, 4),
            "host_avg_power_W": round(watts, 3) if watts is not None else None,
        }
