"""Host power via generic Linux sysfs sensors: hwmon and battery.

The channel probe (``energy_probe.py``) has always AUDITED these two
sources; this profiler makes them CONSUMED, so a laptop/VM whose only
measured channel is a hwmon power rail or the battery's discharge rate
records real Watts instead of falling back to the modelled column (a
live channel must change the study, not just the audit).

Two source families, probed in priority order:

- **hwmon** (``/sys/class/hwmon/hwmon*/power*_input``, microwatts):
  board/CPU power rails. ONE sensor per hwmon device (the lowest-indexed
  readable ``power*_input``) — boards exposing hierarchical rails from
  one chip (package plus per-core) must not be double-counted (the
  reference's CodeCarbon likewise restricts itself to the RAPL package
  domain). Distinct hwmon devices (separate chips) still
  sum.
- **battery** (``/sys/class/power_supply/*/power_now``, microwatts,
  falling back to ``current_now``·``voltage_now``): the discharge rate.
  Only meaningful on battery power: on AC the reading is charger/charge
  flow, not system load, so a supply is sampled
  ONLY while its sibling ``status`` file reads "Discharging" — checked
  per sample, so plugging in mid-run stops the channel instead of
  polluting it — and counts toward availability (and therefore the 90 s
  measured-channel cooldown) only when discharging at construction. A
  supply with no ``status`` file is treated as discharging (unknown —
  the audit detail says so).

The reference's CodeCarbon meter does the same class of fallback chain
internally (RAPL → psutil estimates); here each hop is a separate,
auditable profiler. Columns reuse the host-power names the RAPL/native
profilers emit (``wall_energy_J``-style naming is reserved for the
serial meter): ``sysfs_energy_J`` / ``sysfs_avg_power_W`` so a host with
BOTH RAPL and hwmon keeps the two measurements distinguishable.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional

from .base import SamplingProfiler, integrate_power_to_joules

HWMON_GLOB = "/sys/class/hwmon/hwmon*/power*_input"
BATTERY_GLOB = "/sys/class/power_supply/*/power_now"


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _sensor_index(path: str) -> int:
    """Numeric index of a ``power<N>_input`` file (fallback: a large
    sentinel). Lexicographic sort would place power10 before power1."""
    import re

    m = re.search(r"power(\d+)_input$", path)
    return int(m.group(1)) if m else 1 << 30


def select_hwmon_sensors(hwmon_glob: str = HWMON_GLOB) -> List[str]:
    """One readable ``power*_input`` per hwmon DEVICE (lowest NUMERIC
    index — by hwmon convention the first sensor is the
    top-level/package rail). Shared by the profiler and the channel
    probe so prepare's audit mirrors exactly what the study consumes."""
    by_device: Dict[str, str] = {}
    for p in sorted(glob.glob(hwmon_glob), key=lambda p: (os.path.dirname(p), _sensor_index(p))):
        if _read_int(p) is None:
            continue
        by_device.setdefault(os.path.dirname(p), p)
    return sorted(by_device.values())


def battery_status(supply_file: str) -> Optional[str]:
    """Charge status from the supply's sibling ``status`` file
    (Discharging / Charging / Full / ...), or None when absent."""
    try:
        with open(os.path.join(os.path.dirname(supply_file), "status")) as f:
            return f.read().strip()
    except OSError:
        return None


def battery_is_discharging(supply_file: str) -> bool:
    """Whether the supply's reading is system load rather than charger
    flow: status "Discharging", or no status file at all (unknown — the
    audit detail flags that case)."""
    status = battery_status(supply_file)
    return status is None or status == "Discharging"


class SysfsPowerProfiler(SamplingProfiler):
    """Samples summed hwmon power rails, else battery discharge power."""

    data_columns = ("sysfs_energy_J", "sysfs_avg_power_W")
    artifact_name = "sysfs_power"
    measured_channel = True

    def __init__(
        self,
        period_s: float = 0.1,
        hwmon_glob: Optional[str] = None,
        battery_glob: Optional[str] = None,
    ) -> None:
        super().__init__(period_s=period_s)
        # late-bound module constants so tests (and operators) can point
        # the default construction at a fake/alternate sysfs tree
        hwmon_glob = HWMON_GLOB if hwmon_glob is None else hwmon_glob
        battery_glob = BATTERY_GLOB if battery_glob is None else battery_glob
        self._hwmon = select_hwmon_sensors(hwmon_glob)
        self._battery = sorted(
            p for p in glob.glob(battery_glob) if _read_int(p) is not None
        )
        # battery current*voltage fallback for kernels without power_now
        self._battery_iv = []
        if not self._battery:
            for cur in sorted(
                glob.glob(os.path.dirname(battery_glob) + "/current_now")
            ):
                volt = os.path.join(os.path.dirname(cur), "voltage_now")
                if _read_int(cur) is not None and _read_int(volt) is not None:
                    self._battery_iv.append((cur, volt))

    @property
    def available(self) -> bool:
        # A battery on AC is NOT an available measured channel: its
        # reading is charger flow, and availability here is what flips
        # the study to the 90 s measured-channel cooldown.
        return bool(
            self._hwmon
            or any(battery_is_discharging(p) for p in self._battery)
            or any(
                battery_is_discharging(cur) for cur, _ in self._battery_iv
            )
        )

    @staticmethod
    def _sum_microwatts(paths) -> Optional[float]:
        vals = [_read_int(p) for p in paths]
        vals = [v for v in vals if v is not None]
        return sum(vals) / 1e6 if vals else None

    def _power_w(self) -> Optional[float]:
        if self._hwmon:
            return self._sum_microwatts(self._hwmon)
        if self._battery:
            # status re-checked per sample: plugging into AC mid-run must
            # stop the channel (None samples), not record charger flow
            active = [p for p in self._battery if battery_is_discharging(p)]
            return self._sum_microwatts(active) if active else None
        if self._battery_iv:
            total = 0.0
            seen = False
            for cur, volt in self._battery_iv:
                if not battery_is_discharging(cur):
                    continue
                i, v = _read_int(cur), _read_int(volt)
                if i is not None and v is not None:
                    total += (i / 1e6) * (v / 1e6)
                    seen = True
            return total if seen else None
        return None

    def sample(self) -> Dict[str, Any]:
        return {"power_W": self._power_w()}

    def summarise(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        joules = integrate_power_to_joules(samples, "power_W")
        if joules == 0.0 and not any(s.get("power_W") for s in samples):
            return {"sysfs_energy_J": None, "sysfs_avg_power_W": None}
        span = samples[-1]["t_s"] - samples[0]["t_s"] if len(samples) > 1 else 0.0
        return {
            "sysfs_energy_J": round(joules, 4),
            "sysfs_avg_power_W": round(joules / span, 3) if span > 0 else None,
        }
