"""Exhaustive probe of every measured-energy channel this host could offer.

The reference's meter is CodeCarbon (Plugins/Profilers/CodecarbonWrapper.py:
43-99), which on Linux reads the same RAPL counters probed here — and, on
hosts *without* RAPL, silently falls back to a TDP × load *model* (its
documented "constant consumption" mode). So "measured vs modelled" is a
property of the host, not the framework, for the reference too.

This module makes that property explicit and auditable: it probes every
channel the framework knows how to read, records exactly why each one is or
isn't usable, and the study writes the result next to the run table
(``energy_channels.json``) so a reader of a modelled-only table can see
that measurement was attempted and what the host lacked — the honest
equivalent of CodeCarbon's silent fallback.

Channels probed:
  - host RAPL package counters (/sys/class/powercap/intel-rapl:*)
  - hwmon power/energy sensors (/sys/class/hwmon/*/power*_input)
  - battery discharge rate (/sys/class/power_supply/*/power_now)
  - NVIDIA GPU energy and power through NVML (``libnvidia-ml.so.1``;
    what ``profilers/nvml.py::NvmlEnergyProfiler`` reads)
  - the GPU's duty cycle through NVML's utilization rates (what
    :class:`NvmlDutyCycleProfiler`, defined here, samples)
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

from .base import Profiler
from .nvml import NvmlError, all_devices


@dataclasses.dataclass
class ChannelStatus:
    name: str
    kind: str  # "energy" | "power" | "utilization"
    scope: str  # "host" | "device"
    available: bool
    detail: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _probe_rapl() -> ChannelStatus:
    domains = sorted(glob.glob("/sys/class/powercap/intel-rapl:*"))
    if not domains:
        detail = (
            "no /sys/class/powercap/intel-rapl:* domains (powercap absent "
            "in this kernel/container)"
            if not os.path.isdir("/sys/class/powercap")
            else "powercap present but no intel-rapl domains"
        )
        return ChannelStatus("rapl", "energy", "host", False, detail)
    readable = [
        d
        for d in domains
        if os.access(os.path.join(d, "energy_uj"), os.R_OK)
    ]
    if not readable:
        return ChannelStatus(
            "rapl", "energy", "host", False,
            f"{len(domains)} domains but energy_uj unreadable (permissions)",
        )
    return ChannelStatus(
        "rapl", "energy", "host", True, f"{len(readable)} readable domains"
    )


def _readable_int(path: str) -> bool:
    try:
        with open(path) as f:
            int(f.read().strip())
        return True
    except (OSError, ValueError):
        return False


def _probe_hwmon() -> ChannelStatus:
    # availability mirrors what SysfsPowerProfiler actually CONSUMES:
    # one readable power*_input per hwmon device (multi-rail boards are
    # deliberately not summed within a device — ADVICE round-4; the
    # shared selector keeps probe and profiler in lockstep).
    # energy*_input files are reported in the detail but do not make the
    # channel available — prepare's cooldown promise must match the
    # study's wiring, not the glob.
    from .sysfs_power import select_hwmon_sensors

    consumed = select_hwmon_sensors()
    all_power = sorted(
        p
        for p in glob.glob("/sys/class/hwmon/hwmon*/power*_input")
        if _readable_int(p)
    )
    energy_only = sorted(glob.glob("/sys/class/hwmon/hwmon*/energy*_input"))
    if not consumed:
        if energy_only:
            detail = (
                f"{len(energy_only)} energy*_input sensor(s) present but "
                "no readable power*_input - no profiler consumes "
                "energy-counter hwmon yet"
            )
        elif not os.path.isdir("/sys/class/hwmon"):
            detail = "no /sys/class/hwmon at all"
        else:
            detail = "hwmon present but no readable power sensors"
        return ChannelStatus("hwmon", "power", "host", False, detail)
    detail = f"{len(consumed)} device rail(s) consumed"
    if len(all_power) > len(consumed):
        detail += (
            f" (of {len(all_power)} readable sensors - one per hwmon "
            "device to avoid double-counting hierarchical rails)"
        )
    return ChannelStatus("hwmon", "power", "host", True, detail)


def _probe_battery() -> ChannelStatus:
    # same consumer-mirroring rule: power_now, else the current_now ×
    # voltage_now pair SysfsPowerProfiler falls back to — and, like the
    # consumer, a supply only counts while DISCHARGING: on AC the
    # reading is charger flow, not system load (ADVICE round-4 medium),
    # and the per-supply status is emitted in the detail either way.
    from .sysfs_power import battery_is_discharging, battery_status

    def _status_detail(paths) -> str:
        return ", ".join(
            f"{os.path.basename(os.path.dirname(p))}="
            f"{battery_status(p) or 'no-status-file'}"
            for p in paths
        )

    paths = sorted(
        p
        for p in glob.glob("/sys/class/power_supply/*/power_now")
        if _readable_int(p)
    )
    if not paths:
        paths = sorted(
            cur
            for cur in glob.glob("/sys/class/power_supply/*/current_now")
            if _readable_int(cur)
            and _readable_int(
                os.path.join(os.path.dirname(cur), "voltage_now")
            )
        )
        source = " (current_now x voltage_now)"
    else:
        source = ""
    if not paths:
        return ChannelStatus(
            "battery", "power", "host", False, "no power_supply devices"
        )
    discharging = [p for p in paths if battery_is_discharging(p)]
    if discharging:
        return ChannelStatus(
            "battery", "power", "host", True,
            f"{len(discharging)}/{len(paths)} supplies discharging"
            f"{source}: {_status_detail(paths)}",
        )
    return ChannelStatus(
        "battery", "power", "host", False,
        f"on AC - charger flow, not system load{source}: "
        f"{_status_detail(paths)}",
    )


def _probe_nvml() -> ChannelStatus:
    # consumer-mirroring: NvmlEnergyProfiler needs the library, a device
    # and a readable energy counter; the power limit is reported beside.
    try:
        devices = all_devices()
    except NvmlError as exc:
        return ChannelStatus("nvml", "energy", "device", False, str(exc))
    if not devices:
        return ChannelStatus("nvml", "energy", "device", False, "NVML loads but sees no device")
    parts = []
    counters = 0
    for i, dev in enumerate(devices):
        try:
            name = dev.name()
        except NvmlError as exc:
            parts.append(f"{i}: {exc}")
            continue
        try:
            dev.total_energy_mj()
            energy = "energy counter supported"
            counters += 1
        except NvmlError as exc:
            energy = f"energy counter unsupported ({exc})"
        try:
            limit = f"power limit {dev.power_limit_w():.2f} W"
        except NvmlError as exc:
            limit = f"power limit unread ({exc})"
        parts.append(f"{i}: {name}, {energy}, {limit}")
    return ChannelStatus(
        "nvml", "energy", "device", counters > 0,
        f"{len(devices)} device(s); " + "; ".join(parts),
    )


def _probe_nvml_utilization() -> ChannelStatus:
    # consumer-mirroring: NvmlDutyCycleProfiler needs a device whose
    # utilization rates read
    try:
        devices = all_devices()
    except NvmlError as exc:
        return ChannelStatus("nvml_utilization", "utilization", "device", False, str(exc))
    parts = []
    reading = 0
    for i, dev in enumerate(devices):
        try:
            parts.append(f"{i}: duty cycle {dev.utilization_pct()}%")
            reading += 1
        except NvmlError as exc:
            parts.append(f"{i}: utilization unread ({exc})")
    if not devices:
        parts.append("NVML loads but sees no device")
    return ChannelStatus(
        "nvml_utilization", "utilization", "device", reading > 0, "; ".join(parts),
    )


def probe_energy_channels(include_device: bool = True) -> List[ChannelStatus]:
    """Probe every channel; never raises. ``include_device=False`` skips
    the accelerator-touching probes, as an HTTP-client experiment process
    whose serving process owns the card requires."""
    statuses = [
        _probe_rapl(),
        _probe_hwmon(),
        _probe_battery(),
    ]
    if include_device:
        statuses += [_probe_nvml(), _probe_nvml_utilization()]
    else:
        skip = "skipped: a separate serving process owns the accelerator"
        statuses += [
            ChannelStatus("nvml", "energy", "device", False, skip),
            ChannelStatus("nvml_utilization", "utilization", "device", False, skip),
        ]
    return statuses


def write_probe_report(
    path: Path, include_device: bool = True
) -> List[ChannelStatus]:
    """Probe and persist ``energy_channels.json`` next to the run table, so
    a modelled-only table is auditable (which channels were tried, why each
    was unavailable)."""
    statuses = probe_energy_channels(include_device=include_device)
    payload = {
        "channels": [s.as_dict() for s in statuses],
        "any_measured_energy": any(
            s.available and s.kind in ("energy", "power") for s in statuses
        ),
        "note": (
            "When no energy/power channel is available the study's energy "
            "columns are modelled (energy_model_J) from measured duration "
            "and achieved FLOPs — the same fallback class CodeCarbon "
            "applies on RAPL-less hosts (TDP x load)."
        ),
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2))
    return statuses




class NvmlDutyCycleProfiler(Profiler):
    """The card's measured duty cycle, sampled through NVML.

    The counterpart of the JAX package's ``TpuDutyCycleProfiler``: each
    sample is ``nvmlDeviceGetUtilizationRates(...).gpu``, the percent of
    NVML's last sample period in which a kernel ran, on the engine's card
    only (the current CUDA device, found by its PCI bus id). Power is
    ``P = idle + duty · (peak − idle)`` over the sampled span, with the
    energy model's envelope (``profilers/nvml.py``'s H100_IDLE_W and
    H100_PEAK_W) by default, so ``energy_duty_J`` and ``energy_model_J``
    compare directly. The columns stay apart from NVML's measured Joules
    (``gpu_energy_J``): a duty-cycle figure is a utilisation reading priced
    by a model.

    NVML averages its utilization over a driver period of 1/6 s to 1 s: a
    window with fewer than two readings gives None, as the JAX rule does.
    ``source`` injects a device-like reader (``utilization_pct()``). A
    :class:`Profiler`, so that the runner's config check takes it (the
    JAX profiler is not one).
    """

    data_columns = ("gpu_duty_cycle_pct", "energy_duty_J")
    measured_channel = True

    def __init__(
        self,
        period_s: float = 0.25,
        peak_w: Optional[float] = None,
        idle_w: Optional[float] = None,
        source: Optional[Any] = None,
    ) -> None:
        from .nvml import H100_IDLE_W, H100_PEAK_W

        self.peak_w = H100_PEAK_W if peak_w is None else peak_w
        self.idle_w = H100_IDLE_W if idle_w is None else idle_w
        self._source = source
        self._opened = source is not None
        self.unavailable_reason: Optional[str] = None
        from .base import SamplingProfiler

        outer = self

        class _Sampler(SamplingProfiler):
            artifact_name = "gpu_duty_cycle"
            data_columns = outer.data_columns

            def sample(self) -> Dict[str, Any]:
                reading = outer._read_duty()
                if reading is None:
                    return {"duty_pct": None, "n_chips": None}
                return {"duty_pct": reading[0], "n_chips": reading[1]}

            def summarise(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
                pts = [
                    (s["t_s"], float(s["duty_pct"]), int(s["n_chips"]))
                    for s in samples
                    if s.get("duty_pct") is not None
                ]
                if len(pts) < 2:
                    return {"gpu_duty_cycle_pct": None, "energy_duty_J": None}
                span = pts[-1][0] - pts[0][0]
                mean_duty = sum(p for _, p, _ in pts) / len(pts) / 100.0
                n_chips = max(n for _, _, n in pts)
                energy = (outer.idle_w + mean_duty * (outer.peak_w - outer.idle_w)) * n_chips * span
                return {
                    "gpu_duty_cycle_pct": round(mean_duty * 100.0, 2),
                    "energy_duty_J": round(energy, 4),
                }

        self._impl = _Sampler(period_s=period_s)

    def device(self) -> Optional[Any]:
        """The card's reader, opened on first use (from the thread that
        owns the engine's card); None when NVML or the device is absent."""
        if not self._opened:
            self._opened = True
            try:
                from .nvml import nvml_device

                self._source = nvml_device()
            except NvmlError as exc:
                self.unavailable_reason = str(exc)
        return self._source

    def _read_duty(self) -> "Optional[tuple[float, int]]":
        """(duty %, 1: the one card sampled), or None."""
        dev = self.device()
        if dev is None:
            return None
        try:
            return float(dev.utilization_pct()), 1
        except Exception as exc:  # noqa: BLE001 - a reader that cannot read is unavailable
            self.unavailable_reason = f"{type(exc).__name__}: {exc}"
            return None

    @property
    def available(self) -> bool:
        return self._read_duty() is not None

    # the Profiler contract, delegated
    def on_start(self, context) -> None:
        self.device()  # open it here, not in the sampler thread
        self._impl.on_start(context)

    def on_stop(self, context) -> None:
        self._impl.on_stop(context)

    def collect(self, context) -> Dict[str, Any]:
        return self._impl.collect(context)
