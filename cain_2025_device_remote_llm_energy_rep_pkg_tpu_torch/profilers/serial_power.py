"""External wall-power meter profiler (serial line protocol).

Reference: ``Plugins/Profilers/WattsUpPro.py`` — a pyserial driver for the
"Watts Up? Pro" socket meter at 115200 baud parsing ``#d`` frames into
W/V/A rows (:45-73; present but unused by the study, Plugins/README.md:78).
Here the same capability is a standard three-phase profiler: a reader thread
collects frames during the measurement window, Joules come from the trapezoid
integral, and the frame parser is dependency-injectable so the protocol is
testable without hardware (pyserial may be absent in this image — the
profiler then reports None columns).

A copy of the JAX package's module (no framework code).

Frame format accepted by the default parser (WattsUp '#d' records):
``#d,_,_,W*10,V*10,mA,...`` — watts arrive in tenths.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..runner import term
from ..runner.context import RunContext
from .base import Profiler, integrate_power_to_joules


def parse_wattsup_frame(line: str) -> Optional[Dict[str, float]]:
    """'#d,...' → {"power_W", "volts_V", "amps_A"}; None for other frames."""
    line = line.strip()
    if not line.startswith("#d"):
        return None
    parts = line.split(",")
    if len(parts) < 6:
        return None
    try:
        return {
            "power_W": float(parts[3]) / 10.0,
            "volts_V": float(parts[4]) / 10.0,
            "amps_A": float(parts[5]) / 1000.0,
        }
    except ValueError:
        return None


class SerialPowerMeterProfiler(Profiler):
    data_columns = ("wall_energy_J", "wall_avg_power_W")
    artifact_name = "wall_power"
    measured_channel = True

    def __init__(
        self,
        port: str = "/dev/ttyUSB0",
        baudrate: int = 115_200,
        parser: Callable[[str], Optional[Dict[str, float]]] = parse_wattsup_frame,
        reader_factory: Optional[Callable[[], Any]] = None,
    ) -> None:
        """``reader_factory`` returns an object with ``readline() -> bytes``
        and ``close()``; defaults to a pyserial connection to ``port``."""
        self.port = port
        self.baudrate = baudrate
        self.parser = parser
        self._reader_factory = reader_factory
        self._reader: Any = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._samples: List[Dict[str, Any]] = []
        self._t0 = 0.0

    def _default_reader(self):
        try:
            import serial  # type: ignore
        except ImportError:
            return None
        try:
            conn = serial.Serial(self.port, self.baudrate, timeout=1.0)
            # meter into external-logging mode, 1 s interval (the reference
            # sends the same '#L,W,3,E,<reserved>,<interval>' command,
            # WattsUpPro.py:39-43)
            conn.write(b"#L,W,3,E,,1;")
            return conn
        except Exception as exc:  # pragma: no cover - hardware-dependent
            term.log_warn(f"serial power meter unavailable on {self.port}: {exc}")
            return None

    def on_start(self, context: RunContext) -> None:
        self._samples = []
        self._stop.clear()
        self._t0 = time.monotonic()
        factory = self._reader_factory or self._default_reader
        self._reader = factory()
        if self._reader is None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serial-power-reader", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                raw = self._reader.readline()
            except Exception:
                return
            if not raw:
                continue
            line = raw.decode("ascii", errors="replace") if isinstance(raw, bytes) else raw
            reading = self.parser(line)
            if reading is not None:
                reading["t_s"] = time.monotonic() - self._t0
                self._samples.append(reading)

    def on_stop(self, context: RunContext) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            self._thread = None
        if self._reader is not None:
            try:
                self._reader.close()
            except Exception:
                pass
            self._reader = None
        if self._samples:
            import csv

            path = context.run_dir / f"{self.artifact_name}.csv"
            with path.open("w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(self._samples[0].keys()))
                writer.writeheader()
                writer.writerows(self._samples)

    def collect(self, context: RunContext) -> Dict[str, Any]:
        if len(self._samples) < 2:
            return {"wall_energy_J": None, "wall_avg_power_W": None}
        joules = integrate_power_to_joules(self._samples, "power_W")
        span = self._samples[-1]["t_s"] - self._samples[0]["t_s"]
        return {
            "wall_energy_J": round(joules, 4),
            "wall_avg_power_W": round(joules / span, 3) if span > 0 else None,
        }
