"""Profiler backed by the native C++ sampler (kHz host energy/CPU/memory).

Drop-in upgrade over :class:`~.host.HostResourceProfiler` +
:class:`~.rapl.RaplEnergyProfiler`: one native thread samples RAPL energy
counters, /proc/stat and /proc/meminfo at sub-millisecond capable rates into
a ring buffer; Python touches the data only at window close. Cumulative
counters (energy, jiffies) are differenced between *snapshots* taken at the
window edges, so a ring-buffer wrap on a long run cannot truncate them.

If the native library can't build or load at runtime, the profiler
transparently falls back to the psutil + RAPL Python implementations — the
column schema is identical either way, so run tables stay resumable across
hosts with and without a toolchain.
"""

from __future__ import annotations

import csv
import ctypes
from typing import Any, Dict, List, Optional

from ..native.build import load_sampler_library
from ..runner.context import RunContext
from .base import Profiler

_ROW_FIELDS = ("t_s", "energy_uj", "cpu_busy", "cpu_total", "mem_avail_kb")


class NativeHostProfiler(Profiler):
    data_columns = (
        "host_energy_J",
        "host_avg_power_W",
        "cpu_usage",
        "memory_usage",
        "host_sample_rate_hz",
    )
    artifact_name = "native_host_samples"

    @property
    def measured_channel(self) -> bool:
        """Real host Joules only where RAPL is readable — cpu/mem sampling
        alone is not an energy channel and must not trigger the 90 s
        thermal cooldown."""
        from .rapl import RaplEnergyProfiler

        return RaplEnergyProfiler().available

    def __init__(
        self,
        period_us: int = 1000,  # 1 kHz; the reference's Python loop: ~0.9 Hz
        capacity: int = 600_000,  # 10 min of ring retention at 1 kHz
        rapl_glob: str = "",
        write_artifact: bool = False,  # kHz traces are big; opt-in
    ) -> None:
        # Construction is deliberately side-effect-free: the g++ build and
        # the ring-buffer allocation happen on first use (_ensure), so merely
        # instantiating a config that lists this profiler costs nothing.
        self._period_us = period_us
        self._capacity = capacity
        self._rapl_glob = rapl_glob
        self._lib = None
        self._handle: Optional[int] = None
        self._ensured = False
        self.write_artifact = write_artifact
        self._rows: Any = None
        self._start_snap: Optional[List[float]] = None
        self._stop_snap: Optional[List[float]] = None
        self._fallback: Optional[List[Profiler]] = None

    def prepare(self) -> None:
        """Build the library and allocate the ring now, outside any
        measurement window. A profiler that starts before this one (the
        card's energy counter) would otherwise count the first run's g++
        build as that run's energy."""
        self._ensure()

    def _ensure(self) -> bool:
        if not self._ensured:
            self._ensured = True
            self._lib = load_sampler_library()
            if self._lib is not None:
                if not hasattr(self._lib, "sampler_snapshot"):
                    self._lib = None  # stale prebuilt library without snapshot
                else:
                    self._lib.sampler_snapshot.argtypes = [
                        ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_double),
                    ]
                    self._handle = self._lib.sampler_create(
                        self._period_us, self._capacity, self._rapl_glob.encode()
                    )
                    if not self._handle:
                        self._lib = None
            if self._handle is None:
                # Runtime fallback: same columns, Python implementations.
                from .host import HostResourceProfiler
                from .rapl import RaplEnergyProfiler

                self._fallback = [
                    HostResourceProfiler(period_s=0.2),
                    RaplEnergyProfiler(),
                ]
        return self._handle is not None

    @property
    def available(self) -> bool:
        """Cheap probe: a toolchain or a prebuilt library exists. The real
        build is deferred to first use (and failure falls back to Python)."""
        if self._ensured:
            return self._handle is not None
        import shutil

        from ..native.build import _BUILD_DIR

        return bool(shutil.which("g++")) or any(_BUILD_DIR.glob("*.so"))

    def _snapshot(self) -> List[float]:
        buf = (ctypes.c_double * 5)()
        self._lib.sampler_snapshot(self._handle, buf)
        return list(buf)

    def on_start(self, context: RunContext) -> None:
        self._rows = None
        self._start_snap = self._stop_snap = None
        if self._ensure():
            self._lib.sampler_start(self._handle)
            self._start_snap = self._snapshot()
        else:
            for p in self._fallback:
                p.on_start(context)

    def on_stop(self, context: RunContext) -> None:
        if self._handle is None:
            for p in self._fallback or []:
                p.on_stop(context)
            return
        self._lib.sampler_stop(self._handle)
        self._stop_snap = self._snapshot()
        n = self._lib.sampler_count(self._handle)
        if n > 0:
            buf = (ctypes.c_double * (n * 5))()
            got = self._lib.sampler_read(self._handle, buf, n)
            self._rows = [
                {f: buf[i * 5 + j] for j, f in enumerate(_ROW_FIELDS)}
                for i in range(got)
            ]
        if self.write_artifact and self._rows:
            path = context.run_dir / f"{self.artifact_name}.csv"
            with path.open("w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=_ROW_FIELDS)
                writer.writeheader()
                writer.writerows(self._rows)

    def collect(self, context: RunContext) -> Dict[str, Any]:
        none: Dict[str, Any] = {c: None for c in self.data_columns}
        if self._handle is None:
            out = dict(none)
            for p in self._fallback or []:
                out.update(p.collect(context))
            return out
        if self._start_snap is None or self._stop_snap is None:
            return none
        first = dict(zip(_ROW_FIELDS, self._start_snap))
        last = dict(zip(_ROW_FIELDS, self._stop_snap))
        span = last["t_s"] - first["t_s"]
        out = dict(none)
        rows = self._rows or []
        if len(rows) > 1:
            ring_span = rows[-1]["t_s"] - rows[0]["t_s"]
            if ring_span > 0:
                out["host_sample_rate_hz"] = round((len(rows) - 1) / ring_span, 1)
        # Cumulative counters come from the window-edge snapshots — immune to
        # ring wrap (RAPL counter wrap → negative delta: drop the column).
        if first["energy_uj"] >= 0 and last["energy_uj"] >= first["energy_uj"]:
            joules = (last["energy_uj"] - first["energy_uj"]) / 1e6
            out["host_energy_J"] = round(joules, 4)
            if span > 0:
                out["host_avg_power_W"] = round(joules / span, 3)
        # /proc/stat that does not advance over the window (some sandboxes
        # freeze it) measured nothing: the column stays None, not 0.0.
        if first["cpu_total"] >= 0 and last["cpu_total"] > first["cpu_total"]:
            busy = last["cpu_busy"] - first["cpu_busy"]
            total = last["cpu_total"] - first["cpu_total"]
            out["cpu_usage"] = round(100.0 * busy / total, 3)
        avail = [r["mem_avail_kb"] for r in rows if r["mem_avail_kb"] >= 0]
        if not avail and last["mem_avail_kb"] >= 0:
            avail = [last["mem_avail_kb"]]
        if avail:
            try:
                with open("/proc/meminfo") as f:
                    total_kb = None
                    for line in f:
                        if line.startswith("MemTotal:"):
                            total_kb = float(line.split()[1])
                            break
                if total_kb:
                    mean_avail = sum(avail) / len(avail)
                    out["memory_usage"] = round(
                        100.0 * (1.0 - mean_avail / total_kb), 3
                    )
            except OSError:
                pass
        return out

    def __del__(self):  # pragma: no cover - interpreter-shutdown dependent
        try:
            if self._handle and self._lib is not None:
                self._lib.sampler_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
