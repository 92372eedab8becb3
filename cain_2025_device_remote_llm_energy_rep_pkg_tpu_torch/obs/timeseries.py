"""Windowed telemetry: a fixed-capacity in-process time-series ring.

Every ``llm_*`` family is a point-in-time counter/gauge/histogram —
perfect for an external Prometheus, useless for answering "TTFT p99
over the last minute" or "is the J/token contract burning" from inside
the process. This module adds the missing history without adopting a
TSDB: a ring of registry snapshots taken on a background cadence, plus
the windowed rollup math over them:

- **counters** → delta and per-second rate between the window's oldest
  and newest snapshot (clamped at zero across restarts/resets);
- **gauges** → min / mean / max / last over every snapshot in the
  window;
- **histograms** → quantiles estimated from BUCKET DELTAS between the
  window's endpoints (``obs.metrics.quantile_from_buckets``) — i.e.
  the distribution of the observations that happened *inside* the
  window, not the process-lifetime distribution a bare scrape shows.

Design rules (the same ones the flight recorder follows):

- **fixed capacity, drop-oldest**: snapshots land in a
  ``deque(maxlen=N)`` under one lock; memory is bounded no matter how
  long the server runs (default 1984 snapshots ≈ 33 min at the 1 s
  cadence — enough history for the SLO engine's slow 30 m window).
- **kill switch**: ``sample_once`` returns before allocating anything
  when ``obs.metrics.enabled()`` is false, and :class:`SamplerThread`
  refuses to start — the measurement-run guarantee (``TPU_LLM_OBS=0``
  / ``--no-telemetry`` keep the process exactly as quiet as before).
- **injectable clock**: every time-dependent entry point takes
  ``now=`` (and the ring a ``clock=`` default), so window math is
  hermetically testable with a hand-driven clock.

Two ingestion paths share one snapshot shape: the in-process source
reads the live registry's family internals directly (no text
round-trip), and ``ingest_text`` parses a Prometheus exposition (the JAX
package's router samples its federated merge that way; the port has no
router yet).
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .metrics import (
    DEFAULT_TIME_BUCKETS,
    MetricsRegistry,
    ParsedFamily,
    REGISTRY,
    enabled,
    parse_exposition,
    quantile_from_buckets,
)

# Sampling cadence and ring depth (env-overridable like the flight
# ring's TPU_LLM_FLIGHT_CAPACITY). 1984 snapshots at the 1 s default
# cadence keeps ~33 minutes of history — the SLO engine's slow 30 m
# window fits with slack.
DEFAULT_INTERVAL_S = float(os.environ.get("TPU_LLM_TS_INTERVAL_S", 1.0))
DEFAULT_CAPACITY = int(os.environ.get("TPU_LLM_TS_CAPACITY", 1984))
# Only llm_* families are sampled by default: the ring exists for the
# serving/SLO surface, not for arbitrary registries.
DEFAULT_PREFIXES = ("llm_",)
# The quantiles a histogram rollup reports (p50/p90/p95/p99 — the SLO
# vocabulary of scripts/poisson_load.py).
DEFAULT_QUANTILES = (0.5, 0.9, 0.95, 0.99)


class FamilySample:
    """One family's state inside one snapshot. ``children`` maps a
    canonical label key (``"a=x,b=y"`` sorted by label name, ``"_"``
    when label-less — the same key ``MetricsRegistry.snapshot`` uses)
    to a float (counter/gauge) or a ``(bucket_counts, sum, count)``
    triple (histogram; ``bucket_counts`` is PER-BUCKET with the +Inf
    overflow last, matching ``_Histogram.counts``)."""

    __slots__ = ("kind", "bounds", "children")

    def __init__(
        self,
        kind: str,
        children: Dict[str, Any],
        bounds: Optional[Tuple[float, ...]] = None,
    ) -> None:
        self.kind = kind
        self.bounds = bounds
        self.children = children


# All-zeros stand-in baseline for a family absent from the window's
# oldest snapshot (only ``children`` lookups touch it — every miss
# defaults to zero in the delta math).
_EMPTY_FAMILY = FamilySample("counter", {})


def _label_key(names: Sequence[str], values: Sequence[str]) -> str:
    pairs = sorted(zip(names, values))
    return ",".join(f"{n}={v}" for n, v in pairs) or "_"


def registry_families(
    registry: MetricsRegistry = REGISTRY,
    prefixes: Sequence[str] = DEFAULT_PREFIXES,
) -> Dict[str, FamilySample]:
    """Snapshot the live registry's matching families into the ring's
    sample shape — reading the family internals directly (one lock per
    family, no text rendering: this runs every cadence tick)."""
    out: Dict[str, FamilySample] = {}
    with registry._lock:
        families = list(registry._families.values())
    pfx = tuple(prefixes)
    for fam in families:
        if pfx and not fam.name.startswith(pfx):
            continue
        with fam._lock:
            items = list(fam._children.items())
        if not items:
            continue
        children: Dict[str, Any] = {}
        if fam.kind == "histogram":
            bounds = tuple(fam.buckets or DEFAULT_TIME_BUCKETS)
            for values, child in items:
                children[_label_key(fam.label_names, values)] = (
                    tuple(child.counts),
                    float(child.sum),
                    int(child.count),
                )
            out[fam.name] = FamilySample(fam.kind, children, bounds)
        else:
            for values, child in items:
                children[_label_key(fam.label_names, values)] = float(
                    child.value
                )
            out[fam.name] = FamilySample(fam.kind, children)
    return out


def families_from_parsed(
    parsed: Dict[str, ParsedFamily],
    prefixes: Sequence[str] = DEFAULT_PREFIXES,
) -> Dict[str, FamilySample]:
    """Convert ``parse_exposition`` output into the ring's sample shape
    (the router's fleet-merge ingestion path). Histogram buckets arrive
    CUMULATIVE in exposition order and convert to per-bucket counts; a
    histogram child whose bucket list is malformed is skipped — a bad
    scrape must degrade, not raise."""
    out: Dict[str, FamilySample] = {}
    pfx = tuple(prefixes)
    for name, fam in parsed.items():
        if pfx and not name.startswith(pfx):
            continue
        children: Dict[str, Any] = {}
        if fam.kind == "histogram":
            bounds: Optional[Tuple[float, ...]] = None
            for key, hist in fam.histograms.items():
                finite = [
                    (float(le), cum)
                    for le, cum in hist["buckets"]
                    if le not in (None, "+Inf")
                ]
                finite.sort(key=lambda p: p[0])
                child_bounds = tuple(b for b, _ in finite)
                if bounds is None:
                    bounds = child_bounds
                elif child_bounds != bounds:
                    continue  # bound skew inside one family: skip child
                counts: List[int] = []
                prev = 0.0
                ok = True
                for _, cum in finite:
                    if cum < prev:
                        ok = False
                        break
                    counts.append(int(cum - prev))
                    prev = cum
                if not ok:
                    continue
                total = float(hist.get("count") or 0.0)
                counts.append(max(0, int(total - prev)))
                children[_ckey(key)] = (
                    tuple(counts),
                    float(hist.get("sum") or 0.0),
                    int(total),
                )
            if children and bounds is not None:
                out[name] = FamilySample("histogram", children, bounds)
        elif fam.samples:
            for key, value in fam.samples.items():
                children[_ckey(key)] = float(value)
            kind = "gauge" if fam.kind == "gauge" else "counter"
            out[name] = FamilySample(kind, children)
    return out


def _ckey(key: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f"{n}={v}" for n, v in key) or "_"


class _Snapshot:
    __slots__ = ("t_s", "families")

    def __init__(self, t_s: float, families: Dict[str, FamilySample]) -> None:
        self.t_s = t_s
        self.families = families


class TimeSeriesRing:
    """The fixed-capacity snapshot ring + the windowed rollup math (see
    the module docstring). ``source`` is a zero-arg callable returning
    a ``{name: FamilySample}`` dict (default: the live registry);
    ``clock`` injects determinism for tests."""

    def __init__(
        self,
        source: Optional[Callable[[], Dict[str, FamilySample]]] = None,
        capacity: int = DEFAULT_CAPACITY,
        interval_s: float = DEFAULT_INTERVAL_S,
        clock: Optional[Callable[[], float]] = None,
        prefixes: Sequence[str] = DEFAULT_PREFIXES,
    ) -> None:
        import time

        self.interval_s = max(0.01, float(interval_s))
        self.prefixes = tuple(prefixes)
        self.clock = clock or time.monotonic
        self._source = source or (
            lambda: registry_families(prefixes=self.prefixes)
        )
        self._lock = threading.Lock()
        self._snaps: "deque[_Snapshot]" = deque(maxlen=max(2, capacity))
        self._dropped = 0
        self._samples_total = 0

    @property
    def capacity(self) -> int:
        return self._snaps.maxlen or 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)

    # -- ingestion -------------------------------------------------------------
    def sample_once(self, now: Optional[float] = None) -> Optional[_Snapshot]:
        """Take one snapshot from the source. Returns None — touching
        neither the source nor the ring — when telemetry is off (the
        zero-alloc kill-switch guarantee)."""
        if not enabled():
            return None
        try:
            families = self._source()
        except Exception:  # noqa: BLE001 — a bad source tick must not kill the sampler
            return None
        return self.ingest(families, now=now)

    def ingest(
        self,
        families: Dict[str, FamilySample],
        now: Optional[float] = None,
    ) -> Optional[_Snapshot]:
        """Append one externally-built sample (the router's fleet-merge
        path). No-op when telemetry is off."""
        if not enabled():
            return None
        snap = _Snapshot(
            self.clock() if now is None else float(now), families
        )
        with self._lock:
            if len(self._snaps) == self._snaps.maxlen:
                self._dropped += 1
            self._snaps.append(snap)
            self._samples_total += 1
        return snap

    def ingest_text(
        self, text: str, now: Optional[float] = None
    ) -> Optional[_Snapshot]:
        """Parse one Prometheus exposition and append it as a sample."""
        if not enabled():
            return None
        try:
            families = families_from_parsed(
                parse_exposition(text or ""), prefixes=self.prefixes
            )
        except Exception:  # noqa: BLE001 — a bad scrape must degrade
            return None
        return self.ingest(families, now=now)

    # -- window selection ------------------------------------------------------
    def _window_snaps(
        self, window_s: float, now: Optional[float]
    ) -> List[_Snapshot]:
        with self._lock:
            snaps = list(self._snaps)
        if not snaps:
            return []
        t_end = snaps[-1].t_s if now is None else float(now)
        t_start = t_end - max(0.0, float(window_s))
        return [s for s in snaps if t_start <= s.t_s <= t_end]

    def family_names(self) -> List[str]:
        """Every family name seen in the newest snapshot."""
        with self._lock:
            if not self._snaps:
                return []
            return sorted(self._snaps[-1].families.keys())

    # -- rollups ---------------------------------------------------------------
    def window(
        self,
        family: str,
        window_s: float,
        now: Optional[float] = None,
        quantiles: Sequence[float] = DEFAULT_QUANTILES,
    ) -> Optional[Dict[str, Any]]:
        """The windowed rollup of one family (see the module docstring
        for per-kind semantics). ``None`` when the family never appeared
        in the window; a window wider than the retained history rolls up
        whatever is retained (``span_s`` reports the actual coverage)."""
        snaps = self._window_snaps(window_s, now)
        series = [
            (s.t_s, s.families[family])
            for s in snaps
            if family in s.families
        ]
        if not series:
            return None
        # Baseline = the window's OLDEST snapshot even when the family
        # had not appeared yet: untouched families are omitted from
        # snapshots, so absence means every child was at zero — without
        # this, traffic that first touches a family mid-window would
        # report delta 0 (its first delta-able sample already carries
        # the full count).
        t0 = snaps[0].t_s
        first = snaps[0].families.get(family) or _EMPTY_FAMILY
        t1, last = series[-1][0], series[-1][1]
        kind = last.kind
        out: Dict[str, Any] = {
            "family": family,
            "kind": kind,
            "window_s": float(window_s),
            "span_s": round(t1 - t0, 6),
            "samples": len(series),
            "t0": round(t0, 6),
            "t1": round(t1, 6),
            "children": {},
        }
        span = t1 - t0
        if kind == "counter":
            for key, v1 in last.children.items():
                v0 = first.children.get(key, 0.0)
                delta = max(0.0, float(v1) - float(v0))
                out["children"][key] = {
                    "delta": round(delta, 6),
                    "rate": round(delta / span, 6) if span > 0 else 0.0,
                }
        elif kind == "gauge":
            per_child: Dict[str, List[float]] = {}
            for _, fam in series:
                for key, v in fam.children.items():
                    per_child.setdefault(key, []).append(float(v))
            for key, values in per_child.items():
                out["children"][key] = {
                    "min": round(min(values), 6),
                    "mean": round(sum(values) / len(values), 6),
                    "max": round(max(values), 6),
                    "last": round(values[-1], 6),
                }
        else:  # histogram
            bounds = last.bounds or ()
            out["bounds"] = list(bounds)
            for key, (counts1, sum1, count1) in last.children.items():
                prev = first.children.get(key)
                if prev is not None and len(prev[0]) == len(counts1):
                    counts0, sum0, count0 = prev
                else:
                    counts0, sum0, count0 = (0,) * len(counts1), 0.0, 0
                deltas = tuple(
                    max(0, int(a) - int(b))
                    for a, b in zip(counts1, counts0)
                )
                dcount = max(0, int(count1) - int(count0))
                dsum = max(0.0, float(sum1) - float(sum0))
                child: Dict[str, Any] = {
                    "count": dcount,
                    "sum": round(dsum, 6),
                    "rate": (
                        round(dcount / span, 6) if span > 0 else 0.0
                    ),
                    "bucket_deltas": list(deltas),
                }
                if dcount:
                    child["mean"] = round(dsum / dcount, 6)
                    for q in quantiles:
                        est = quantile_from_buckets(bounds, deltas, q)
                        if est is not None:
                            child[f"p{int(q * 100)}"] = round(est, 6)
                out["children"][key] = child
        return out

    def points(
        self,
        family: str,
        window_s: float,
        step_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Raw sampled points of one family inside the window, strided
        so consecutive points are at least ``step_s`` apart (default:
        every retained snapshot) — the ``/debug/timeseries`` plot feed.
        Counter/gauge children report their sampled value; histogram
        children their cumulative count (rates/quantiles live in the
        :meth:`window` rollup, not per point)."""
        snaps = self._window_snaps(window_s, now)
        step = max(0.0, float(step_s)) if step_s else 0.0
        points: List[Dict[str, Any]] = []
        t_prev: Optional[float] = None
        for i, snap in enumerate(snaps):
            fam = snap.families.get(family)
            if fam is None:
                continue
            last = i == len(snaps) - 1
            if (
                t_prev is not None
                and not last
                and snap.t_s - t_prev < step
            ):
                continue
            t_prev = snap.t_s
            values: Dict[str, float] = {}
            for key, v in fam.children.items():
                if fam.kind == "histogram":
                    values[key] = float(v[2])
                else:
                    values[key] = float(v)
            points.append({"t_s": round(snap.t_s, 6), "values": values})
        return points

    # -- export ----------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._snaps)
            t0 = self._snaps[0].t_s if n else None
            t1 = self._snaps[-1].t_s if n else None
            dropped = self._dropped
            total = self._samples_total
        return {
            "capacity": self.capacity,
            "interval_s": self.interval_s,
            "samples": n,
            "samples_total": total,
            "dropped": dropped,
            "t0": round(t0, 6) if t0 is not None else None,
            "t1": round(t1, 6) if t1 is not None else None,
        }

    def debug_payload(
        self,
        family: Optional[str] = None,
        window_s: Optional[float] = None,
        step_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The ``GET /debug/timeseries`` body: one family's rollup +
        points when ``?family=`` names one, else every retained
        family's rollup (no point series — bounded response)."""
        window = float(window_s) if window_s else 60.0
        payload: Dict[str, Any] = {
            "ring": self.summary(),
            "window_s": window,
        }
        if family:
            rollup = self.window(family, window, now=now)
            if rollup is None:
                payload["error"] = f"no samples for family {family!r}"
            else:
                payload["rollup"] = rollup
                payload["points"] = self.points(
                    family, window, step_s=step_s, now=now
                )
        else:
            payload["families"] = {
                name: self.window(name, window, now=now)
                for name in self.family_names()
            }
        return payload

    def dump(self) -> Dict[str, Any]:
        """Full JSON-able ring dump (the smoke's CI artifact): every
        retained snapshot with histograms as (count, sum) pairs plus
        final bucket state — enough to recompute any window offline."""
        with self._lock:
            snaps = list(self._snaps)
        out_snaps = []
        for snap in snaps:
            fams: Dict[str, Any] = {}
            for name, fam in snap.families.items():
                if fam.kind == "histogram":
                    fams[name] = {
                        key: {
                            "buckets": list(v[0]),
                            "sum": round(v[1], 6),
                            "count": v[2],
                        }
                        for key, v in fam.children.items()
                    }
                else:
                    fams[name] = {
                        key: round(float(v), 6)
                        for key, v in fam.children.items()
                    }
            out_snaps.append(
                {"t_s": round(snap.t_s, 6), "families": fams}
            )
        return {"ring": self.summary(), "snapshots": out_snaps}


class SamplerThread:
    """The background cadence loop: calls ``tick()`` every
    ``interval_s`` on a daemon thread. Never starts while telemetry is
    disabled, and a mid-run :func:`~.metrics.disable` stops ticking
    (each tick re-checks the switch) — the kill-switch completeness the
    tests pin. One sampler can drive several rings (the router's
    per-replica + fleet sampling shares one thread)."""

    def __init__(
        self,
        tick: Callable[[], Any],
        interval_s: float = DEFAULT_INTERVAL_S,
        name: str = "ts-sampler",
    ) -> None:
        self.tick = tick
        self.interval_s = max(0.01, float(interval_s))
        self.name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        """Launch the sampler (idempotent). Returns False — and starts
        NOTHING — when telemetry is disabled."""
        if not enabled():
            return False
        if self.running:
            return True
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True
        )
        self._thread.start()
        return True

    def _loop(self) -> None:
        # Immediate baseline tick: windowed COUNTER DELTAS subtract the
        # window's oldest snapshot, so traffic arriving right after
        # start() must find one snapshot already in the ring.
        try:
            self.tick()
        except Exception:  # noqa: BLE001 — telemetry must not kill serving
            pass
        while not self._stop.wait(self.interval_s):
            if not enabled():
                continue
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — telemetry must not kill serving
                pass

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)
