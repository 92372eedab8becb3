"""Metrics registry: counters, gauges, fixed-bucket histograms, Prometheus
text exposition.

The registry half of the JAX package's ``obs/metrics.py``, copied because
the port may not import that package. The families of the layers not yet
ported (scheduler, speculation, fleet federation) stay there; the port's
engine registers its own ``llm_engine_*`` families here.

- **default-on but allocation-light**: instruments are module-level
  singletons created once at import; a disabled switch turns every
  ``inc``/``set``/``observe`` into a single boolean check and return.
- **fixed buckets**: histograms pre-declare bounds (Prometheus
  convention), so an observation is one bisect + two float adds.
- **kill switch**: env ``TPU_LLM_OBS=0`` (or ``off``/``false``) at
  process start, or :func:`disable` at runtime.
"""

from __future__ import annotations

import bisect
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

# -- kill switch ---------------------------------------------------------------

_OFF_VALUES = ("0", "off", "false", "no")
_enabled = os.environ.get("TPU_LLM_OBS", "1").strip().lower() not in _OFF_VALUES


def enabled() -> bool:
    return _enabled


def disable() -> None:
    """Turn ALL telemetry off (metrics and spans; see obs.trace)."""
    global _enabled
    _enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


# Seconds-scale latency buckets: µs-scale CPU fakes through multi-second
# batch decode windows all land on a finite bucket.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Row-count buckets for admission/batch-width histograms (the engine's
# BATCH_BUCKETS ladder).
ROW_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class _Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not _enabled:
            return
        self.value += v


class _Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        if not _enabled:
            return
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not _enabled:
            return
        self.value += v


class _Histogram:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +Inf bucket last
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class Family:
    """One metric family: a name, a kind, and labelled children.

    Label-less use goes through the default ``()`` child via the
    delegating ``inc``/``set``/``observe`` methods; labelled use goes
    ``family.labels(path="paged", kv="int8").inc()``. Children are
    created on first touch and live for the process (bounded label
    cardinality is the caller's contract, as in Prometheus)."""

    def __init__(
        self,
        name: str,
        help_: str,
        kind: str,
        label_names: Tuple[str, ...],
        buckets: Optional[Tuple[float, ...]],
    ) -> None:
        self.name = name
        self.help = help_
        self.kind = kind
        self.label_names = label_names
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def _make_child(self):
        if self.kind == "histogram":
            return _Histogram(self.buckets or DEFAULT_TIME_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **labels: str):
        key = tuple(str(labels[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    # -- label-less convenience (the default child) ---------------------------
    @property
    def _default(self):
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._default.inc(v)

    def set(self, v: float) -> None:
        self._default.set(v)

    def observe(self, v: float) -> None:
        self._default.observe(v)


class MetricsRegistry:
    """Family registry with idempotent creation (module-level instruments
    can re-import safely) and text/dict export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}

    def _family(
        self,
        name: str,
        help_: str,
        kind: str,
        labels: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> Family:
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if existing.kind != kind or existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names}"
                    )
                return existing
            fam = Family(
                name, help_, kind, tuple(labels),
                tuple(buckets) if buckets is not None else None,
            )
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "", labels: Sequence[str] = ()) -> Family:
        return self._family(name, help_, "counter", labels)

    def gauge(self, name: str, help_: str = "", labels: Sequence[str] = ()) -> Family:
        return self._family(name, help_, "gauge", labels)

    def histogram(
        self,
        name: str,
        help_: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
    ) -> Family:
        return self._family(name, help_, "histogram", labels, buckets)

    # -- export ---------------------------------------------------------------
    @staticmethod
    def _escape_label(value: str) -> str:
        """Label-value escaping per the text-format spec: backslash,
        double-quote and newline (in that order — escaping the escape
        character first keeps the result unambiguous)."""
        return (
            value.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    @classmethod
    def _label_str(cls, names: Tuple[str, ...], values: Tuple[str, ...], extra: str = "") -> str:
        pairs = [
            f'{n}="{cls._escape_label(v)}"' for n, v in zip(names, values)
        ]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def exposition(self) -> str:
        """Prometheus text format v0.0.4. Empty string when disabled.

        Format guarantees: families
        sorted by name, children in STABLE sorted label order (not the
        racy first-touch insertion order), label values escaped per the
        spec, HELP text with backslash/newline escaped, histogram
        buckets cumulative ending in ``+Inf`` == ``_count``.
        """
        if not _enabled:
            return ""
        return self._render()

    def _render(self) -> str:
        """The exposition body, kill-switch-free."""
        lines = []
        with self._lock:
            families = list(self._families.values())
        for fam in sorted(families, key=lambda f: f.name):
            with fam._lock:
                children = sorted(fam._children.items())
            if not children:
                continue
            if fam.help:
                help_ = fam.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {fam.name} {help_}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in children:
                ls = self._label_str(fam.label_names, values)
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{fam.name}{ls} {child.value}")
                else:
                    cum = 0
                    for bound, n in zip(child.bounds, child.counts):
                        cum += n
                        le = self._label_str(
                            fam.label_names, values, f'le="{bound}"'
                        )
                        lines.append(f"{fam.name}_bucket{le} {cum}")
                    le = self._label_str(fam.label_names, values, 'le="+Inf"')
                    lines.append(f"{fam.name}_bucket{le} {child.count}")
                    lines.append(f"{fam.name}_sum{ls} {child.sum}")
                    lines.append(f"{fam.name}_count{ls} {child.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able registry state: counters/gauges as values, histograms
        as {count, sum, mean}. Families with no observations are omitted
        so a bench line stays one line."""
        out: Dict[str, Any] = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            vals: Dict[str, Any] = {}
            for values, child in list(fam._children.items()):
                key = ",".join(
                    f"{n}={v}" for n, v in zip(fam.label_names, values)
                ) or "_"
                if fam.kind == "histogram":
                    if not child.count:
                        continue
                    vals[key] = {
                        "count": child.count,
                        "sum": round(child.sum, 6),
                        "mean": round(child.sum / child.count, 6),
                    }
                else:
                    if not child.value:
                        continue
                    vals[key] = round(child.value, 6)
            if vals:
                out[fam.name] = vals
        return out

    def reset(self) -> None:
        """Drop all recorded values (families survive — they are referenced
        by module-level instruments). Test/bench isolation only."""
        with self._lock:
            for fam in self._families.values():
                fam._children.clear()


# THE process-wide registry every instrumented module shares.
REGISTRY = MetricsRegistry()


# -- page swap -------------------------------------------------------------------
# PagePool.swap_out / swap_in account their transfers here, under the JAX
# package's family name, so one scrape compares across the two packages.
SWAP_BYTES_C = REGISTRY.counter(
    "llm_swap_bytes_total",
    "KV payload bytes moved between device and host by mid-flight "
    "preemption, by direction (out: device->host at preempt; in: "
    "host->device at resume)",
    labels=("direction",),
)


def observe_swap(direction: str, nbytes: float) -> None:
    """Account one swap transfer (``direction`` = ``out`` at preempt,
    ``in`` at resume). Counter only."""
    if not _enabled or nbytes <= 0:
        return
    SWAP_BYTES_C.labels(direction=direction).inc(nbytes)
