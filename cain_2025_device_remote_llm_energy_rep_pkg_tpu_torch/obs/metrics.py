"""Metrics registry: counters, gauges, fixed-bucket histograms, Prometheus
text exposition (a copy of the JAX package's ``obs/metrics.py``, which the
port may not import).

The framework's metrics spine, deliberately tiny and dependency-free:

- **default-on but allocation-light**: instruments are module-level
  singletons created once at import; a disabled switch turns every
  ``inc``/``set``/``observe`` into a single boolean check and return —
  no per-observation allocation, no string formatting off the hot path,
  no background thread.
- **fixed buckets**: histograms pre-declare bounds (Prometheus
  convention), so an observation is one bisect + two float adds under a
  lock.
- **kill switch**: env ``TPU_LLM_OBS=0`` (or ``off``/``false``) at
  process start, or :func:`disable` at runtime (the serve CLI's
  ``--no-telemetry``). Disabled means zero spans, empty exposition, and
  the server's ``/metrics`` returns 404.

Prometheus text exposition (``exposition()``) follows the v0.0.4 format;
``snapshot()`` returns the same data as a JSON-able dict. The parser and
federation merge (``parse_exposition``, ``merge_expositions``) and the
bucket quantile math serve the time-series ring and the SLO engine.
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
# BATCH_BUCKETS ladder, duplicated so this module imports no engine).
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

        Format guarantees (pinned by the golden-output test): families
        sorted by name, children in STABLE sorted label order (not the
        racy first-touch insertion order), label values escaped per the
        spec, HELP text with backslash/newline escaped, histogram
        buckets cumulative ending in ``+Inf`` == ``_count``.
        """
        if not _enabled:
            return ""
        return self._render()

    def _render(self) -> str:
        """The exposition body, kill-switch-free: the federation merge
        (:func:`merge_expositions`) renders its scratch registry through
        this so the merged text is a pure function of its inputs."""
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


# -- Prometheus text parsing + fleet federation ----------------------
# The router used to scrape replicas with two ad-hoc regexes; federation
# (one front-door scrape answering fleet TTFT p99 / aggregate goodput /
# fleet J-per-token) needs the real thing: a v0.0.4 text parser that
# understands TYPE lines, label escaping and histogram bucket samples,
# and a merge that sums counters, merges fixed-bucket histograms
# BUCKET-WISE, and re-labels gauges {replica=...} (a gauge is a point
# reading — summing two pool occupancies would be a lie).


class ParsedFamily:
    """One parsed metric family. ``samples`` maps a canonical label key
    (a tuple of ``(name, value)`` pairs sorted by name) to the float
    value (counter/gauge/untyped); ``histograms`` maps the same key to
    ``{"buckets": [(le, cumulative), ...], "sum": float, "count":
    float}`` with buckets in exposition order."""

    __slots__ = ("name", "kind", "help", "samples", "histograms")

    def __init__(self, name: str, kind: str = "untyped", help_: str = "") -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.samples: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self.histograms: Dict[Tuple[Tuple[str, str], ...], Dict[str, Any]] = {}


def _unescape_label(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_label_str(s: str) -> Dict[str, str]:
    """``a="x",b="y"`` (escaped per the spec) → dict. Character scanner,
    not a regex: label VALUES may contain commas, braces and escaped
    quotes."""
    labels: Dict[str, str] = {}
    i, n = 0, len(s)
    while i < n:
        eq = s.index("=", i)
        name = s[i:eq].strip()
        i = eq + 1
        if i >= n or s[i] != '"':
            raise ValueError(f"malformed label string: {s!r}")
        i += 1
        start = i
        buf = []
        while i < n:
            c = s[i]
            if c == "\\" and i + 1 < n:
                buf.append(s[start:i])
                buf.append(s[i : i + 2])
                i += 2
                start = i
                continue
            if c == '"':
                break
            i += 1
        buf.append(s[start:i])
        labels[name] = _unescape_label("".join(buf))
        i += 1  # past the closing quote
        while i < n and s[i] in ", ":
            i += 1
    return labels


def _split_sample(line: str) -> Tuple[str, Dict[str, str], float]:
    """One sample line → (metric name, labels, value)."""
    if "{" in line:
        name, _, rest = line.partition("{")
        # the closing brace of the LABEL BLOCK is the last '}' before
        # the value (label values may contain '}' but it is inside
        # quotes; scanning from the right is safe because the value
        # itself never contains one)
        close = rest.rindex("}")
        labels = _parse_label_str(rest[:close])
        value = float(rest[close + 1 :].strip())
        return name, labels, value
    name, _, value = line.rpartition(" ")
    return name.strip(), {}, float(value)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Parse a Prometheus v0.0.4 text exposition into families.

    Histogram ``_bucket``/``_sum``/``_count`` samples fold into their
    TYPE-declared base family; samples with no TYPE line land in an
    untyped family under their literal sample name (so ad-hoc scrapes
    still answer :func:`sample_value`). Unparseable lines are skipped —
    a probe must degrade, not raise."""
    families: Dict[str, ParsedFamily] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    lines = text.splitlines()
    for line in lines:  # pass 1: metadata
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                kinds[parts[2]] = parts[3].strip()
        elif line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                raw = parts[3] if len(parts) > 3 else ""
                helps[parts[2]] = raw.replace("\\n", "\n").replace("\\\\", "\\")
    hist_names = {n for n, k in kinds.items() if k == "histogram"}
    for line in lines:  # pass 2: samples
        if not line or line.startswith("#"):
            continue
        try:
            name, labels, value = _split_sample(line)
        except (ValueError, IndexError):
            continue
        base = None
        suffix = None
        for cand_suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(cand_suffix) and name[: -len(cand_suffix)] in hist_names:
                base, suffix = name[: -len(cand_suffix)], cand_suffix
                break
        if base is not None:
            fam = families.setdefault(
                base, ParsedFamily(base, "histogram", helps.get(base, ""))
            )
            le = labels.pop("le", None)
            key = _label_key(labels)
            hist = fam.histograms.setdefault(
                key, {"buckets": [], "sum": 0.0, "count": 0.0}
            )
            if suffix == "_bucket":
                hist["buckets"].append((le, value))
            elif suffix == "_sum":
                hist["sum"] = value
            else:
                hist["count"] = value
            continue
        kind = kinds.get(name, "untyped")
        fam = families.setdefault(
            name, ParsedFamily(name, kind, helps.get(name, ""))
        )
        fam.samples[_label_key(labels)] = value
    return families


def sample_value(
    families: Dict[str, ParsedFamily], name: str
) -> Optional[float]:
    """First sample of a counter/gauge/untyped family (None when
    absent/empty) — the probe's one-gauge accessor."""
    fam = families.get(name)
    if fam is None or not fam.samples:
        return None
    return next(iter(fam.samples.values()))


def histogram_mean(
    families: Dict[str, ParsedFamily], name: str
) -> Optional[float]:
    """Mean (sum/count over all children) of a histogram family; falls
    back to bare ``<name>_sum``/``<name>_count`` samples for scrapes
    with no TYPE line. None when absent or empty."""
    fam = families.get(name)
    if fam is not None and fam.histograms:
        total = sum(h["sum"] for h in fam.histograms.values())
        count = sum(h["count"] for h in fam.histograms.values())
        return total / count if count else None
    total = sample_value(families, f"{name}_sum")
    count = sample_value(families, f"{name}_count")
    if total is None or not count:
        return None
    return total / count


def quantile_from_buckets(
    bounds: Sequence[float],
    counts: Sequence[float],
    q: float,
) -> Optional[float]:
    """Estimate the ``q``-quantile of a fixed-bucket histogram from its
    PER-BUCKET counts (shared by the time-series ring, the
    SLO engine and ``scripts/poisson_load.py``).

    ``bounds`` are the finite upper bucket bounds (ascending, the
    registry's ``_Histogram.bounds``); ``counts`` has one extra entry —
    the ``+Inf`` overflow bucket — exactly like ``_Histogram.counts``.
    The estimate interpolates linearly inside the containing bucket
    (Prometheus ``histogram_quantile`` convention): the first bucket
    interpolates from 0, and any quantile landing in the ``+Inf``
    bucket clamps to the last finite bound (an unbounded bucket has no
    defensible upper edge). Returns None on empty histograms. Works on
    DELTAS between two ring snapshots as well as on cumulative counts —
    the math only needs non-negative per-bucket mass."""
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"counts must have len(bounds)+1 entries "
            f"(+Inf last), got {len(counts)} for {len(bounds)} bounds"
        )
    total = float(sum(counts))
    if total <= 0:
        return None
    q = min(1.0, max(0.0, q))
    target = q * total
    cum = 0.0
    for i, n in enumerate(counts[: len(bounds)]):
        prev = cum
        cum += n
        if cum >= target:
            hi = float(bounds[i])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            if n <= 0:
                return hi
            return lo + (hi - lo) * (target - prev) / n
    return float(bounds[-1]) if bounds else None


def bucket_fraction_below(
    bounds: Sequence[float],
    counts: Sequence[float],
    threshold: float,
) -> Optional[float]:
    """The inverse of :func:`quantile_from_buckets`: the estimated
    fraction of observations at or below ``threshold``, linearly
    interpolated inside the containing bucket. This is the SLO engine's
    "good events / total events" estimator — and it is ADDITIVE across
    histograms with identical bounds: the interpolation term is linear
    in the bucket count, so the fraction computed on a bucket-wise
    merged fleet histogram equals the count-weighted combination of the
    per-replica fractions (the fleet-attainment consistency the smoke
    asserts). Returns None on empty histograms; mass in the ``+Inf``
    bucket counts as above every finite threshold."""
    if len(counts) != len(bounds) + 1:
        raise ValueError(
            f"counts must have len(bounds)+1 entries "
            f"(+Inf last), got {len(counts)} for {len(bounds)} bounds"
        )
    total = float(sum(counts))
    if total <= 0:
        return None
    good = 0.0
    for i, n in enumerate(counts[: len(bounds)]):
        hi = float(bounds[i])
        lo = float(bounds[i - 1]) if i > 0 else 0.0
        if threshold >= hi:
            good += n
        elif threshold > lo:
            good += n * (threshold - lo) / (hi - lo)
        else:
            break
    return min(1.0, good / total)


# Families the federation NEVER rolls up: the router's own surface (a
# replica scrape can only contain these in the degenerate in-process
# fleet, where the registry is shared) and already-federated output.
FEDERATION_EXCLUDE_PREFIXES = ("llm_router_", "llm_fleet_")
FLEET_PREFIX = "llm_fleet_"


def merge_expositions(
    sources: Sequence[Tuple[str, str]],
    fleet_prefix: str = FLEET_PREFIX,
    match_prefix: str = "llm_",
    exclude_prefixes: Sequence[str] = FEDERATION_EXCLUDE_PREFIXES,
) -> str:
    """Merge N replica scrapes into ONE fleet exposition.

    ``sources`` is ``[(replica_name, exposition_text), ...]``. Each
    ``llm_<x>`` family becomes ``llm_fleet_<x>``:

    - **counters** sum per label set across replicas;
    - **histograms** merge BUCKET-WISE (cumulative bucket counts, sums
      and counts added per ``le``) — sound because every family
      pre-declares fixed buckets; a family whose bucket bounds disagree
      across replicas (version skew) is dropped whole rather than
      merged wrong;
    - **gauges** are point readings, NOT summable: each replica's child
      re-labels as ``{replica="<name>", ...}``.

    Deterministic and pure: same scrapes in, same bytes out (the golden
    federation test and the router's ``/metrics`` both call this).
    Empty scrapes contribute nothing; an unparseable source is skipped.
    """
    out = MetricsRegistry()
    merged_hist_bounds: Dict[str, Tuple[float, ...]] = {}
    dropped: set = set()
    for replica_name, text in sources:
        try:
            families = parse_exposition(text or "")
        except Exception:  # noqa: BLE001 — a bad scrape must not 500 /metrics
            continue
        for name in sorted(families):
            fam = families[name]
            if not name.startswith(match_prefix) or any(
                name.startswith(p) for p in exclude_prefixes
            ):
                continue
            fleet_name = fleet_prefix + name[len(match_prefix):]
            if fleet_name in dropped:
                continue
            try:
                if fam.kind == "counter" or fam.kind == "untyped":
                    for key, value in fam.samples.items():
                        names = tuple(k for k, _ in key)
                        child = out.counter(
                            fleet_name, fam.help, labels=names
                        ).labels(**dict(key))
                        child.value += value
                elif fam.kind == "gauge":
                    for key, value in fam.samples.items():
                        names = ("replica",) + tuple(k for k, _ in key)
                        child = out.gauge(
                            fleet_name, fam.help, labels=names
                        ).labels(replica=replica_name, **dict(key))
                        child.value = value
                elif fam.kind == "histogram":
                    for key, hist in fam.histograms.items():
                        bounds = tuple(
                            float(le)
                            for le, _ in hist["buckets"]
                            if le not in (None, "+Inf")
                        )
                        expect = merged_hist_bounds.setdefault(
                            fleet_name, bounds
                        )
                        if bounds != expect:
                            raise ValueError("bucket bounds disagree")
                        names = tuple(k for k, _ in key)
                        child = out.histogram(
                            fleet_name, fam.help, labels=names,
                            buckets=bounds,
                        ).labels(**dict(key))
                        # cumulative → per-bucket, then add; the +Inf
                        # overflow is count minus the last finite cum
                        cums = [
                            c
                            for le, c in hist["buckets"]
                            if le not in (None, "+Inf")
                        ]
                        prev = 0.0
                        for i, cum in enumerate(cums):
                            child.counts[i] += int(cum - prev)
                            prev = cum
                        child.counts[len(bounds)] += int(
                            hist["count"] - prev
                        )
                        child.sum += hist["sum"]
                        child.count += int(hist["count"])
            except ValueError:
                # registered differently by another source (label or
                # bucket skew): drop the family from the rollup whole
                dropped.add(fleet_name)
                with out._lock:
                    out._families.pop(fleet_name, None)
    return out._render()


# -- speculative decoding -----------------
# Declared here — not in the engine — because THREE producers share them:
# the solo path (engine/torch_engine.generate_speculative), the batched
# stepped sessions (engine/stepped.py) and the hermetic fake
# (engine/fake.py), and a shared definition is what keeps one scrape
# comparable across all three. Every per-round instrument carries a
# ``source`` label ("model" | "ngram" | "cross") so the per-source
# fallback policy and the cross-model energy split stay separable in
# one scrape.
SPEC_ROUNDS_C = REGISTRY.counter(
    "llm_spec_rounds_total",
    "Draft-verify rounds executed (one round = k draft proposals + ONE "
    "target forward over the k+1 candidate positions), by draft source",
    labels=("source",),
)
SPEC_ACCEPTED_C = REGISTRY.counter(
    "llm_spec_tokens_accepted_total",
    "Draft tokens accepted AND emitted by the target's verify (EOS "
    "clips and budget cuts excluded — same rule as extras['spec']), "
    "by draft source",
    labels=("source",),
)
SPEC_DRAFTED_C = REGISTRY.counter(
    "llm_spec_tokens_drafted_total",
    "Draft tokens proposed (k per live row per round), by draft source",
    labels=("source",),
)
SPEC_REJECTED_C = REGISTRY.counter(
    "llm_spec_tokens_rejected_total",
    "Draft tokens burned in FULLY-rejected rounds (k per such round — "
    "the rounds whose draft work amortized into nothing; cross-model "
    "sources bill these same tokens to the wasted-energy ledger under "
    'cause="draft"), by draft source',
    labels=("source",),
)
SPEC_ACCEPTANCE_G = REGISTRY.gauge(
    "llm_spec_acceptance_rate",
    "Most recent window's accepted/drafted fraction (0..1) per draft "
    "source — the signal the stepped sessions' auto-fallback policy "
    "reads",
    labels=("source",),
)
SPEC_FALLBACK_C = REGISTRY.counter(
    "llm_spec_fallback_total",
    "Speculating sessions that fell back to plain decode because their "
    "rolling acceptance dropped below --spec-accept-floor, by draft "
    "source (n-gram collapse on non-repetitive text must not read as "
    "model-draft failure)",
    labels=("source",),
)
SPEC_K_ADAPT_C = REGISTRY.counter(
    "llm_spec_k_adapt_total",
    "Adaptive draft-length moves: a below-floor acceptance "
    "window first SHRINKS k (direction=down) instead of abandoning "
    "speculation outright; a recovered window restores it toward the "
    "configured k (direction=up). Full fallback only fires from k=1.",
    labels=("source", "direction"),
)
SPEC_VERIFY_NATIVE_C = REGISTRY.counter(
    "llm_spec_verify_native_total",
    "Verify rounds run in the PAGE-RESIDENT native mode ("
    "multi-query paged kernel / scratch commit — candidates never "
    "stream through the page table and no slack pages are billed); "
    "the migration-observability counter for CI smoke",
)


# -- preemption page swap -------------------------------------------
# Declared here because THREE producers share them: PagePool.swap_out/
# swap_in (paged sessions), SteppedDecodeSession's contiguous/side-cache
# slab swaps, and the hermetic fake's simulated swap — one scrape must
# stay comparable across all three.
SWAP_BYTES_C = REGISTRY.counter(
    "llm_swap_bytes_total",
    "KV payload bytes moved between device and host by mid-flight "
    "preemption, by direction (out: device->host at preempt; in: "
    "host->device at resume)",
    labels=("direction",),
)
SWAP_HOST_BYTES_G = REGISTRY.gauge(
    "llm_swap_host_bytes",
    "KV payload bytes currently parked in host memory for preempted "
    "rows (returns exactly to 0 once every victim resumed or was "
    "discarded)",
)
SWAP_HOST_ROWS_G = REGISTRY.gauge(
    "llm_swap_host_rows",
    "Preempted rows whose KV currently lives in host memory",
)


# -- live row migration ---------------------------------------------
# Declared here because TWO producers share them: the scheduler's
# prime/evacuate export-import pair and the router's disagg/drain
# transfer pipeline — a fleet scrape must show migrated rows and bytes
# symmetrically (out on the source, in on the destination) no matter
# which side did the accounting.
MIGRATE_ROWS_C = REGISTRY.counter(
    "llm_migrate_rows_total",
    "Live rows migrated between replicas, by reason (disagg: a primed "
    "row shipped from a prefill replica to a decode replica; drain: an "
    "in-flight row evacuated off a draining replica)",
    labels=("reason",),
)
MIGRATE_BYTES_C = REGISTRY.counter(
    "llm_migrate_bytes_total",
    "Serialized row-bundle bytes moved by live migration, by direction "
    "(out: exported from the source replica; in: seated on the "
    "destination) — symmetric counters: every completed migration "
    "moves the same bundle out and in",
    labels=("direction",),
)


def observe_migrate(direction: str, nbytes: float) -> None:
    """Account one migration transfer leg (``out`` at export, ``in`` at
    seat). Counter only, like :func:`observe_swap` — residency during a
    migration is transient by construction."""
    if not _enabled or nbytes <= 0:
        return
    MIGRATE_BYTES_C.labels(direction=direction).inc(nbytes)


def observe_swap(direction: str, nbytes: float) -> None:
    """Account one swap TRANSFER (``direction`` = ``out`` at preempt,
    ``in`` at resume). Counter only — the host-residency gauges are
    owned by the session's swap ledger (:func:`swap_host_adjust`), the
    one place that also knows about discards without a transfer."""
    if not _enabled or nbytes <= 0:
        return
    SWAP_BYTES_C.labels(direction=direction).inc(nbytes)


def swap_host_adjust(nbytes: float, rows: int = 0) -> None:
    """Move the host-residency gauges by a delta (clamped at zero so a
    discard racing a reset cannot leave them negative)."""
    if not _enabled:
        return
    SWAP_HOST_BYTES_G.set(max(0.0, SWAP_HOST_BYTES_G._default.value + nbytes))
    if rows:
        SWAP_HOST_ROWS_G.set(
            max(0.0, SWAP_HOST_ROWS_G._default.value + rows)
        )


# -- model weight lifecycle -----------------------------------------
# Declared here because TWO producers share them: the real engines'
# Ollama-style weight LRU (engine load/evict/unload) and
# the hermetic fake's load_model/evict_model — multi-model serving reads
# one scrape to see WHICH models are resident and what eviction traffic
# the shared device-memory envelope is paying.
MODEL_LOADED_G = REGISTRY.gauge(
    "llm_model_loaded",
    "1 while this model's weights are resident in accelerator memory "
    "(0 after eviction/unload) — the /api/ps surface as a gauge",
    labels=("model",),
)
MODEL_WEIGHT_BYTES_G = REGISTRY.gauge(
    "llm_model_weight_bytes",
    "Estimated resident weight bytes of this model (0 when not loaded) "
    "— what the model charges the shared device-memory envelope next to the "
    "session pools and the prefix store",
    labels=("model",),
)
MODEL_EVICTIONS_C = REGISTRY.counter(
    "llm_model_evictions_total",
    "Model weights dropped from accelerator memory, by reason (lru: "
    "the allocation-budget LRU made room for another load; reinstall: "
    "install_model replaced the weights under the same name; unload: "
    "explicit unload_all between treatments)",
    labels=("reason",),
)
MODEL_EVICT_DEFERRED_C = REGISTRY.counter(
    "llm_model_evict_deferred_total",
    "LRU evictions REFUSED because the victim model had live stepped "
    "rows (evicting under a live session would be undefined "
    "— the eviction re-runs once the model's sessions drain)",
)


def observe_model_loaded(model: str, weight_bytes: float) -> None:
    """Flip one model's residency gauges on (idempotent — a refresh of
    an already-loaded model re-sets the same values)."""
    if not _enabled:
        return
    MODEL_LOADED_G.labels(model=model).set(1.0)
    MODEL_WEIGHT_BYTES_G.labels(model=model).set(max(0.0, weight_bytes))


def observe_model_evicted(model: str, reason: str) -> None:
    """Flip one model's residency gauges off and count the eviction."""
    if not _enabled:
        return
    MODEL_LOADED_G.labels(model=model).set(0.0)
    MODEL_WEIGHT_BYTES_G.labels(model=model).set(0.0)
    MODEL_EVICTIONS_C.labels(reason=reason).inc()


def observe_spec(
    rounds: float,
    accepted: float,
    drafted: float,
    source: str = "model",
    rejected: float = 0.0,
) -> None:
    """One speculative window's counters + the acceptance gauge (no-op
    when telemetry is off — the instruments gate themselves, but the
    gauge division is worth skipping too). ``source`` names the draft
    source that proposed the tokens ("model" | "ngram" | "cross");
    ``rejected`` is the tokens burned in FULLY-rejected rounds."""
    if not _enabled or rounds <= 0:
        return
    SPEC_ROUNDS_C.labels(source=source).inc(rounds)
    SPEC_ACCEPTED_C.labels(source=source).inc(accepted)
    SPEC_DRAFTED_C.labels(source=source).inc(drafted)
    if rejected > 0:
        SPEC_REJECTED_C.labels(source=source).inc(rejected)
    if drafted > 0:
        SPEC_ACCEPTANCE_G.labels(source=source).set(accepted / drafted)
