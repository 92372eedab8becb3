"""SLO objectives, windowed attainment, multi-window burn-rate
alerting.

An **objective** is a contract over one of the request-latency/energy
histograms, declared on the CLI in a compact grammar::

    serve --slo 'ttft_p99_ms<=250,completion_p95_s<=4,joules_per_token<=0.35'

``ttft_p99_ms<=250`` reads "99% of requests must see TTFT ≤ 250 ms":
the percentile names the attainment TARGET (0.99) and the right-hand
side the THRESHOLD; attainment over a window is the fraction of that
window's observations at or under the threshold, computed from
histogram BUCKET DELTAS in the :class:`~.timeseries.TimeSeriesRing`
via ``obs.metrics.bucket_fraction_below`` (linear interpolation inside
the containing bucket — the same convention as
``quantile_from_buckets``, so ``ttft_p99_ms<=250`` attains ≥ 0.99
exactly when the windowed p99 estimate is ≤ 250 ms).

**Burn rate** is attainment restated against the error budget:
``burn = (1 - attainment) / (1 - target)`` — 1.0 means failing at
exactly the budgeted rate, 14.4 means the monthly budget dies in ~2
days. Alerts use the standard multi-window pairs so they are both fast
and flap-free: a pair fires only when BOTH its windows burn above its
threshold (the short window proves it is happening *now*, the long one
that it is not a blip), and the alert re-arms (resolves) once no pair
trips. Defaults: fast pair (1 m, 5 m) at 14.4×, slow pair (5 m, 30 m)
at 6×.

Alert transitions are emitted as flight-recorder ``slo_alert`` events
(``state=firing|resolved``) sharing a synthetic per-episode trace id
(``slo-<objective>-<n>``) so ``GET /debug/flight?trace=`` links a
firing to its resolution, and the engine publishes
``llm_slo_attainment{objective}``, ``llm_slo_burn_rate{objective,
window}`` and ``llm_slo_alerts_total{objective,state}`` back into the
registry — which means the ring samples the SLO engine's own output
and the federation rolls replica attainment up to the router like any
other gauge.

Everything here is a no-op when telemetry is disabled (``TPU_LLM_OBS=0``
/ ``--no-telemetry``): ``SLOEngine.evaluate`` returns immediately, no
family mutates, no event is emitted.
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .flight import EV_SLO_ALERT, FLIGHT, FlightRecorder
from .metrics import (
    FLEET_PREFIX,
    REGISTRY,
    bucket_fraction_below,
    enabled,
)
from .timeseries import TimeSeriesRing

# (short_window_s, long_window_s, burn_threshold): fire when BOTH
# windows of a pair burn above the threshold. The classic SRE pairs,
# compressed to the in-process scale the ring retains (~33 min).
DEFAULT_BURN_PAIRS: Tuple[Tuple[float, float, float], ...] = (
    (60.0, 300.0, 14.4),
    (300.0, 1800.0, 6.0),
)

# objective grammar: <metric>_p<NN>_<ms|s> for the latency histograms,
# bare joules_per_token for the energy contract.
_PCT_RE = re.compile(r"^([a-z_]+)_p(\d{1,2})_(ms|s)$")
_PCT_FAMILIES = {
    "ttft": "llm_request_ttft_seconds",
    "completion": "llm_request_completion_seconds",
    "queue_wait": "llm_sched_queue_wait_seconds",
}
# joules_per_token has no percentile in its spelling; the attainment
# target defaults to 0.95 (documented in docs/ARCHITECTURE.md).
_JPT_FAMILY = "llm_request_joules_per_token"
_JPT_DEFAULT_TARGET = 0.95

_ATTAIN_G = REGISTRY.gauge(
    "llm_slo_attainment",
    "Long-window SLO attainment per objective (1.0 = fully within contract)",
    labels=("objective",),
)
_BURN_G = REGISTRY.gauge(
    "llm_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = burning exactly the budget)",
    labels=("objective", "window"),
)
_ALERTS_C = REGISTRY.counter(
    "llm_slo_alerts_total",
    "SLO burn-rate alert transitions",
    labels=("objective", "state"),
)


class Objective:
    """One parsed objective. ``threshold`` is stored in the FAMILY's
    native units (seconds / joules-per-token) regardless of the spec's
    spelling; ``target`` is the required attainment fraction."""

    __slots__ = ("name", "family", "threshold", "target", "raw")

    def __init__(
        self, name: str, family: str, threshold: float, target: float, raw: str
    ) -> None:
        self.name = name
        self.family = family
        self.threshold = float(threshold)
        self.target = float(target)
        self.raw = raw

    def attains(self, value: float) -> bool:
        """Client-side exact check: does one observed value (in the
        family's native units) meet the threshold?"""
        return float(value) <= self.threshold

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "family": self.family,
            "threshold": self.threshold,
            "target": self.target,
            "spec": self.raw,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Objective({self.raw!r})"


def parse_slo_spec(text: str) -> List[Objective]:
    """Parse ``'ttft_p99_ms<=250,completion_p95_s<=4,
    joules_per_token<=0.35'`` into objectives. Raises ``ValueError``
    with a pointed message on anything malformed — the CLI converts
    that into a CommandError."""
    objectives: List[Objective] = []
    seen = set()
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "<=" not in part:
            raise ValueError(
                f"SLO objective {part!r} must look like name<=value"
            )
        name, _, rhs = part.partition("<=")
        name = name.strip()
        try:
            value = float(rhs.strip())
        except ValueError:
            raise ValueError(
                f"SLO objective {part!r}: threshold {rhs.strip()!r} is not a number"
            ) from None
        if value <= 0:
            raise ValueError(
                f"SLO objective {part!r}: threshold must be positive"
            )
        if name == "joules_per_token":
            obj = Objective(
                name, _JPT_FAMILY, value, _JPT_DEFAULT_TARGET, part
            )
        else:
            m = _PCT_RE.match(name)
            if not m or m.group(1) not in _PCT_FAMILIES:
                known = ", ".join(
                    f"{k}_pNN_ms|s" for k in sorted(_PCT_FAMILIES)
                )
                raise ValueError(
                    f"unknown SLO objective {name!r} (known: {known}, "
                    "joules_per_token)"
                )
            metric, pct, unit = m.group(1), int(m.group(2)), m.group(3)
            if not 1 <= pct <= 99:
                raise ValueError(
                    f"SLO objective {name!r}: percentile must be 1..99"
                )
            threshold = value / 1000.0 if unit == "ms" else value
            obj = Objective(
                name, _PCT_FAMILIES[metric], threshold, pct / 100.0, part
            )
        if obj.name in seen:
            raise ValueError(f"duplicate SLO objective {obj.name!r}")
        seen.add(obj.name)
        objectives.append(obj)
    if not objectives:
        raise ValueError("SLO spec is empty")
    return objectives


def exact_attainment(
    objective: Objective, values: Sequence[float]
) -> Optional[float]:
    """Exact attainment over raw observed values (client side:
    ``scripts/poisson_load.py`` cross-checks the server's bucket
    estimate with this). ``None`` when there are no values."""
    vals = [float(v) for v in values]
    if not vals:
        return None
    good = sum(1 for v in vals if v <= objective.threshold)
    return good / len(vals)


def ring_attainment(
    objectives: Sequence[Objective],
    ring: TimeSeriesRing,
    window_s: float,
    now: Optional[float] = None,
) -> Dict[str, Optional[float]]:
    """Windowed attainment of each objective against one ring — the
    reusable core the engine, the router's per-replica /debug/state
    attachment, and the smoke's fleet-vs-replica recompute all share.
    ``None`` for an objective whose family has no events in the window
    (no traffic burns no budget)."""
    out: Dict[str, Optional[float]] = {}
    for obj in objectives:
        out[obj.name] = _attainment(obj, ring, window_s, now)
    return out


def _resolve_rollup(
    obj: Objective,
    ring: TimeSeriesRing,
    window_s: float,
    now: Optional[float],
) -> Optional[Dict[str, Any]]:
    """The objective's histogram rollup from a ring, preferring the
    federated ``llm_fleet_`` spelling when the ring holds one (the
    router's ring samples both its own registry and the fleet merge;
    only the merge covers REMOTE replicas), falling back to the raw
    family name (the single server's ring)."""
    rollup = None
    if obj.family.startswith("llm_"):
        fleet_name = FLEET_PREFIX + obj.family[len("llm_") :]
        rollup = ring.window(fleet_name, window_s, now=now)
    if rollup is None:
        rollup = ring.window(obj.family, window_s, now=now)
    if rollup is None or rollup.get("kind") != "histogram":
        return None
    return rollup


def _attainment(
    obj: Objective,
    ring: TimeSeriesRing,
    window_s: float,
    now: Optional[float],
) -> Optional[float]:
    rollup = _resolve_rollup(obj, ring, window_s, now)
    if rollup is None:
        return None
    bounds = tuple(rollup.get("bounds") or ())
    if not bounds:
        return None
    # Sum bucket deltas across every labelled child: the objective is a
    # contract over ALL traffic of the family (per-replica labels on
    # fleet gauges do not reach histograms — the federation merges
    # those bucket-wise already).
    summed = [0] * (len(bounds) + 1)
    for child in rollup["children"].values():
        deltas = child.get("bucket_deltas")
        if not deltas or len(deltas) != len(summed):
            continue
        for i, d in enumerate(deltas):
            summed[i] += int(d)
    return bucket_fraction_below(bounds, summed, obj.threshold)


def burn_rate(attainment: Optional[float], target: float) -> float:
    """Error-budget burn: 0.0 on no traffic or full attainment, 1.0
    when failing at exactly the budgeted rate."""
    if attainment is None:
        return 0.0
    budget = max(1e-9, 1.0 - target)
    return max(0.0, (1.0 - attainment) / budget)


class _ObjectiveState:
    __slots__ = ("firing", "episode", "trace_id")

    def __init__(self) -> None:
        self.firing = False
        self.episode = 0
        self.trace_id: Optional[str] = None


class SLOEngine:
    """Evaluates objectives against a ring on every sampler tick,
    publishes the ``llm_slo_*`` families, and drives the per-objective
    firing/resolved state machine (see the module docstring)."""

    def __init__(
        self,
        objectives: Sequence[Objective],
        ring: TimeSeriesRing,
        recorder: FlightRecorder = FLIGHT,
        pairs: Sequence[Tuple[float, float, float]] = DEFAULT_BURN_PAIRS,
        name: str = "server",
    ) -> None:
        self.objectives = list(objectives)
        self.ring = ring
        self.recorder = recorder
        self.pairs = tuple(
            (float(s), float(l), float(t)) for s, l, t in pairs
        )
        if not self.pairs:
            raise ValueError("SLOEngine needs at least one burn pair")
        # attainment gauge window = the slowest pair's long window
        self.long_window_s = max(l for _, l, _ in self.pairs)
        self.name = name
        self._lock = threading.Lock()
        self._states = {o.name: _ObjectiveState() for o in self.objectives}
        self._last: Dict[str, Any] = {}
        _register(self)

    # -- evaluation ------------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One evaluation pass. Returns the per-objective report (also
        retained for :meth:`snapshot`), or None — touching nothing —
        when telemetry is disabled."""
        if not enabled() or not self.objectives:
            return None
        windows = sorted(
            {w for s, l, _ in self.pairs for w in (s, l)}
        )
        report: Dict[str, Any] = {}
        with self._lock:
            for obj in self.objectives:
                att = {
                    w: _attainment(obj, self.ring, w, now) for w in windows
                }
                burns = {
                    w: burn_rate(att[w], obj.target) for w in windows
                }
                tripped = [
                    (s, l, thr)
                    for s, l, thr in self.pairs
                    if burns[s] > thr and burns[l] > thr
                ]
                state = self._states[obj.name]
                transition = None
                if tripped and not state.firing:
                    state.firing = True
                    state.episode += 1
                    state.trace_id = f"slo-{obj.name}-{state.episode}"
                    transition = "firing"
                elif not tripped and state.firing:
                    state.firing = False
                    transition = "resolved"
                long_att = att[self.long_window_s]
                _ATTAIN_G.labels(objective=obj.name).set(
                    1.0 if long_att is None else long_att
                )
                for w in windows:
                    _BURN_G.labels(
                        objective=obj.name, window=f"{int(w)}s"
                    ).set(burns[w])
                if transition is not None:
                    _ALERTS_C.labels(
                        objective=obj.name, state=transition
                    ).inc()
                    pair = tripped[0] if tripped else max(
                        self.pairs, key=lambda p: burns[p[0]]
                    )
                    self.recorder.emit(
                        EV_SLO_ALERT,
                        trace_id=state.trace_id,
                        objective=obj.name,
                        spec=obj.raw,
                        state=transition,
                        engine=self.name,
                        pair_s=[pair[0], pair[1]],
                        threshold=pair[2],
                        burn_short=round(burns[pair[0]], 4),
                        burn_long=round(burns[pair[1]], 4),
                        attainment=(
                            None if long_att is None else round(long_att, 6)
                        ),
                    )
                report[obj.name] = {
                    "objective": obj.describe(),
                    "attainment": (
                        None if long_att is None else round(long_att, 6)
                    ),
                    "attainment_by_window": {
                        f"{int(w)}s": (
                            None if att[w] is None else round(att[w], 6)
                        )
                        for w in windows
                    },
                    "burn_rate": {
                        f"{int(w)}s": round(burns[w], 4) for w in windows
                    },
                    "firing": state.firing,
                    "episodes": state.episode,
                }
            self._last = report
        return report

    # -- export ----------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The ``obs_slo`` shape bench entries and /debug surfaces
        attach: objectives + the last evaluation's attainment/burn/state
        plus total alert transitions."""
        with self._lock:
            last = dict(self._last)
            firing = sum(
                1 for s in self._states.values() if s.firing
            )
            episodes = sum(s.episode for s in self._states.values())
        return {
            "engine": self.name,
            "objectives": [o.describe() for o in self.objectives],
            "pairs_s": [list(p) for p in self.pairs],
            "long_window_s": self.long_window_s,
            "report": last,
            "firing": firing,
            "alert_episodes": episodes,
        }

    def attainment_by_replica(
        self,
        rings: Dict[str, TimeSeriesRing],
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Dict[str, Optional[float]]]:
        """Per-replica attainment over the router's per-replica rings —
        the /debug/state attachment the future autoscaler consumes."""
        w = self.long_window_s if window_s is None else float(window_s)
        return {
            name: ring_attainment(self.objectives, ring, w, now=now)
            for name, ring in rings.items()
        }


# Live engines, weakly held, so bench.py's `_attach_obs` can attach an
# `obs_slo` snapshot without plumbing a handle through every arm.
_ENGINES: "weakref.WeakSet[SLOEngine]" = weakref.WeakSet()
_ENGINES_LOCK = threading.Lock()


def _register(engine: SLOEngine) -> None:
    with _ENGINES_LOCK:
        _ENGINES.add(engine)


def active_snapshot() -> Optional[List[Dict[str, Any]]]:
    """Snapshots of every live engine (None when none exist) — the
    bench attachment accessor."""
    with _ENGINES_LOCK:
        engines = list(_ENGINES)
    if not engines:
        return None
    return [e.snapshot() for e in sorted(engines, key=lambda e: e.name)]
