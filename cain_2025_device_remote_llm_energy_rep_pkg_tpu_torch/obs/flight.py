"""Flight recorder: a bounded ring of schema'd structured events.

Percentile histograms answer "how slow are requests" but not "why was
THIS one slow" or "what did the scheduler actually decide before the
batch died". Production serving stacks (vLLM's request forensics,
Orca-style iteration schedulers) pair their metrics with a bounded
structured event log for exactly that reason. This module is that log:

- **fixed capacity, drop-oldest**: events land in a ``deque(maxlen=N)``
  under one lock; when the ring is full the oldest event silently ages
  out and ``dropped`` counts it — memory is bounded no matter how long
  the server runs (an event is ~200 bytes; the default 4096 ≈ 1 MB).
- **schema'd**: every event is ``{seq, t_s, type, trace, attrs}`` where
  ``type`` is one of the ``EV_*`` constants below and ``trace`` is the
  span id of the request root it belongs to (``obs/trace.py``) — the
  same id the Chrome span trace carries, so a flight event links back
  to its span tree and vice versa.
- **kill switch**: honors ``obs.metrics.enabled()`` — disabled means
  ``emit`` returns before touching the lock or allocating the event
  (the measurement-run guarantee; hot paths additionally guard at the
  call site so even the kwargs dict is never built).
- **crash dumps**: when a batch or session dies, the scheduler calls
  :meth:`FlightRecorder.crash_dump` — the last N events plus the live
  scheduler state written as one JSON file (``flight_crash_*.json``)
  into ``TPU_LLM_CRASH_DIR`` (default: the working directory, next to
  wherever the span trace is being exported). Dumping must never
  raise: forensics cannot be allowed to compound the failure.

Emission is threaded through ``serve/scheduler.py`` (admissions, join
chunks, slice boundaries, retirements, fallbacks), ``engine/stepped.py``
/ ``engine/torch_engine.py`` (decode windows, goodput accounting — see
``obs/detect.py``) and ``engine/paged_kv.py`` (pool exhaustion).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .metrics import REGISTRY, enabled

# -- event schema --------------------------------------------------------------
# One constant per event type; emitters use these, never ad-hoc strings,
# so /debug/flight consumers and the bench summary can rely on the set.
EV_REQUEST_ADMITTED = "request_admitted"  # ticket entered a batch/session
EV_JOIN_CHUNK = "join_chunk"  # one token-budgeted join-prefill chunk ran
EV_SLICE = "slice"  # one bounded decode slice completed
EV_ROW_RETIRED = "row_retired"  # a row left the session
#   {eos|budget|error|shutdown|cancelled|deadline}
EV_REQUEST_REJECTED = "request_rejected"  # queued ticket refused pre-admission
#   (deadline already passed / TTFT SLO unmeetable)
EV_ROW_PREEMPTED = "preempted"  # a lower-tier live row was preempted for a
#   higher-tier ticket (trace = victim; by = preemptor's trace; policy
#   = swap|recompute; swapped pages/bytes ride along)
EV_ROW_RESUMED = "resumed"  # a preempted row re-entered its session
#   (trace = victim; parked_s, aged tier, policy actually used)
EV_ROW_MIGRATED = "row_migrated"  # a live row moved between replicas
#   (trace = the ticket; from/to replica ids, reason =
#   disagg|drain, blob bytes ride along — emitted by the router on the
#   trace both replicas' flight rings share)
EV_BATCH_FALLBACK = "batch_fallback"  # batch/session dispatch failed → bisection
# Replica-fleet routing (serve/router.py):
EV_DISPATCHED = "dispatched"  # the router sent a ticket to a replica
EV_AFFINITY_ROUTE = "affinity_route"  # the affinity policy matched a
# ticket's prompt prefix to a replica's probed radix-store digest
# (est_tokens: the probe-side longest-match estimate that won the pick)
#   (trace = ticket's root; replica, policy, retry flag ride along)
EV_REPLICA_DOWN = "replica_down"  # a replica turned unhealthy (probe
#   failure or a dispatch-observed death; error attr says which)
EV_REPLICA_DRAINED = "replica_drained"  # drain() completed: in-flight
#   rows finished and the replica detached from the fleet
# Multi-model serving (serve/model_fleet.py + the engines'
# weight LRU):
EV_MODEL_LOADED = "model_loaded"  # a model's weights became resident
#   (trace-linked to the request that triggered the load when one did)
EV_MODEL_EVICTED = "model_evicted"  # a model's weights left the device
#   (reason = lru|reinstall|unload; deferred evictions emit nothing —
#   they count on llm_model_evict_deferred_total instead)
EV_MODEL_ESCALATED = "model_escalated"  # a small-first cascade abandoned
#   the small model's answer and re-ran on the big one (trace = the
#   request; from/to models + the wasted-Joules charge ride along)
EV_POOL_EXHAUSTED = "pool_exhausted"  # PagePool refused an allocation
EV_PREFIX_HIT = "prefix_hit"  # a joiner reused cached shared-prefix KV
EV_PREFIX_EVICT = "prefix_evict"  # a prefix-store node was evicted (LRU)
EV_PREFIX_SPILL = "prefix_spill"  # a cold prefix-store node's pages were
#   swapped out to host RAM (the LRU spill tier)
EV_PREFIX_RESTORE = "prefix_restore"  # a spilled prefix-store node was
#   swapped back into fresh pool pages on a hit
EV_SPEC_ROUND = "spec_round"  # one speculative window's rounds/acceptance
EV_SPEC_FALLBACK = "spec_fallback"  # session acceptance fell below the floor
EV_SPEC_K_ADAPT = "spec_k_adapt"  # adaptive draft length moved
#   k halves below the floor / restores toward the configured k on recovery)
EV_STREAM_CHUNK = "stream_chunk"  # one egress push of a streaming row's
#   new tokens into its per-request channel (the wire-visible moment of
#   token delivery — the "stream chunks" phase of a /debug/timeline)
EV_DECODE_WINDOW = "decode_window"  # engine fence-timed decode window
EV_ANOMALY = "anomaly"  # detector fired (obs/detect.py)
EV_SLO_ALERT = "slo_alert"  # an SLO burn-rate alert transitioned
#   (state = firing|resolved; one synthetic trace id per episode links
#   the firing to its resolution — obs/slo.py)
EV_CRASH_DUMP = "crash_dump"  # a crash dump was written

# Ring capacity: ~1 MB worst case, hours of serving at typical event
# rates (a few events per slice). Env-overridable for soak tests.
DEFAULT_CAPACITY = int(os.environ.get("TPU_LLM_FLIGHT_CAPACITY", 4096))
# Events included in a crash dump (the tail that explains the failure).
CRASH_DUMP_EVENTS = 256

_DROPPED_C = REGISTRY.counter(
    "llm_flight_events_dropped_total",
    "Flight-recorder events aged out of the ring before export",
)
_EVENTS_C = REGISTRY.counter(
    "llm_flight_events_total",
    "Flight-recorder events recorded, by type",
    labels=("type",),
)


class FlightEvent:
    """One recorded event. ``trace`` is the owning request root's span id
    (None for events with no request context); ``trace_id`` is the
    FLEET-WIDE wire trace (``x_trace``) the request carries across
    processes — the key ``/debug/flight?trace=`` and the router's
    ``/debug/timeline`` filter on."""

    __slots__ = ("seq", "t_s", "type", "trace", "trace_id", "attrs")

    def __init__(
        self,
        seq: int,
        t_s: float,
        type_: str,
        trace: Optional[int],
        attrs: Dict[str, Any],
        trace_id: Optional[str] = None,
    ) -> None:
        self.seq = seq
        self.t_s = t_s
        self.type = type_
        self.trace = trace
        self.trace_id = trace_id
        self.attrs = attrs

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "seq": self.seq,
            "t_s": round(self.t_s, 6),
            "type": self.type,
        }
        if self.trace is not None:
            d["trace"] = self.trace
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.attrs:
            d.update(self.attrs)
        return d


class FlightRecorder:
    """Thread-safe fixed-capacity event ring (see the module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._lock = threading.Lock()
        self._events: "deque[FlightEvent]" = deque(maxlen=max(1, capacity))
        self._seq = 0
        self._dropped = 0
        self._counts: Dict[str, int] = {}

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    # -- recording ------------------------------------------------------------
    def emit(
        self,
        type_: str,
        trace: Optional[int] = None,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ) -> Optional[FlightEvent]:
        """Record one event. No-op (returns None) when telemetry is off.

        ``trace`` is a span id (``Span.span_id``); pass the request
        root's so the event links back to the span tree. ``trace_id``
        is the request's fleet-wide wire trace (``x_trace``) — pass
        both with :func:`trace_attrs`.
        """
        if not enabled():
            return None
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
                _DROPPED_C.inc()
            event = FlightEvent(
                self._seq, now, type_, trace, attrs, trace_id=trace_id
            )
            self._events.append(event)
            self._counts[type_] = self._counts.get(type_, 0) + 1
        # the labelled counter outside the ring lock (it takes the family
        # lock only on first label touch)
        _EVENTS_C.labels(type=type_).inc()
        return event

    # -- introspection --------------------------------------------------------
    def events(
        self,
        n: Optional[int] = None,
        type_: Optional[str] = None,
        trace: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """The last ``n`` events (all when None), oldest first, optionally
        filtered by type and/or trace. ``trace`` matches the fleet-wide
        ``trace_id`` (hex string) — or, when it parses as an integer,
        the process-local span id too, so pre-wire-trace consumers keep
        working. Returns plain dicts — safe to JSON-serialise."""
        with self._lock:
            snap = list(self._events)
        if type_ is not None:
            snap = [e for e in snap if e.type == type_]
        if trace is not None:
            span_id: Optional[int] = None
            try:
                span_id = int(trace)
            except ValueError:
                pass
            snap = [
                e
                for e in snap
                if e.trace_id == trace
                or (span_id is not None and e.trace == span_id)
            ]
        if n is not None and n >= 0:
            snap = snap[-n:] if n else []
        return [e.to_dict() for e in snap]

    def summary(self) -> Dict[str, Any]:
        """Event counts by type + drop count — the shape bench.py attaches
        as ``obs_flight`` and /debug/state embeds."""
        with self._lock:
            return {
                "events_total": self._seq,
                "in_ring": len(self._events),
                "dropped": self._dropped,
                "by_type": dict(sorted(self._counts.items())),
            }

    def clear(self) -> None:
        """Test/bench isolation only."""
        with self._lock:
            self._events.clear()
            self._seq = 0
            self._dropped = 0
            self._counts.clear()

    # -- export ---------------------------------------------------------------
    def export_jsonl(self, path) -> int:
        """One JSON object per line, oldest first. Returns events written."""
        events = self.events()
        with open(path, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        return len(events)

    def crash_dump(
        self,
        reason: str,
        state: Optional[Dict[str, Any]] = None,
        path=None,
        last_n: int = CRASH_DUMP_EVENTS,
    ) -> Optional[str]:
        """Write the last ``last_n`` events + the caller's live state as
        one JSON file and record an EV_CRASH_DUMP event pointing at it.

        Default location: ``$TPU_LLM_CRASH_DIR`` (falling back to the
        working directory — next to an exported span trace), named
        ``flight_crash_<pid>_<seq>.json``. Never raises (returns None on
        any failure): the dump is forensics for a failure already in
        progress and must not mask it. No-op when telemetry is off.
        """
        if not enabled():
            return None
        try:
            if path is None:
                out_dir = os.environ.get("TPU_LLM_CRASH_DIR") or "."
                with self._lock:
                    seq = self._seq
                path = os.path.join(
                    out_dir, f"flight_crash_{os.getpid()}_{seq}.json"
                )
            payload = {
                "reason": reason,
                "t_s": round(time.monotonic(), 6),
                "summary": self.summary(),
                "events": self.events(n=last_n),
                "state": state,
            }
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
        except Exception:  # noqa: BLE001 — forensics must never compound
            return None
        self.emit(EV_CRASH_DUMP, reason=reason, path=str(path))
        return str(path)


def trace_of(span) -> Optional[int]:
    """The flight-recorder trace id of a span (or None) — one definition
    so scheduler emit sites cannot drift from the span tree's ids."""
    return span.span_id if span is not None else None


def trace_attrs(span, tenant: "str | None" = None) -> Dict[str, Any]:
    """BOTH trace keys of a span for ``FLIGHT.emit(**trace_attrs(s))``:
    the process-local span id (``trace``) and — when the request carried
    one — the fleet-wide wire trace (``trace_id``). One definition so
    every emit site links events identically across processes. Emit
    sites with a request in hand pass its ``tenant`` so the
    flight story filters per tenant; the default tenant is omitted to
    keep single-tenant event streams byte-identical."""
    out: Dict[str, Any] = {"trace": None} if span is None else {
        "trace": span.span_id
    }
    if span is not None:
        tid = getattr(span, "trace_id", None)
        if tid is not None:
            out["trace_id"] = tid
    if tenant is not None and tenant != "default":
        out["tenant"] = tenant
    return out


# THE process-wide recorder every instrumented module shares.
FLIGHT = FlightRecorder()
