"""Replica-fleet serving: a metrics-driven front door over independent
stepped-session replicas.

Everything below this module lives in ONE scheduler driving ONE engine:
admission is capped by a single PagePool's HBM no matter how good the
iteration-level scheduler is. This module is the data-parallel layer
above it — the Orca-style serving analogue of data parallelism: N fully
independent ``ContinuousScheduler`` + engine replicas behind one HTTP
front door that speaks the SAME wire protocol (SSE streaming,
``x_priority``, ``x_deadline_ms``) and dispatches each ticket by live
replica gauges. The source paper asks where a request should run
(on-device vs remote) from offline measurements; the router turns that
into an ONLINE policy — ``least-joules`` routes by the live
``llm_request_joules_per_token`` attribution, next to the queue-depth
and pool-occupancy policies.

Pieces:

- :class:`LocalReplica` — an in-process backend + scheduler pair (the
  CI/test fleet shape, and ``serve --replicas N``): probed by direct
  calls (``scheduler.health_state()``), dispatched by direct calls
  (``submit``/``submit_stream``) — no loopback HTTP tax.
- :class:`RemoteReplica` — a replica living in another process/host,
  reached through :class:`~.client.RemoteHTTPBackend`: probed via
  ``GET /healthz`` (liveness + scheduler kind + inflight, works under
  the replica's telemetry kill switch) plus a best-effort ``/metrics``
  scrape for the pool-occupancy / J-per-token gauges; dispatched over
  the wire (``serve-fleet --targets``).
- :class:`Router` — fleet membership + health probing + the pluggable
  dispatch policy + the RETRY-ONCE rule: a ticket whose chosen replica
  refuses admission or dies before its first streamed token is retried
  on ONE different replica; after the first streamed token a death is
  surfaced as a terminal stream error, never retried (the client
  already consumed output — a silent replay would duplicate it).
  ``drain()`` stops new dispatch to a replica, lets its in-flight rows
  finish, then detaches it; ``add_replica()`` scales the fleet up.
- :class:`RouterServer` — the HTTP front door itself: ``/api/generate``
  (buffered + SSE streaming; a client hanging up mid-stream cancels the
  replica-side row through the closed chunk iterator), ``/healthz``,
  ``/metrics``, ``/debug/state`` (per-replica snapshot + last probe),
  ``/debug/flight`` and ``/debug/timeline``.

Observability (fleet-native): the front door mints (or
adopts) the fleet-wide ``x_trace`` and forwards it on EVERY dispatch
attempt — a retried ticket's two attempts share one trace id, and
``GET /debug/timeline?trace=`` reassembles the cross-process story
from each involved replica's ``/debug/flight?trace=``. ``GET
/metrics`` additionally serves the ``llm_fleet_*`` federation rollup
(counters summed, fixed-bucket histograms merged bucket-wise, gauges
re-labelled ``{replica=...}`` — ``obs/metrics.py::merge_expositions``
over the replicas' scrapes), and a DEAD dispatch attempt charges the
wasted-energy ledger (``llm_request_wasted_joules_total{cause=
"retry"}``, the figure riding the retried ticket's
``x_extras.energy``). Router families: ``llm_router_dispatch_total
{replica,policy}``, ``llm_router_retries_total{reason}``, the
per-replica ``llm_router_replica_healthy`` gauge,
``llm_router_probe_seconds``, plus ``dispatched`` / ``replica_down`` /
``replica_drained`` flight events trace-linked to the ticket's
request root.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Tuple

from ..engine.backend import (
    GenerationBackend,
    GenerationChunk,
    GenerationRequest,
    GenerationResult,
)
from ..engine.radix_store import prefix_chunk_hashes
from ..obs import energy as obs_energy
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import tenants as obs_tenants
from ..obs import timeseries as obs_ts
from ..obs.flight import (
    EV_AFFINITY_ROUTE,
    EV_DISPATCHED,
    EV_REPLICA_DOWN,
    EV_REPLICA_DRAINED,
    EV_ROW_MIGRATED,
    FLIGHT,
    trace_attrs,
)
from ..obs.metrics import (
    MIGRATE_ROWS_C,
    REGISTRY,
    histogram_mean,
    merge_expositions,
    parse_exposition,
    sample_value,
)
from ..obs.trace import TRACER, TraceContext
from ..runner import term
from . import protocol
from .client import RemoteHTTPBackend, RemoteServerError, fetch_flight
from .migrate import SEAT_REFUSED, bundle_nbytes
from .stream import DeadlineExceeded, StreamCancelled

ROUTE_POLICIES = (
    "least-queue",  # fewest queued + in-flight rows (default)
    "least-pages",  # lowest paged-pool occupancy (falls back to queue)
    "least-joules",  # lowest recent J/token (falls back to queue)
    "round-robin",  # membership order, rotating
    "affinity",  # longest probed prefix match (falls back to queue)
)

# How often the background prober refreshes every replica's stats. The
# dispatch policies additionally weigh the router's own REAL-TIME
# outstanding-ticket counts, so a stale probe between two ticks cannot
# pile a burst onto one replica.
DEFAULT_PROBE_INTERVAL_S = 1.0

_DISPATCH_C = REGISTRY.counter(
    "llm_router_dispatch_total",
    "Tickets dispatched to a replica by the front-door router (each "
    "retry attempt counts again, on the replica that received it)",
    labels=("replica", "policy"),
)
_RETRIES_C = REGISTRY.counter(
    "llm_router_retries_total",
    "Tickets re-dispatched to a different replica, by reason (refused: "
    "the replica declined admission — scheduler stopped or fleet-full; "
    "dead: the replica errored/disconnected before the ticket's first "
    "streamed token)",
    labels=("reason",),
)
_REPLICA_HEALTHY_G = REGISTRY.gauge(
    "llm_router_replica_healthy",
    "1 while a replica answers its health probe (0: down or detached)",
    labels=("replica",),
)
_PROBE_H = REGISTRY.histogram(
    "llm_router_probe_seconds",
    "Wall time of one replica health/metrics probe",
)
_AFFINITY_C = REGISTRY.counter(
    "llm_router_affinity_hits_total",
    "Tickets routed by a positive prefix-affinity match (policy "
    "affinity): the probed digest of the chosen replica's radix store "
    "held the ticket's longest estimated prompt prefix",
    labels=("replica",),
)


def _affinity_estimate(
    digest, prompt: str, model: Optional[str] = None
) -> int:
    """Probe-side longest-match estimate: tokens of
    ``prompt`` a replica's published prefix digest claims to hold warm.
    The prompt is tokenized with the ByteTokenizer convention (BOS +
    byte+3 — the same estimate `_dispatch_failed` prices waste with)
    and chunk-hashed at each entry's page width via the ONE hash the
    store exports (`engine/radix_store.prefix_chunk_hashes`), so a
    replica on a different tokenizer simply never matches — the honest
    degradation is the least-queue fallback, never a wrong match. The
    estimate counts consecutive matching page hashes; when EVERY
    exported hash matches, the claim extends to the entry's full token
    depth (capped by the prompt's own length)."""
    if not digest or not prompt:
        return 0
    entries = (
        digest.get("entries") if isinstance(digest, dict) else None
    ) or []
    if not entries:
        return 0
    ids = [1] + [b + 3 for b in prompt.encode("utf-8")]
    hashed: Dict[int, List[str]] = {}  # page width -> my chunk hashes
    best = 0
    for entry in entries:
        try:
            e_model = entry.get("model")
            if (
                model is not None
                and e_model is not None
                and e_model != model
            ):
                continue
            page = int(entry.get("page") or 0)
            want = entry.get("h") or []
            if page <= 0 or not want:
                continue
            mine = hashed.get(page)
            if mine is None:
                mine = prefix_chunk_hashes(ids, page)
                hashed[page] = mine
            matched = 0
            for a, b in zip(mine, want):
                if a != b:
                    break
                matched += 1
            est = matched * page
            if matched and matched == len(want):
                est = max(
                    est, min(int(entry.get("tokens") or 0), len(ids))
                )
            best = max(best, est)
        except Exception:  # noqa: BLE001 — a malformed entry scores 0
            continue
    return best


def _retry_reason(exc: BaseException) -> Optional[str]:
    """Classify a dispatch failure for the retry-once rule: ``refused``
    (the replica declined admission, or a migrated row's seat),
    ``dead`` (it errored or the
    connection dropped), or None — the ticket's own terminal outcome
    (bad request, unknown model, deadline, cancellation), which a
    different replica would only repeat."""
    if isinstance(
        exc, (DeadlineExceeded, StreamCancelled, ValueError, KeyError)
    ):
        return None
    if isinstance(exc, RuntimeError) and SEAT_REFUSED in str(exc):
        # an idle receiver of a migrated row, local or over the wire:
        # a live server declining that seat, not a death
        return "refused"
    if isinstance(exc, RemoteServerError):
        if exc.status == 503:
            return "refused"
        if exc.status >= 500:
            return "dead"
        return None
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        if "not running" in msg or "shutting down" in msg:
            return "refused"
        return "dead"
    if isinstance(exc, (urllib.error.URLError, OSError)):
        return "dead"
    if isinstance(exc, Exception):
        return "dead"  # an engine death surfaces as its own exception
    return None  # KeyboardInterrupt/SystemExit etc: never retried


class MigrateDispatchFailed(RuntimeError):
    """Every candidate seat for a migrated row failed BEFORE relaying
    any output. Nothing reached the client, so the caller
    may safely re-dispatch the original request from scratch — the
    distinction this type exists to carry; a post-output death raises
    the replica's own error instead and is never retried."""


class Replica:
    """One fleet member: a name, a dispatch surface (``generate`` /
    ``stream``), a probe, and the router-side bookkeeping (health,
    draining flag, real-time outstanding count)."""

    kind = "replica"

    def __init__(self, name: str) -> None:
        self.name = name
        self.healthy = True
        self.role = "mixed"  # disagg fleet role
        self.draining = False
        self.outstanding = 0  # tickets the router currently has on us
        self.dispatched = 0  # attempts routed here (lifetime)
        self.last_stats: Dict[str, object] = {}
        self.t_probe: Optional[float] = None
        # last successful /metrics scrape text (remote replicas only) —
        # the federation's fallback source when a live scrape fails
        self.last_metrics_text: Optional[str] = None

    # -- dispatch surface (subclasses implement) -------------------------------
    def generate(self, request: GenerationRequest) -> GenerationResult:
        raise NotImplementedError

    def stream(self, request: GenerationRequest) -> Iterator[GenerationChunk]:
        raise NotImplementedError

    def prime(self, request: GenerationRequest) -> Iterator[GenerationChunk]:
        """Disagg prime: prefill to completion, export the
        row, answer with a final chunk whose ``result.extras["migrate"]``
        carries the bundle. Default: decay to a normal stream — the
        router reads the missing bundle as "serve it here"."""
        return self.stream(request)

    def migrate(self, bundle: dict) -> Iterator[GenerationChunk]:
        """Seat one migrate bundle and stream the row from its cursor."""
        raise RuntimeError(
            f"replica {self.name!r} cannot seat migrated rows"
        )

    def evacuate(self, timeout_s: float = 30.0) -> int:
        """Export every exportable in-flight row (drain-evacuation);
        each bundle rides its own stream's final record. Returns the
        count; 0 for replicas without the machinery."""
        return 0

    def probe(self) -> Dict[str, object]:
        """Liveness + the policy gauges. Raises when the replica is
        unreachable; returns ``{"running": False, ...}`` when it
        answers but is shutting down."""
        raise NotImplementedError

    def scrape_metrics(self) -> Optional[str]:
        """This replica's own Prometheus exposition for the federation
        rollup. None for in-process replicas — they share
        THIS process's registry, which the router's /metrics federates
        exactly once as the ``local`` source instead."""
        return None

    def flight_events(self, trace: str) -> List[Dict[str, object]]:
        """This replica's flight events for one fleet-wide trace id —
        the per-hop pull of the cross-process timeline. In-process
        replicas share the router's recorder, so their events are
        already in the router's own ring (return [] here)."""
        return []

    def tenants_state(self) -> Optional[Dict[str, object]]:
        """This replica's per-tenant usage snapshot. None
        for in-process replicas — they share THIS process's tenant
        table, which the router reports exactly once as ``local``."""
        return None

    def close(self) -> None:
        """Release whatever this replica owns (local: stop its
        scheduler; remote: nothing — the process is not ours)."""

    def debug_state(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "kind": self.kind,
            "healthy": self.healthy,
            "role": self.role,
            "draining": self.draining,
            "outstanding": self.outstanding,
            "dispatched": self.dispatched,
            "last_probe": self.last_stats,
            "probe_age_s": (
                round(time.monotonic() - self.t_probe, 4)
                if self.t_probe is not None
                else None
            ),
        }


class LocalReplica(Replica):
    """An in-process backend + scheduler pair. The scheduler is built
    here (continuous for stepped backends, window otherwise — the same
    auto rule as :class:`~.server.GenerationServer`) and owned here:
    ``close()`` stops it. Probes and dispatch are direct calls."""

    kind = "local"

    def __init__(
        self,
        name: str,
        backend: GenerationBackend,
        scheduler: Optional[object] = None,
        start: bool = True,
        role: str = "mixed",
        **scheduler_kwargs,
    ) -> None:
        super().__init__(name)
        if role not in protocol.SERVER_ROLES:
            raise ValueError(
                f"role must be one of {protocol.SERVER_ROLES}, got {role!r}"
            )
        self.role = role
        self.backend = backend
        if scheduler is None:
            from .scheduler import BatchScheduler, ContinuousScheduler

            if hasattr(backend, "decode_open"):
                scheduler = ContinuousScheduler(backend, **scheduler_kwargs)
            else:
                scheduler_kwargs.pop("slice_steps", None)
                scheduler_kwargs.pop("prefill_chunk_tokens", None)
                scheduler_kwargs.pop("spec_accept_floor", None)
                scheduler_kwargs.pop("preempt_policy", None)
                scheduler_kwargs.pop("preempt_max_wait_s", None)
                scheduler = BatchScheduler(backend, **scheduler_kwargs)
        self.scheduler = scheduler
        if start:
            self.scheduler.start()

    def generate(self, request: GenerationRequest) -> GenerationResult:
        return self.scheduler.submit(request)

    @staticmethod
    def _channel_chunks(channel) -> Iterator[GenerationChunk]:
        def gen():
            finished = False
            try:
                for event in channel.events():
                    if event.kind == "delta":
                        yield GenerationChunk(
                            text=event.text, tokens=list(event.tokens)
                        )
                    elif event.kind == "done":
                        finished = True
                        yield GenerationChunk(
                            text="", tokens=[], done=True, result=event.result
                        )
                    elif event.kind == "error":
                        finished = True
                        raise event.error
            finally:
                # closed early (front-door client hung up, or the retry
                # machinery abandoned us): cancel the replica-side row
                # so its pages recycle within one decode slice
                if not finished:
                    channel.cancel(cause="disconnect")

        return gen()

    def stream(self, request: GenerationRequest) -> Iterator[GenerationChunk]:
        return self._channel_chunks(self.scheduler.submit_stream(request))

    def prime(self, request: GenerationRequest) -> Iterator[GenerationChunk]:
        if not hasattr(self.scheduler, "submit_prime"):
            return self.stream(request)  # window scheduler: decay
        return self._channel_chunks(self.scheduler.submit_prime(request))

    def migrate(self, bundle: dict) -> Iterator[GenerationChunk]:
        if not hasattr(self.scheduler, "submit_migrate"):
            raise RuntimeError(
                f"replica {self.name!r} scheduler cannot seat migrated "
                "rows (not running continuous dispatch)"
            )
        return self._channel_chunks(self.scheduler.submit_migrate(bundle))

    def evacuate(self, timeout_s: float = 30.0) -> int:
        evacuate = getattr(self.scheduler, "evacuate", None)
        if evacuate is None:
            return 0
        return int(evacuate(timeout_s=timeout_s))

    def probe(self) -> Dict[str, object]:
        stats: Dict[str, object] = dict(self.scheduler.health_state())
        stats["status"] = "ok" if stats.get("running") else "stopping"
        stats["role"] = self.role
        # pool occupancy (least-pages), best-effort off the live session
        try:
            session = self.scheduler.debug_state().get("session") or {}
            pool = session.get("pool") or {}
            if "occupancy" in pool:
                stats["pool_occupancy"] = pool["occupancy"]
            if "pages" in pool:
                stats["pool_pages"] = pool["pages"]
        except Exception:  # noqa: BLE001 — probe only
            pass
        # store-held pages: a replica fat with REUSABLE
        # prefixes must not be penalized like one fat with live traffic
        # — least-pages discounts these from the occupancy figure
        try:
            store = getattr(self.backend, "prefix_store", None)
            if store is not None:
                stats["prefix_store_hbm_pages"] = int(
                    store.debug_state().get("hbm_pages") or 0
                )
        except Exception:  # noqa: BLE001 — probe only
            pass
        # bounded prefix digest (affinity): the same summary
        # /healthz exports, read directly off the in-process store
        try:
            store = getattr(self.backend, "prefix_store", None)
            if store is not None and hasattr(store, "digest"):
                stats["prefix_digest"] = store.digest()
        except Exception:  # noqa: BLE001 — probe only
            pass
        # live J/token (least-joules): engines — real AND fake — publish
        # their most recent attribution as an attribute, so the policy
        # works in-process without a loopback /metrics scrape (the
        # fake fleet can exercise least-joules too)
        jpt = getattr(self.backend, "last_joules_per_token", None)
        if jpt:
            stats["joules_per_token"] = float(jpt)
        # loaded-model set: the placement dimension —
        # dispatch prefers replicas already holding a request's weights
        # warm over ones that would pay a load + LRU eviction
        try:
            stats["loaded_models"] = list(self.backend.loaded_models())
        except Exception:  # noqa: BLE001 — probe only
            pass
        return stats

    def close(self) -> None:
        self.scheduler.stop()


class RemoteReplica(Replica):
    """A replica in another process/host, spoken to over the wire. The
    probe is ``GET /healthz`` (cheap, kill-switch-proof) plus a
    best-effort ``/metrics`` scrape for the pool/energy gauges (absent
    when the replica runs ``--no-telemetry`` — the queue/inflight
    fields from /healthz still feed least-queue routing)."""

    kind = "remote"

    def __init__(
        self,
        name: str,
        base_url: str,
        timeout_s: float = 600.0,
        probe_timeout_s: float = 5.0,
    ) -> None:
        super().__init__(name)
        self.client = RemoteHTTPBackend(base_url, timeout_s=timeout_s)
        self.base_url = self.client.base_url
        self.probe_timeout_s = probe_timeout_s

    def generate(self, request: GenerationRequest) -> GenerationResult:
        return self.client.generate(request)

    def stream(self, request: GenerationRequest) -> Iterator[GenerationChunk]:
        return self.client.generate_stream(request)

    def prime(self, request: GenerationRequest) -> Iterator[GenerationChunk]:
        return self.client.generate_stream(request, prime=True)

    def migrate(self, bundle: dict) -> Iterator[GenerationChunk]:
        return self.client.migrate_stream(bundle)

    def evacuate(self, timeout_s: float = 30.0) -> int:
        return self.client.evacuate(timeout_s=timeout_s)

    def probe(self) -> Dict[str, object]:
        with urllib.request.urlopen(
            f"{self.base_url}{protocol.HEALTH_PATH}",
            timeout=self.probe_timeout_s,
        ) as resp:
            stats: Dict[str, object] = json.loads(resp.read().decode("utf-8"))
        stats["running"] = stats.get("status") == "ok"
        # the replica declares its own fleet role on /healthz ; the router adopts it on every probe, so a restarted
        # process coming back under a different role re-classifies
        role = str(stats.get("role") or "mixed")
        if role in protocol.SERVER_ROLES:
            self.role = role
        try:
            text = self.scrape_metrics()
            # the shared v0.0.4 parser (obs/metrics.py) replaces the old
            # two-regex scrape: any gauge/histogram family is readable
            # generically, and the SAME parse feeds probe stats here and
            # the fleet federation rollup
            families = parse_exposition(text or "")
            occ = sample_value(families, "llm_paged_pool_occupancy")
            if occ is not None:
                stats["pool_occupancy"] = occ
            pages = sample_value(families, "llm_paged_pool_pages")
            if pages is not None:
                stats["pool_pages"] = pages
            store_pages = sample_value(
                families, "llm_prefix_store_hbm_pages"
            )
            if store_pages is not None:
                stats["prefix_store_hbm_pages"] = store_pages
            jpt = histogram_mean(
                families, "llm_request_joules_per_token"
            )
            if jpt is not None:
                stats["joules_per_token"] = jpt
        except Exception:  # noqa: BLE001 — telemetry may be off (404)
            pass
        # loaded-model set via /api/ps: answers under the
        # replica's telemetry kill switch too — model residency is
        # protocol, not observability
        try:
            with urllib.request.urlopen(
                f"{self.base_url}{protocol.PS_PATH}",
                timeout=self.probe_timeout_s,
            ) as resp:
                body = json.loads(resp.read().decode("utf-8"))
            stats["loaded_models"] = [
                str(m.get("name"))
                for m in body.get("models") or []
                if m.get("name")
            ]
        except Exception:  # noqa: BLE001 — probe only
            pass
        return stats

    def scrape_metrics(self) -> Optional[str]:
        """Fetch this replica's live /metrics text (also cached for the
        federation's use when a later scrape fails mid-flight)."""
        with urllib.request.urlopen(
            f"{self.base_url}{protocol.METRICS_PATH}",
            timeout=self.probe_timeout_s,
        ) as resp:
            text = resp.read().decode("utf-8")
        self.last_metrics_text = text
        return text

    def flight_events(self, trace: str) -> List[Dict[str, object]]:
        body = fetch_flight(
            self.base_url, trace=trace, timeout_s=self.probe_timeout_s
        )
        return list(body.get("events") or [])

    def tenants_state(self) -> Optional[Dict[str, object]]:
        with urllib.request.urlopen(
            f"{self.base_url}{protocol.DEBUG_TENANTS_PATH}",
            timeout=self.probe_timeout_s,
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def debug_state(self) -> Dict[str, object]:
        state = super().debug_state()
        state["base_url"] = self.base_url
        return state


class Router:
    """Fleet membership + probing + policy dispatch + the retry-once
    rule (see the module docstring). Thread-safe: the HTTP front door
    dispatches from many handler threads while the prober refreshes
    stats in the background."""

    def __init__(
        self,
        replicas: List[Replica],
        policy: str = "least-queue",
        probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
        affinity_stale_s: Optional[float] = None,
    ) -> None:
        if policy not in ROUTE_POLICIES:
            raise ValueError(
                f"route policy must be one of {ROUTE_POLICIES}, got {policy!r}"
            )
        self.policy = policy
        self.probe_interval_s = float(probe_interval_s)
        # affinity: a digest older than this is STALE — the
        # store may have evicted/republished since, so the policy falls
        # back to least-queue rather than chase a ghost prefix. Default:
        # five missed probe ticks (floored so manual probe_now() tests
        # aren't racing a sub-second staleness horizon).
        self.affinity_stale_s = (
            float(affinity_stale_s)
            if affinity_stale_s is not None
            else max(5.0, 5.0 * self.probe_interval_s)
        )
        self._lock = threading.Lock()
        self._replicas: "Dict[str, Replica]" = {}
        self._rr = itertools.count()  # round-robin cursor
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        for replica in replicas:
            self.add_replica(replica)

    # -- membership ------------------------------------------------------------
    def add_replica(self, replica: Replica) -> None:
        """Scale-up: register (name must be fresh) and probe immediately
        so the new member is dispatchable the moment this returns."""
        with self._lock:
            if replica.name in self._replicas:
                raise ValueError(f"replica {replica.name!r} already attached")
            self._replicas[replica.name] = replica
        self._probe_one(replica)

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def evacuate_replica(self, name: str, timeout_s: float = 30.0) -> int:
        """Drain-evacuation: mark ``name`` draining (no new
        dispatch) and ask it to EXPORT its in-flight rows as migrate
        bundles instead of waiting them out. Each exported row's stream
        carries its bundle to the relaying front-door handler, which
        re-seats it on a survivor — the client streams never break.
        Returns the exported-row count (0: nothing exportable)."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica named {name!r}")
        replica.draining = True
        try:
            return int(replica.evacuate(timeout_s=timeout_s))
        except Exception:  # noqa: BLE001 — evacuation is best-effort;
            return 0  # whatever stayed put drains by waiting out

    def drain(
        self, name: str, timeout_s: float = 30.0, migrate: bool = False
    ) -> bool:
        """Elastic scale-down: stop dispatching to ``name``, wait for
        its in-flight tickets (router-side outstanding AND the
        replica's own queue/in-flight counts) to finish, then DETACH it
        — ``replica_drained`` flight event, healthy gauge to 0, local
        replicas' schedulers stopped. Returns False on timeout: the
        replica stays attached but draining (no new dispatch), so the
        caller can retry. ``migrate=True`` first EVACUATES
        the in-flight rows to surviving replicas (live migration,
        streams uninterrupted) instead of waiting them out — the
        drain-latency win ``bench.py pd_disagg`` measures."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"no replica named {name!r}")
        replica.draining = True
        if migrate:
            self.evacuate_replica(name, timeout_s=timeout_s)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            idle = replica.outstanding == 0
            if idle:
                try:
                    stats = replica.probe()
                    idle = (
                        int(stats.get("queue_depth") or 0) == 0
                        and int(stats.get("inflight_rows") or 0) == 0
                    )
                except Exception:  # noqa: BLE001 — unreachable = idle
                    idle = True
            if idle:
                break
            time.sleep(0.01)
        else:
            return False
        with self._lock:
            self._replicas.pop(name, None)
        _REPLICA_HEALTHY_G.labels(replica=name).set(0)
        FLIGHT.emit(
            EV_REPLICA_DRAINED,
            replica=name,
            dispatched=replica.dispatched,
        )
        try:
            replica.close()
        except Exception:  # noqa: BLE001 — detach must not fail the caller
            pass
        return True

    # -- probing ---------------------------------------------------------------
    def _probe_one(self, replica: Replica) -> None:
        t0 = time.monotonic()
        error: Optional[str] = None
        try:
            stats = replica.probe()
            healthy = bool(stats.get("running", True))
        except Exception as exc:  # noqa: BLE001 — down replica
            stats = {"error": f"{type(exc).__name__}: {exc}"}
            error = stats["error"]
            healthy = False
        _PROBE_H.observe(time.monotonic() - t0)
        replica.last_stats = stats
        replica.t_probe = time.monotonic()
        self._set_health(replica, healthy, error)

    def _set_health(
        self, replica: Replica, healthy: bool, error: Optional[str]
    ) -> None:
        was = replica.healthy
        replica.healthy = healthy
        _REPLICA_HEALTHY_G.labels(replica=replica.name).set(
            1.0 if healthy else 0.0
        )
        if was and not healthy:
            FLIGHT.emit(
                EV_REPLICA_DOWN,
                replica=replica.name,
                error=error or "unhealthy probe",
            )

    def probe_now(self) -> None:
        """One synchronous probe sweep (tests, and the prober's tick)."""
        for replica in self.replicas():
            self._probe_one(replica)

    def start(self) -> None:
        """Launch the background prober (idempotent)."""
        if self._probe_thread is not None:
            return
        self._stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-prober", daemon=True
        )
        self._probe_thread.start()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self.probe_now()

    def stop(self, close_replicas: bool = True) -> None:
        self._stop.set()
        thread, self._probe_thread = self._probe_thread, None
        if thread is not None:
            thread.join(timeout=5)
        if close_replicas:
            for replica in self.replicas():
                try:
                    replica.close()
                except Exception:  # noqa: BLE001
                    pass

    # -- policy ----------------------------------------------------------------
    def _load_key(self, replica: Replica) -> float:
        """The policy's load figure for one replica: last-probe gauges
        plus the router's REAL-TIME outstanding count (probes are
        periodic; outstanding moves per dispatch, so a burst between
        two probe ticks still spreads). Policies whose gauge a replica
        cannot provide (no paged pool, telemetry off) fall back to the
        queue figure — a missing metric must not starve a replica."""
        stats = replica.last_stats or {}
        queue_load = (
            float(stats.get("queue_depth") or 0)
            + float(stats.get("inflight_rows") or 0)
            + float(replica.outstanding)
        )
        if self.policy == "least-pages":
            occ = stats.get("pool_occupancy")
            if occ is not None:
                occ = float(occ)
                # discount STORE-held pages: they back
                # reusable prefixes, not live traffic — a replica hot
                # with cached prefixes is MORE attractive for matching
                # traffic, certainly not less, so only live-row pages
                # count as load
                store_pages = stats.get("prefix_store_hbm_pages")
                total = stats.get("pool_pages")
                if store_pages and total:
                    occ = max(
                        0.0, occ - float(store_pages) / float(total)
                    )
                # occupancy in [0,1]; outstanding breaks ties so two
                # equally-full pools still alternate
                return occ * 1e6 + queue_load
        elif self.policy == "least-joules":
            jpt = stats.get("joules_per_token")
            if jpt is not None:
                return float(jpt) * 1e6 + queue_load
        return queue_load

    def _admission_headroom(self, replica: Replica) -> Optional[float]:
        """Cached admission headroom (fleet-wide admission):
        the last probed ``max_admission_rows`` minus the tickets the
        router has dispatched there since (outstanding moves per ticket;
        probes are periodic — without the discount a burst between two
        ticks could stampede a replica the probe saw empty). None when
        the replica never reported the figure (old server, fake without
        a scheduler) — unknown capacity must not exclude anyone."""
        stats = replica.last_stats or {}
        probed = stats.get("max_admission_rows")
        if probed is None:
            return None
        return float(probed) - float(replica.outstanding)

    def _pick(
        self,
        exclude: "tuple" = (),
        model: Optional[str] = None,
        request: Optional[GenerationRequest] = None,
        decision: Optional[Dict[str, object]] = None,
    ) -> Optional[Replica]:
        with self._lock:
            # Role-aware membership: a decode-only replica
            # never takes fresh (prefill-bound) work — it exists to be
            # seated via /api/migrate. Prefill/mixed replicas take
            # anything (a prefill replica can always decode locally as
            # the fallback path).
            candidates = [
                r
                for r in self._replicas.values()
                if r.healthy
                and not r.draining
                and r.name not in exclude
                and r.role != "decode"
            ]
            if not candidates:
                return None
            # Model placement: when the ticket names a model
            # and SOME candidate already holds its weights warm, prefer
            # the warm set — a cold replica would pay a load (and
            # possibly an LRU eviction) before the first prefill. A
            # model nobody holds (or probes that don't report the set)
            # leaves the candidate set untouched: placement is a
            # preference, never a reachability constraint.
            if model is not None:
                warm = [
                    r
                    for r in candidates
                    if model
                    in ((r.last_stats or {}).get("loaded_models") or ())
                ]
                if warm:
                    candidates = warm
            # Fleet-wide admission: skip replicas whose
            # probed headroom is exhausted — consult capacity BEFORE
            # dispatching instead of bouncing off a refusal. Like model
            # placement this never empties the set: when EVERY candidate
            # looks full the probes may simply be stale, so dispatch
            # proceeds (the retry-once rule is still the backstop).
            with_room = [
                r
                for r in candidates
                if (lambda h: h is None or h > 0)(
                    self._admission_headroom(r)
                )
            ]
            if with_room:
                candidates = with_room
            # Prefix affinity: score candidates by the
            # probe-side longest-match estimate of the ticket's prompt
            # against each replica's published radix digest; the best
            # positive match wins (ties break by load then name —
            # deterministic). No match anywhere, stale digests, or no
            # prompt: fall through to the least-queue pick below,
            # byte-identical to the least-queue policy.
            if self.policy == "affinity" and request is not None:
                now = time.monotonic()
                best, pool = 0, []
                for r in candidates:
                    est = 0
                    fresh = (
                        r.t_probe is not None
                        and now - r.t_probe <= self.affinity_stale_s
                    )
                    if fresh:
                        est = _affinity_estimate(
                            (r.last_stats or {}).get("prefix_digest"),
                            request.prompt,
                            model,
                        )
                    if est > best:
                        best, pool = est, [r]
                    elif est == best and best > 0:
                        pool.append(r)
                if best > 0:
                    if decision is not None:
                        decision["affinity"] = "hit"
                        decision["affinity_tokens"] = int(best)
                    return min(
                        pool, key=lambda r: (self._load_key(r), r.name)
                    )
                if decision is not None:
                    decision["affinity"] = "fallback"
            if self.policy == "round-robin":
                return candidates[next(self._rr) % len(candidates)]
            return min(
                candidates, key=lambda r: (self._load_key(r), r.name)
            )

    def _pick_migrate_target(
        self, exclude: "tuple" = ()
    ) -> Optional[Replica]:
        """Where a migrated row should land: decode replicas first
        (that is what they are for), then mixed, then — port in a
        storm — a prefill replica (it can decode; better than dropping
        the ticket). Least-load within the preferred tier."""
        with self._lock:
            candidates = [
                r
                for r in self._replicas.values()
                if r.healthy and not r.draining and r.name not in exclude
            ]
        for want in ("decode", "mixed", "prefill"):
            pool = [r for r in candidates if r.role == want]
            if pool:
                return min(pool, key=lambda r: (self._load_key(r), r.name))
        return None

    def _disagg_plan(self) -> Optional[Tuple[Replica, Replica]]:
        """The disaggregated prefill/decode pipeline engages when the
        fleet holds at least one healthy prefill AND one healthy decode
        replica: returns (prefill, decode) picked least-load per role.
        Any other fleet shape returns None — dispatch stays the plain
        (byte-identical non-disaggregated) path."""
        with self._lock:
            live = [
                r
                for r in self._replicas.values()
                if r.healthy and not r.draining
            ]
        prefill = [r for r in live if r.role == "prefill"]
        decode = [r for r in live if r.role == "decode"]
        if not prefill or not decode:
            return None
        key = lambda r: (self._load_key(r), r.name)  # noqa: E731
        return min(prefill, key=key), min(decode, key=key)

    # -- dispatch --------------------------------------------------------------
    def _begin(
        self,
        replica: Replica,
        retried: Optional[str],
        attempt: int = 1,
        decision: Optional[Dict[str, object]] = None,
    ) -> None:
        with self._lock:
            replica.outstanding += 1
            replica.dispatched += 1
        _DISPATCH_C.labels(replica=replica.name, policy=self.policy).inc()
        hit = bool(decision) and decision.get("affinity") == "hit"
        if hit:
            _AFFINITY_C.labels(replica=replica.name).inc()
        if obs_metrics.enabled():
            FLIGHT.emit(
                EV_DISPATCHED,
                replica=replica.name,
                policy=self.policy,
                retry=retried,
                attempt=attempt,
                **trace_attrs(TRACER.current()),
            )
            if hit:
                FLIGHT.emit(
                    EV_AFFINITY_ROUTE,
                    replica=replica.name,
                    est_tokens=decision.get("affinity_tokens"),
                    **trace_attrs(TRACER.current()),
                )

    def _end(self, replica: Replica) -> None:
        with self._lock:
            replica.outstanding = max(0, replica.outstanding - 1)

    def _dispatch_failed(
        self,
        replica: Replica,
        exc: BaseException,
        reason: str,
        request: Optional[GenerationRequest] = None,
    ) -> float:
        """Account one retryable dispatch failure: the retry counter
        moves, and a DEAD replica is marked unhealthy immediately (the
        next probe may resurrect it) — ``refused`` is a capacity
        answer from a live scheduler, not a death. A DEAD attempt also
        charges the wasted-energy ledger: the replica had
        accepted the ticket and burned (at least) its prompt's prefill
        before dying unstreamed — estimated at the prompt's token count
        priced by the replica's last probed J/token (falling back to
        the process-live figure). Returns the Joules charged so the
        caller can stamp them on the retried ticket's extras."""
        _RETRIES_C.labels(reason=reason).inc()
        if reason == "refused":
            # Believe the refusal NOW: zero the cached
            # headroom so the admission gate stops offering this
            # replica until its next probe says otherwise — one stale
            # probe must not keep stampeding a full scheduler.
            stats = replica.last_stats
            if isinstance(stats, dict):
                stats["max_admission_rows"] = 0
        if reason != "dead":
            return 0.0
        self._set_health(replica, False, f"{type(exc).__name__}: {exc}")
        if request is None:
            return 0.0
        # byte tokenizer estimate (BOS + one id per byte) — the same
        # convention the engines' prompt accounting uses
        burned_tokens = len(request.prompt.encode("utf-8")) + 1
        jpt = (replica.last_stats or {}).get("joules_per_token")
        return obs_energy.charge_wasted(
            "retry",
            tokens=burned_tokens,
            jpt=float(jpt) if jpt else None,
        )

    def _stamp(
        self,
        result: GenerationResult,
        replica: Replica,
        retried: Optional[str],
        wasted_j: float = 0.0,
        migrate_j: float = 0.0,
        trace: Optional[TraceContext] = None,
        decision: Optional[Dict[str, object]] = None,
    ) -> None:
        """Route attribution onto the wire: ``extras["router"]`` rides
        ``x_extras`` so load generators and benches can split figures
        per replica without scraping anything; a retried ticket's
        first-attempt waste lands in ``extras["energy"]["wasted_J"]``
        next to the replica's own energy attribution, and a migrated
        ticket's transfer energy likewise (``"migration"`` key,
        the same figure the ledger charged)."""
        router_extras: Dict[str, object] = {
            "replica": replica.name,
            "role": replica.role,
            "policy": self.policy,
        }
        if trace is not None:
            router_extras["trace"] = trace.trace_id
        if retried:
            router_extras["retried"] = retried
        if decision and "affinity" in decision:
            # per-ticket routing verdict: "hit" carries the
            # estimator's token claim so load generators can split
            # prefix-hit tokens per replica; "fallback" records that
            # affinity ran and degraded to least-queue
            if decision["affinity"] == "hit":
                router_extras["affinity"] = {
                    "est_tokens": decision.get("affinity_tokens")
                }
            else:
                router_extras["affinity"] = "fallback"
        result.extras = {**(result.extras or {}), "router": router_extras}
        if wasted_j > 0 or migrate_j > 0:
            energy = dict(result.extras.get("energy") or {})
            wasted = dict(energy.get("wasted_J") or {})
            if wasted_j > 0:
                wasted["retry"] = round(
                    wasted.get("retry", 0.0) + wasted_j, 6
                )
            if migrate_j > 0:
                wasted["migration"] = round(
                    wasted.get("migration", 0.0) + migrate_j, 9
                )
            energy["wasted_J"] = wasted
            result.extras["energy"] = energy

    def dispatch(self, request: GenerationRequest) -> GenerationResult:
        """Buffered dispatch with the retry-once rule. Raises the
        replica's own terminal error (or ``RuntimeError`` when no
        healthy replica is attached). Both attempts of a retried
        ticket carry the SAME fleet-wide trace (the trace rides the
        request; only the dispatched events' attempt index differs).

        Disaggregated fleets: a membership with at least one
        healthy prefill AND one healthy decode replica runs the same
        prime→migrate pipeline the streaming path does, buffered — the
        blocking caller gets the decode side's final result with the
        full migration attribution on it."""
        plan = self._disagg_plan()
        if plan is not None:
            final: Optional[GenerationResult] = None
            for chunk in self._disagg_stream(request, *plan):
                if chunk.done and chunk.result is not None:
                    final = chunk.result
            if final is None:
                raise RuntimeError(
                    "disaggregated dispatch yielded no final result"
                )
            return final
        tried: "tuple" = ()
        retried: Optional[str] = None
        wasted_j = 0.0
        attempt = 0
        model = (
            request.model if request.model != protocol.AUTO_MODEL else None
        )
        while True:
            decision: Dict[str, object] = {}
            replica = self._pick(
                exclude=tried, model=model,
                request=request, decision=decision,
            )
            if replica is None:
                raise RuntimeError(
                    "no healthy replica available"
                    + (f" (after retry: {retried})" if retried else "")
                )
            attempt += 1
            self._begin(replica, retried, attempt=attempt, decision=decision)
            try:
                result = replica.generate(request)
            except BaseException as exc:  # noqa: BLE001
                self._end(replica)
                reason = _retry_reason(exc)
                if reason is None or retried is not None:
                    raise
                wasted_j += self._dispatch_failed(
                    replica, exc, reason, request
                )
                tried = (replica.name,)
                retried = reason
                continue
            self._end(replica)
            self._stamp(
                result, replica, retried,
                wasted_j=wasted_j, trace=request.trace,
                decision=decision,
            )
            return result

    def dispatch_stream(
        self, request: GenerationRequest
    ) -> Iterator[GenerationChunk]:
        """Streaming dispatch with the retry-once rule, which here is
        cut at the FIRST STREAMED TOKEN: a failure before any delta
        left the replica retries once elsewhere; after that the failure
        surfaces as the iterator's terminal exception (the front door
        turns it into a terminal SSE error event — no silent hang, no
        duplicate tokens). Closing the iterator cancels the
        replica-side row.

        Disaggregated fleets: when the membership holds at
        least one healthy prefill AND one healthy decode replica, the
        ticket runs the prime→migrate pipeline instead
        (:meth:`_disagg_stream`); any other fleet shape takes the plain
        path, byte-identical to pre-disagg behavior."""
        plan = self._disagg_plan()
        if plan is not None:
            yield from self._disagg_stream(request, *plan)
            return
        yield from self._dispatch_stream_plain(request)

    def _dispatch_stream_plain(
        self,
        request: GenerationRequest,
        tried: "tuple" = (),
        retried: Optional[str] = None,
        wasted_j: float = 0.0,
        migrate_j: float = 0.0,
    ) -> Iterator[GenerationChunk]:
        attempt = 0
        model = (
            request.model if request.model != protocol.AUTO_MODEL else None
        )
        while True:
            decision: Dict[str, object] = {}
            replica = self._pick(
                exclude=tried, model=model,
                request=request, decision=decision,
            )
            if replica is None:
                raise RuntimeError(
                    "no healthy replica available"
                    + (f" (after retry: {retried})" if retried else "")
                )
            attempt += 1
            self._begin(replica, retried, attempt=attempt, decision=decision)
            chunks: Optional[Iterator[GenerationChunk]] = None
            streamed = False
            evac_bundle: Optional[dict] = None
            try:
                try:
                    chunks = replica.stream(request)
                    for chunk in chunks:
                        if chunk.done and chunk.result is not None:
                            extras = chunk.result.extras or {}
                            bundle = extras.get("migrate")
                            if bundle is not None and extras.get(
                                "evacuated"
                            ):
                                # drain evacuation: the row
                                # left the replica mid-stream as a
                                # bundle; seat it on a survivor and
                                # keep THIS client stream going — the
                                # marker record is never forwarded
                                evac_bundle = dict(bundle)
                                break
                            self._stamp(
                                chunk.result, replica, retried,
                                wasted_j=wasted_j, migrate_j=migrate_j,
                                trace=request.trace, decision=decision,
                            )
                        yield chunk
                        if chunk.tokens or chunk.text:
                            streamed = True
                except BaseException as exc:  # noqa: BLE001
                    reason = _retry_reason(exc)
                    if reason is None or streamed or retried is not None:
                        raise
                    wasted_j += self._dispatch_failed(
                        replica, exc, reason, request
                    )
                    tried = (replica.name,)
                    retried = reason
                    continue
            finally:
                self._end(replica)
                if chunks is not None:
                    close = getattr(chunks, "close", None)
                    if close is not None:
                        close()
            if evac_bundle is not None:
                # drain evacuation relays OUTSIDE the victim's ticket
                # scope: its outstanding count and stream are released
                # FIRST, so a drain(migrate=True) caller unblocks at
                # evacuation time, not at the relayed stream's end —
                # the drain-latency win the pd_disagg bench measures
                yield from self._relay_migrated(
                    evac_bundle,
                    request,
                    reason="drain",
                    src=replica,
                    exclude=(replica.name,),
                    retried=retried,
                    wasted_j=wasted_j,
                    migrate_j=migrate_j,
                )
            return

    def _disagg_stream(
        self, request: GenerationRequest, src: Replica, dst: Replica
    ) -> Iterator[GenerationChunk]:
        """The disaggregated pipeline (tentpole): prime on the
        prefill replica (chunked-join prefill runs to completion with
        NO client-visible output), ship the exported row to the decode
        replica, relay its stream — one uninterrupted client stream
        whose TTFT is stamped by the decode side's first pushed chunk.
        Decays safely at every step: a prime that streams (window
        scheduler, spec-active session, shared prefix pages) is relayed
        as the answer; a prime leg dead before any output re-dispatches
        plain; a migrate leg dead before any output falls back to
        source-local decode, then to a full re-dispatch with the burned
        prefill charged to the migration ledger. The ticket is never
        dropped by a failed transfer."""
        self._begin(src, None)
        chunks: Optional[Iterator[GenerationChunk]] = None
        final: Optional[GenerationChunk] = None
        streamed = False
        failed: Optional[BaseException] = None
        try:
            try:
                chunks = src.prime(request)
                for chunk in chunks:
                    if chunk.done:
                        final = chunk
                        break
                    # the prime decayed into a live local stream: the
                    # prefill replica is serving the whole answer
                    streamed = True
                    yield chunk
            except BaseException as exc:  # noqa: BLE001
                if streamed or _retry_reason(exc) is None:
                    raise
                failed = exc
        finally:
            self._end(src)
            if chunks is not None:
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()
        if failed is not None:
            reason = _retry_reason(failed) or "dead"
            wasted = self._dispatch_failed(src, failed, reason, request)
            yield from self._dispatch_stream_plain(
                request, tried=(src.name,), retried=reason, wasted_j=wasted
            )
            return
        bundle = None
        if final is not None and final.result is not None and not streamed:
            bundle = (final.result.extras or {}).get("migrate")
        if bundle is None:
            # no bundle: the prefill replica answered locally (decayed
            # prime) — its final record is the client's final record
            if final is not None:
                if final.result is not None:
                    self._stamp(
                        final.result, src, None, trace=request.trace
                    )
                yield final
            return
        try:
            yield from self._relay_migrated(
                dict(bundle),
                request,
                reason="disagg",
                src=src,
                target=dst,
                fallback=src,
            )
        except MigrateDispatchFailed:
            # every seat (decode, source-local, survivors) failed
            # before any output reached the client: re-dispatch from
            # scratch. The already-burned prefill is re-prefill waste,
            # charged to the migration ledger at the prompt's token
            # count (same byte-tokenizer estimate as the retry path).
            burned_tokens = len(request.prompt.encode("utf-8")) + 1
            wasted = obs_energy.charge_wasted(
                "migration", tokens=burned_tokens
            )
            yield from self._dispatch_stream_plain(
                request,
                tried=(),
                retried="migrate_failed",
                migrate_j=wasted,
            )

    def _relay_migrated(
        self,
        bundle: dict,
        request: GenerationRequest,
        reason: str,
        src: Optional[Replica] = None,
        target: Optional[Replica] = None,
        fallback: Optional[Replica] = None,
        exclude: "tuple" = (),
        retried: Optional[str] = None,
        wasted_j: float = 0.0,
        migrate_j: float = 0.0,
    ) -> Iterator[GenerationChunk]:
        """Seat ``bundle`` on ``target`` (or the best survivor) and
        relay the seated row's chunks. Each transfer moves the
        ``llm_migrate_rows_total{reason=}`` counter and charges the
        wasted-energy ledger (``cause="migration"``, 2× payload bytes
        at SWAP_J_PER_BYTE — once out, once in), and a trace-linked
        ``row_migrated`` flight event carries BOTH replica ids. A seat
        that dies before relaying any output counts
        ``llm_router_retries_total{reason=migrate_failed}`` and falls
        back — source-local decode first (the bundle seats right back
        where it came from), then any survivor; exhaustion raises
        :class:`MigrateDispatchFailed`. A relayed row whose seat is
        itself drained mid-stream re-seats onward (chained
        evacuation)."""
        excluded = set(exclude)
        src_name = (
            src.name if src is not None else str(bundle.get("src") or "")
        )
        if target is None:
            target = self._pick_migrate_target(exclude=tuple(excluded))
            if target is None:
                target = fallback
        while True:
            if target is None:
                raise MigrateDispatchFailed(
                    f"no replica can seat the migrated row ({reason})"
                )
            seat = target
            nbytes = bundle_nbytes(bundle)
            bundle = {**bundle, "src": src_name, "dst": seat.name}
            MIGRATE_ROWS_C.labels(reason=reason).inc()
            migrate_j += obs_energy.charge_wasted(
                "migration", nbytes=2.0 * nbytes
            )
            if obs_metrics.enabled():
                FLIGHT.emit(
                    EV_ROW_MIGRATED,
                    direction="transfer",
                    reason=reason,
                    src=src_name,
                    dst=seat.name,
                    nbytes=nbytes,
                    **trace_attrs(TRACER.current()),
                )
            self._begin(seat, retried)
            chunks: Optional[Iterator[GenerationChunk]] = None
            relayed = False
            reseat: Optional[dict] = None
            failed: Optional[BaseException] = None
            try:
                try:
                    chunks = seat.migrate(bundle)
                    for chunk in chunks:
                        if chunk.done and chunk.result is not None:
                            extras = chunk.result.extras or {}
                            next_bundle = extras.get("migrate")
                            if next_bundle is not None and extras.get(
                                "evacuated"
                            ):
                                reseat = dict(next_bundle)
                                break
                            self._stamp(
                                chunk.result, seat, retried,
                                wasted_j=wasted_j, migrate_j=migrate_j,
                                trace=request.trace,
                            )
                        yield chunk
                        if chunk.tokens or chunk.text:
                            relayed = True
                except BaseException as exc:  # noqa: BLE001
                    if relayed or _retry_reason(exc) is None:
                        raise
                    failed = exc
            finally:
                self._end(seat)
                if chunks is not None:
                    close = getattr(chunks, "close", None)
                    if close is not None:
                        close()
            if failed is not None:
                # receiver died before any output: the bundle is still
                # the only live copy of the row — never drop it
                _RETRIES_C.labels(reason="migrate_failed").inc()
                if _retry_reason(failed) == "dead":
                    self._set_health(
                        seat, False, f"{type(failed).__name__}: {failed}"
                    )
                excluded.add(seat.name)
                if (
                    fallback is not None
                    and fallback.name not in excluded
                    and fallback.healthy
                ):
                    target = fallback
                else:
                    target = self._pick_migrate_target(
                        exclude=tuple(excluded)
                    )
                    if target is None:
                        raise MigrateDispatchFailed(
                            f"{type(failed).__name__}: {failed}"
                        ) from failed
                continue
            if reseat is not None:
                # the seat itself was drained mid-stream: chain the row
                # onward; the (now-draining but live) seat stays the
                # fallback of last resort
                src_name = seat.name
                bundle = reseat
                excluded = {seat.name}
                fallback = seat
                target = self._pick_migrate_target(exclude=(seat.name,))
                if target is None:
                    target = seat
                continue
            return

    # -- introspection ---------------------------------------------------------
    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.healthy)

    def health_state(self) -> Dict[str, object]:
        with self._lock:
            replicas = list(self._replicas.values())
        healthy = sum(1 for r in replicas if r.healthy)
        roles: Dict[str, int] = {}
        for r in replicas:
            if r.healthy and not r.draining:
                roles[r.role] = roles.get(r.role, 0) + 1
        return {
            "status": "ok" if healthy else "degraded",
            "role": "router",
            "policy": self.policy,
            "replicas": len(replicas),
            "healthy_replicas": healthy,
            "draining_replicas": sum(1 for r in replicas if r.draining),
            # healthy dispatchable members by fleet role;
            # the disagg pipeline engages when prefill and decode are
            # both non-zero here
            "replica_roles": roles,
        }

    def debug_state(self) -> Dict[str, object]:
        return {
            "role": "router",
            "policy": self.policy,
            "probe_interval_s": self.probe_interval_s,
            "replicas": [r.debug_state() for r in self.replicas()],
        }

    def ps_state(self) -> Dict[str, object]:
        """The fleet's merged loaded-models view (``GET /api/ps`` on the
        front door): every model any replica holds warm, with
        the replicas holding it — the data behind the placement-aware
        dispatch, federated the way /metrics federates the gauges.
        Reads the PROBE-fed sets (refreshed every probe tick); a
        replica that never reported one simply contributes nothing."""
        by_model: Dict[str, List[str]] = {}
        per_replica: Dict[str, List[str]] = {}
        for replica in self.replicas():
            loaded = (replica.last_stats or {}).get("loaded_models")
            if loaded is None:
                continue
            names = [str(m) for m in loaded]
            per_replica[replica.name] = names
            for m in names:
                by_model.setdefault(m, []).append(replica.name)
        return {
            "models": [
                {"name": m, "x_replicas": sorted(by_model[m])}
                for m in sorted(by_model)
            ],
            "x_replicas": per_replica,
        }

    def tenants_state(self) -> Dict[str, object]:
        """The fleet's merged per-tenant usage (``GET /debug/tenants``
        on the front door): each REMOTE replica's own
        ``/debug/tenants`` pull, this process's tenant table exactly
        once as ``local`` when any in-process replica is attached
        (they all share it), and a summed ``fleet`` rollup per tenant —
        the JSON twin of the ``llm_fleet_tenant_*`` scrape families."""
        per_replica: Dict[str, object] = {}
        saw_local = False
        for replica in self.replicas():
            if replica.kind == "local":
                saw_local = True
                continue
            try:
                snap = replica.tenants_state()
            except Exception as exc:  # noqa: BLE001 — down/no-telemetry
                per_replica[replica.name] = {
                    "error": f"{type(exc).__name__}: {exc}"
                }
                continue
            if snap is not None:
                per_replica[replica.name] = snap
        if saw_local:
            per_replica["local"] = obs_tenants.snapshot()
        fleet: Dict[str, Dict[str, object]] = {}
        for snap in per_replica.values():
            if not isinstance(snap, dict):
                continue
            for tenant, acct in (snap.get("tenants") or {}).items():
                agg = fleet.setdefault(
                    tenant,
                    {
                        "requests": {},
                        "tokens_in": 0,
                        "tokens_out": 0,
                        "joules": 0.0,
                        "wasted_J": {},
                    },
                )
                for outcome, n in (acct.get("requests") or {}).items():
                    agg["requests"][outcome] = agg["requests"].get(
                        outcome, 0
                    ) + int(n)
                agg["tokens_in"] += int(acct.get("tokens_in") or 0)
                agg["tokens_out"] += int(acct.get("tokens_out") or 0)
                agg["joules"] = round(
                    agg["joules"] + float(acct.get("joules") or 0.0), 6
                )
                for cause, j in (acct.get("wasted_J") or {}).items():
                    agg["wasted_J"][cause] = round(
                        agg["wasted_J"].get(cause, 0.0) + float(j), 6
                    )
        return {
            "role": "router",
            "fleet": fleet,
            "replicas": per_replica,
        }

    # -- metrics federation -----------------------------------------
    def federation_sources(self) -> List[Tuple[str, str]]:
        """The per-replica scrape texts the fleet rollup merges: one
        live ``GET /metrics`` per REMOTE replica (falling back to the
        last successful scrape when one fails mid-request), plus — when
        any in-process replica is attached — THIS process's registry
        exactly once as the ``local`` source (in-process replicas share
        it; scraping it per replica would multiply-count)."""
        sources: List[Tuple[str, str]] = []
        saw_local = False
        for replica in self.replicas():
            try:
                text = replica.scrape_metrics()
            except Exception:  # noqa: BLE001 — down replica
                text = replica.last_metrics_text
            if text is not None:
                sources.append((replica.name, text))
            elif replica.kind == "local":
                saw_local = True
        if saw_local:
            sources.append(("local", REGISTRY.exposition()))
        return sources

    def fleet_exposition(self) -> str:
        """The ``llm_fleet_*`` rollup text: counters summed, fixed-bucket
        histograms merged bucket-wise, gauges re-labelled
        ``{replica=...}`` — byte-identical to calling
        :func:`~..obs.metrics.merge_expositions` on the same scrapes
        (the golden federation test pins that). One front-door scrape
        therefore answers fleet TTFT p99, aggregate goodput and fleet
        J/token."""
        return merge_expositions(self.federation_sources())

    # -- cross-process timeline -------------------------------------
    def timeline(self, trace: str) -> Dict[str, object]:
        """One request's full cross-process lifecycle, reassembled from
        flight recorders: the router's own ring (dispatched / retry /
        replica_down events — and, for in-process replicas, the whole
        scheduler story, which shares this ring) interleaved with each
        involved REMOTE replica's ``/debug/flight?trace=`` pull.

        Clocks are process-local (time.monotonic), so cross-process
        ordering is by HOP: a remote hop's events splice in directly
        after the ``dispatched`` event that started it, seq-ordered
        within the hop and tagged ``hop=<replica>`` for attribution.
        Events seen in more than one pull (in-process twins sharing a
        ring) dedupe by (type, seq, t_s)."""
        own = FLIGHT.events(trace=trace)
        dispatches = [e for e in own if e.get("type") == EV_DISPATCHED]
        remote_names = {
            str(e.get("replica"))
            for e in dispatches
            if e.get("replica") is not None
        }
        with self._lock:
            remotes = {
                name: r
                for name, r in self._replicas.items()
                if name in remote_names and r.kind != "local"
            }
        hops: List[Dict[str, object]] = []
        pulled: Dict[str, List[Dict[str, object]]] = {}
        for name, replica in remotes.items():
            hop: Dict[str, object] = {"replica": name}
            try:
                pulled[name] = replica.flight_events(trace)
                hop["events"] = len(pulled[name])
            except Exception as exc:  # noqa: BLE001 — dead hop: degrade
                hop["error"] = f"{type(exc).__name__}: {exc}"
                pulled[name] = []
            hops.append(hop)
        def _key(event: Dict[str, object]):
            return (event.get("type"), event.get("seq"), event.get("t_s"))

        # Pass 1: the router's OWN ring in seq order — its dispatch
        # story plus, for in-process fleets (which share this process's
        # recorder), the replica-side scheduler events already in
        # chronological order. Pass 2 then splices each REMOTE hop's
        # unseen events directly after the dispatched event that
        # started it (reverse order keeps earlier insert points valid);
        # events present in both pulls (shared-ring twins) dedupe by
        # (type, seq, t_s) and keep their pass-1 position.
        router_types = (EV_DISPATCHED, EV_REPLICA_DOWN, EV_REPLICA_DRAINED)
        events: List[Dict[str, object]] = [
            {
                **event,
                "hop": (
                    "router"
                    if event.get("type") in router_types
                    else "local"
                ),
            }
            for event in own
        ]
        seen = {_key(e) for e in events}
        dispatch_points = [
            (i, str(e.get("replica")))
            for i, e in enumerate(events)
            if e.get("type") == EV_DISPATCHED
        ]
        for i, replica_name in reversed(dispatch_points):
            fresh = [
                {**e, "hop": replica_name}
                for e in pulled.get(replica_name, [])
                if _key(e) not in seen
            ]
            seen.update(_key(e) for e in fresh)
            events[i + 1 : i + 1] = fresh
        return {
            "trace": trace,
            "attempts": len(dispatches),
            "dispatches": dispatches,
            "hops": [{"replica": "router", "events": len(own)}] + hops,
            "events": events,
        }


class RouterServer:
    """The front-door HTTP server: the wire surface of
    :class:`~.server.GenerationServer` (generate, SSE streaming,
    healthz, metrics, debug endpoints) served by dispatching every
    ticket through a :class:`Router`. ``port=0`` picks an ephemeral
    port (tests); ``start()``/``serve_forever()``/``stop()`` mirror the
    single-backend server."""

    def __init__(
        self,
        router: Router,
        host: str = "0.0.0.0",
        port: int = protocol.DEFAULT_PORT,
        models: Optional[List[str]] = None,
        quiet: bool = False,
        default_priority: Optional[int] = None,
        slo: Optional[str] = None,  # SLO objectives ('ttft_p99_ms<=250,...')
        slo_pairs=None,  # burn-rate window pairs override (tests/smoke)
        ts_interval_s: Optional[float] = None,  # time-series ring cadence
        ts_capacity: Optional[int] = None,  # time-series ring depth
    ) -> None:
        self.router = router
        self.models = list(models) if models else []
        self.quiet = quiet
        self.default_priority = (
            int(default_priority)
            if default_priority is not None
            else protocol.DEFAULT_PRIORITY
        )
        # Windowed fleet telemetry + SLOs: ONE sampler tick
        # scrapes the federation sources, feeds each replica's text
        # into its own per-replica ring AND the merged llm_fleet_*
        # rollup (plus this process's own llm_router_* families) into
        # the fleet ring — every ring stamped with the SAME tick clock,
        # so fleet attainment is exactly recomputable from the
        # per-replica rollups. The SLO engine evaluates against the
        # fleet ring (the llm_fleet_ spelling wins there).
        interval = (
            float(ts_interval_s)
            if ts_interval_s is not None
            else obs_ts.DEFAULT_INTERVAL_S
        )
        capacity = (
            int(ts_capacity)
            if ts_capacity is not None
            else obs_ts.DEFAULT_CAPACITY
        )
        self.ts_ring = obs_ts.TimeSeriesRing(
            capacity=capacity, interval_s=interval
        )
        self._replica_rings: Dict[str, obs_ts.TimeSeriesRing] = {}
        self._rings_lock = threading.Lock()
        objectives = obs_slo.parse_slo_spec(slo) if slo else []
        self.slo_engine = (
            obs_slo.SLOEngine(
                objectives,
                self.ts_ring,
                pairs=slo_pairs or obs_slo.DEFAULT_BURN_PAIRS,
                name="router",
            )
            if objectives
            else None
        )
        self._sampler = obs_ts.SamplerThread(
            self._telemetry_tick,
            interval_s=interval,
            name="router-ts-sampler",
        )
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None
        self._serving = threading.Event()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def replica_rings(self) -> Dict[str, obs_ts.TimeSeriesRing]:
        """Per-replica time-series rings keyed by federation source
        name (``local`` covers every in-process replica — they share
        one registry, so they share one ring)."""
        with self._rings_lock:
            return dict(self._replica_rings)

    def _telemetry_tick(self) -> None:
        """One sampler-cadence tick (see ``__init__``): per-replica
        scrapes → per-replica rings; fleet merge + own registry → the
        fleet ring; then SLO evaluation. Every ingest is stamped with
        one shared ``now`` so per-replica and fleet windows align."""
        if not obs_metrics.enabled():
            return
        try:
            sources = self.router.federation_sources()
        except Exception:  # noqa: BLE001 — telemetry must not kill serving
            return
        now = self.ts_ring.clock()
        for name, text in sources:
            with self._rings_lock:
                ring = self._replica_rings.get(name)
                if ring is None:
                    ring = obs_ts.TimeSeriesRing(
                        capacity=self.ts_ring.capacity,
                        interval_s=self.ts_ring.interval_s,
                        clock=self.ts_ring.clock,
                    )
                    self._replica_rings[name] = ring
            ring.ingest_text(text, now=now)
        families = obs_ts.registry_families()
        try:
            merged = merge_expositions(sources)
            families.update(
                obs_ts.families_from_parsed(parse_exposition(merged))
            )
        except Exception:  # noqa: BLE001 — rollup is additive
            pass
        self.ts_ring.ingest(families, now=now)
        if self.slo_engine is not None:
            self.slo_engine.evaluate(now=now)

    @staticmethod
    def _with_parent(request: GenerationRequest, root) -> GenerationRequest:
        """Stamp the router root span as the trace's cross-process
        parent before dispatch, so a replica's span tree links back to
        THIS hop (no-op when tracing is off — root is None)."""
        if root is None or request.trace is None:
            return request
        return dataclasses.replace(
            request,
            trace=TraceContext(
                trace_id=request.trace.trace_id,
                parent=str(root.span_id),
            ),
        )

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def _send_json(self, status: int, payload) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path == protocol.HEALTH_PATH:
                    self._send_json(200, server.router.health_state())
                elif path == protocol.METRICS_PATH:
                    if not obs_metrics.enabled():
                        self._send_json(
                            404,
                            {"error": "telemetry disabled (TPU_LLM_OBS=0)"},
                        )
                        return
                    # the router's own families PLUS the llm_fleet_*
                    # federation rollup: one scrape answers
                    # fleet TTFT p99 / aggregate goodput / fleet J/token
                    text = REGISTRY.exposition()
                    try:
                        text += server.router.fleet_exposition()
                    except Exception:  # noqa: BLE001 — rollup is additive
                        pass
                    body = text.encode("utf-8")
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == protocol.DEBUG_STATE_PATH:
                    if not obs_metrics.enabled():
                        self._send_json(
                            404,
                            {"error": "telemetry disabled (TPU_LLM_OBS=0)"},
                        )
                        return
                    state = {
                        "t_s": round(time.monotonic(), 6),
                        "flight": FLIGHT.summary(),
                        **server.router.debug_state(),
                    }
                    # SLO attainment: fleet-level snapshot
                    # plus per-replica attainment from the per-replica
                    # rings — the signal a future autoscaler's
                    # drain()/add_replica() policy consumes
                    if server.slo_engine is not None:
                        try:
                            state["slo"] = server.slo_engine.snapshot()
                            by_replica = (
                                server.slo_engine.attainment_by_replica(
                                    server.replica_rings()
                                )
                            )
                            state["slo_attainment_by_replica"] = by_replica
                            for entry in state.get("replicas", []):
                                name = entry.get("name")
                                key = (
                                    name
                                    if name in by_replica
                                    else (
                                        "local"
                                        if entry.get("kind") == "local"
                                        else None
                                    )
                                )
                                if key is not None:
                                    entry["slo_attainment"] = by_replica[
                                        key
                                    ]
                        except Exception:  # noqa: BLE001 — probe only
                            pass
                    self._send_json(200, state)
                elif path == protocol.DEBUG_TIMESERIES_PATH:
                    if not obs_metrics.enabled():
                        self._send_json(
                            404,
                            {"error": "telemetry disabled (TPU_LLM_OBS=0)"},
                        )
                        return
                    from urllib.parse import parse_qs

                    query = parse_qs(self.path.partition("?")[2])
                    family = query.get("family", [None])[0]
                    replica = query.get("replica", [None])[0]
                    try:
                        window_s = float(query.get("window", ["60"])[0])
                        step_raw = query.get("step", [None])[0]
                        step_s = float(step_raw) if step_raw else None
                    except ValueError:
                        self._send_json(
                            400, {"error": "window/step must be numbers"}
                        )
                        return
                    ring = server.ts_ring
                    if replica is not None:
                        ring = server.replica_rings().get(replica)
                        if ring is None:
                            self._send_json(
                                404,
                                {
                                    "error": (
                                        f"no ring for replica {replica!r}"
                                    )
                                },
                            )
                            return
                    payload = ring.debug_payload(
                        family=family, window_s=window_s, step_s=step_s
                    )
                    payload["ring_scope"] = replica or "fleet"
                    if server.slo_engine is not None:
                        payload["slo"] = server.slo_engine.snapshot()
                    self._send_json(200, payload)
                elif path == protocol.DEBUG_FLIGHT_PATH:
                    if not obs_metrics.enabled():
                        self._send_json(
                            404,
                            {"error": "telemetry disabled (TPU_LLM_OBS=0)"},
                        )
                        return
                    from urllib.parse import parse_qs

                    query = parse_qs(self.path.partition("?")[2])
                    try:
                        n = int(query.get("n", ["200"])[0])
                    except ValueError:
                        self._send_json(
                            400, {"error": "n must be an integer"}
                        )
                        return
                    self._send_json(
                        200,
                        {
                            "summary": FLIGHT.summary(),
                            "events": FLIGHT.events(
                                n=n,
                                type_=query.get("type", [None])[0],
                                trace=query.get("trace", [None])[0],
                            ),
                        },
                    )
                elif path == protocol.DEBUG_TIMELINE_PATH:
                    if not obs_metrics.enabled():
                        self._send_json(
                            404,
                            {"error": "telemetry disabled (TPU_LLM_OBS=0)"},
                        )
                        return
                    from urllib.parse import parse_qs

                    query = parse_qs(self.path.partition("?")[2])
                    trace = query.get("trace", [None])[0]
                    if not trace:
                        self._send_json(
                            400,
                            {"error": "timeline requires ?trace=<trace id>"},
                        )
                        return
                    try:
                        self._send_json(
                            200, server.router.timeline(trace)
                        )
                    except Exception as exc:  # noqa: BLE001
                        self._send_json(
                            500,
                            {"error": f"{type(exc).__name__}: {exc}"},
                        )
                elif path == protocol.DEBUG_TENANTS_PATH:
                    if not obs_metrics.enabled():
                        self._send_json(
                            404,
                            {"error": "telemetry disabled (TPU_LLM_OBS=0)"},
                        )
                        return
                    try:
                        self._send_json(200, server.router.tenants_state())
                    except Exception as exc:  # noqa: BLE001
                        self._send_json(
                            500,
                            {"error": f"{type(exc).__name__}: {exc}"},
                        )
                elif path == protocol.TAGS_PATH:
                    self._send_json(
                        200,
                        {"models": [{"name": m} for m in server.models]},
                    )
                elif path == protocol.PS_PATH:
                    # merged per-replica loaded-models view:
                    # the single server answers /api/ps from its own
                    # backend; the front door federates every replica's
                    # probe-fed set, so one call shows WHERE each
                    # model's weights are warm
                    self._send_json(200, server.router.ps_state())
                elif path == protocol.VERSION_PATH:
                    self._send_json(
                        200, {"version": protocol.SERVER_VERSION}
                    )
                else:
                    self._send_json(
                        404, {"error": f"unknown path {self.path}"}
                    )

            def do_POST(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                if path == protocol.ADMIN_DRAIN_PATH:
                    self._handle_admin_drain()
                    return
                if path == protocol.ADMIN_ADD_REPLICA_PATH:
                    self._handle_admin_add_replica()
                    return
                if path != protocol.GENERATE_PATH:
                    self._send_json(
                        404, {"error": f"unknown path {self.path}"}
                    )
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(
                        (self.rfile.read(length) if length else b"{}").decode(
                            "utf-8"
                        )
                    )
                except (ValueError, json.JSONDecodeError) as exc:
                    self._send_json(400, {"error": f"bad JSON: {exc}"})
                    return
                try:
                    request = protocol.request_from_wire(
                        body, default_priority=server.default_priority
                    )
                except ValueError as exc:
                    self._send_json(400, {"error": str(exc)})
                    return
                if server.models and request.model not in server.models:
                    self._send_json(
                        404, {"error": f"model {request.model!r} not found"}
                    )
                    return
                # The FRONT DOOR mints the fleet-wide trace (or adopts a
                # caller-minted one), and every dispatch attempt forwards
                # it with the router root span as the cross-process
                # parent — both attempts of a retried ticket therefore
                # share ONE trace id, on distinct span branches.
                request = protocol.ensure_trace(request)
                if body.get("stream"):
                    with TRACER.span(
                        "request",
                        trace_id=request.trace.trace_id,
                        model=request.model,
                        stream=True,
                    ) as root:
                        self._stream(server._with_parent(request, root))
                    return
                try:
                    with TRACER.span(
                        "request",
                        trace_id=request.trace.trace_id,
                        model=request.model,
                    ) as root:
                        result = server.router.dispatch(
                            server._with_parent(request, root)
                        )
                except BaseException as exc:  # noqa: BLE001
                    self._send_error(exc)
                else:
                    self._send_json(200, protocol.result_to_wire(result))

            def _handle_admin_drain(self) -> None:
                """``POST /admin/drain?replica=<name>[&migrate=1]
                [&timeout=<s>]``: the HTTP caller for
                elastic scale-down. ``migrate=1`` evacuates in-flight
                rows to survivors (live migration) before the idle
                wait; default waits them out. The result — drained or
                still-draining, and how many rows were evacuated —
                rides the response body."""
                from urllib.parse import parse_qs

                query = parse_qs(self.path.partition("?")[2])
                name = query.get("replica", [None])[0]
                if not name:
                    self._send_json(
                        400, {"error": "drain requires ?replica=<name>"}
                    )
                    return
                migrate = str(
                    query.get("migrate", ["0"])[0]
                ).lower() in ("1", "true", "yes")
                try:
                    timeout_s = float(query.get("timeout", ["30"])[0])
                except ValueError:
                    self._send_json(
                        400, {"error": "timeout must be a number"}
                    )
                    return
                evacuated = 0
                try:
                    if migrate:
                        evacuated = server.router.evacuate_replica(
                            name, timeout_s=timeout_s
                        )
                    drained = server.router.drain(
                        name, timeout_s=timeout_s
                    )
                except KeyError:
                    self._send_json(
                        404, {"error": f"no replica named {name!r}"}
                    )
                    return
                except Exception as exc:  # noqa: BLE001
                    self._send_json(
                        500, {"error": f"{type(exc).__name__}: {exc}"}
                    )
                    return
                self._send_json(
                    200,
                    {
                        "replica": name,
                        "drained": drained,
                        "migrate": migrate,
                        "evacuated": evacuated,
                    },
                )

            def _handle_admin_add_replica(self) -> None:
                """``POST /admin/add_replica?target=<base_url>[&name=]``
               : elastic scale-up over HTTP — attach a
                RemoteReplica at ``target`` (its role self-reports via
                /healthz on the immediate first probe)."""
                from urllib.parse import parse_qs, urlparse

                query = parse_qs(self.path.partition("?")[2])
                target = query.get("target", [None])[0]
                if not target:
                    self._send_json(
                        400,
                        {"error": "add_replica requires ?target=<base_url>"},
                    )
                    return
                if not str(target).startswith("http"):
                    target = f"http://{target}"
                name = query.get("name", [None])[0] or (
                    urlparse(target).netloc or str(target)
                )
                replica = RemoteReplica(str(name), str(target))
                try:
                    server.router.add_replica(replica)
                except ValueError as exc:  # duplicate name
                    self._send_json(409, {"error": str(exc)})
                    return
                self._send_json(
                    200,
                    {
                        "added": replica.name,
                        "base_url": replica.base_url,
                        "healthy": replica.healthy,
                        "role": replica.role,
                    },
                )

            def _send_error(self, exc: BaseException) -> None:
                if isinstance(exc, RemoteServerError):
                    # forward the replica's own status (404 unknown
                    # model, 400 bad request, 504 deadline, ...)
                    self._send_json(exc.status, {"error": str(exc)})
                elif isinstance(exc, DeadlineExceeded):
                    self._send_json(504, {"error": str(exc)})
                elif isinstance(exc, KeyError):
                    self._send_json(
                        404, {"error": f"model not found: {exc}"}
                    )
                elif isinstance(exc, ValueError):
                    self._send_json(400, {"error": str(exc)})
                elif isinstance(exc, RuntimeError) and "no healthy replica" in str(
                    exc
                ):
                    self._send_json(503, {"error": str(exc)})
                else:
                    self._send_json(
                        500, {"error": f"{type(exc).__name__}: {exc}"}
                    )

            # -- SSE re-framing (same bytes as the single-backend server) ------
            def _write_sse_chunk(self, payload) -> None:
                data = protocol.sse_event(payload)
                self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            def _start_sse(self) -> None:
                from .server import STREAM_WRITE_TIMEOUT_S

                self.send_response(200)
                self.send_header(
                    "Content-Type", protocol.STREAM_CONTENT_TYPE
                )
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                # same stalled-consumer bound as the single-backend
                # server: one dead front-door socket must not wedge a
                # handler (and through it a replica row) forever
                self.connection.settimeout(STREAM_WRITE_TIMEOUT_S)

            def _end_sse(self) -> None:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    self.close_connection = True

            def _final_record(self, result) -> dict:
                final = protocol.result_to_wire(result)
                final["response"] = ""
                final["x_text"] = result.text
                return final

            def _stream(self, request) -> None:
                """SSE delivery through the router: replica chunks are
                re-framed one-for-one; a dead front-door socket closes
                the chunk iterator, which cancels the replica-side row
                (local channel cancel / remote connection close). A
                pre-first-chunk failure surfaces as a clean HTTP status
                (the retry-once already happened inside
                dispatch_stream); a later one as a terminal SSE error
                event."""
                chunks = server.router.dispatch_stream(request)
                started = False
                try:
                    try:
                        for chunk in chunks:
                            if not started:
                                self._start_sse()
                                started = True
                            if chunk.done:
                                self._write_sse_chunk(
                                    self._final_record(chunk.result)
                                )
                            else:
                                self._write_sse_chunk(
                                    protocol.stream_chunk_to_wire(
                                        request.model,
                                        chunk.text,
                                        chunk.tokens,
                                    )
                                )
                    except OSError:
                        # front-door client hung up: closing the chunk
                        # iterator (finally) cancels the replica row
                        self.close_connection = True
                        return
                    except BaseException as exc:  # noqa: BLE001
                        if not started:
                            self._send_error(exc)
                            return
                        try:
                            self._write_sse_chunk(
                                {
                                    "error": (
                                        f"{type(exc).__name__}: {exc}"
                                    ),
                                    "done": True,
                                }
                            )
                        except OSError:
                            self.close_connection = True
                            return
                finally:
                    close = getattr(chunks, "close", None)
                    if close is not None:
                        close()
                if started:
                    self._end_sse()

        return Handler

    def start(self) -> None:
        self.router.start()
        self._sampler.start()  # refuses under the telemetry kill switch
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="router-server",
            daemon=True,
        )
        self._thread.start()
        self._serving.set()

    def serve_forever(self) -> None:
        if not self.quiet:
            term.log_ok(
                f"router listening on :{self.port} "
                f"({len(self.router.replicas())} replicas, "
                f"policy {self.router.policy})"
            )
        self.router.start()
        self._sampler.start()  # refuses under the telemetry kill switch
        self._serving.set()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._serving.clear()
            self._sampler.stop()
            self._httpd.server_close()
            self.router.stop()

    def stop(self) -> None:
        self._sampler.stop()
        self.router.stop()
        if self._serving.is_set():
            self._httpd.shutdown()
            self._serving.clear()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
