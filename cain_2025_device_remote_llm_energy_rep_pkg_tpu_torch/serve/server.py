"""Threaded HTTP generation server.

The framework-native replacement for the external Ollama server the
reference depends on (README.md:29-31): the same REST surface
(``POST /api/generate``, ``GET /api/tags``) served from any
:class:`~..engine.backend.GenerationBackend`. Generation requests are
serialised through a lock — one accelerator, one in-flight generation, which
also matches the measurement model (the client's wait *is* the treatment).

Stdlib-only (``http.server``); no web framework in the image and none
needed: the reference's entire protocol is one JSON POST.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs

from ..engine.backend import GenerationBackend
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import tenants as obs_tenants
from ..obs import timeseries as obs_ts
from ..obs.flight import FLIGHT
from ..obs.trace import TRACER
from ..runner import term
from . import protocol
from .stream import DeadlineExceeded, StreamCancelled

# What the path left for later answers: the multi-model fleet refuses at
# construction.
FLEET_NOT_PORTED = (
    "the multi-model fleet (model_policy, serve/model_fleet.py) is not "
    "ported yet (ROADMAP item 15)"
)

# HTTP-surface telemetry (obs): request counts by (method, path, status)
# and a latency histogram by path. Paths are the fixed API surface
# (query strings stripped), so label cardinality stays bounded.
_HTTP_REQUESTS_C = obs_metrics.REGISTRY.counter(
    "llm_http_requests_total",
    "HTTP requests served, by method/path/status",
    labels=("method", "path", "status"),
)
_HTTP_SECONDS_H = obs_metrics.REGISTRY.histogram(
    "llm_http_request_seconds",
    "Wall time of one HTTP request, by path",
    labels=("path",),
)

# Bound on any single streamed-chunk socket write; a consumer slower than
# this (or one that stopped reading) gets disconnected rather than holding
# the generation lock indefinitely.
STREAM_WRITE_TIMEOUT_S = 60.0

# SSE keep-alive cadence: after this much producer silence the handler
# writes a ``: keep-alive`` comment (protocol.SSE_KEEPALIVE) so clients
# and proxies with idle timeouts survive a long chunked join-prefill —
# a joiner's first delta can be many decode slices away while its
# prompt streams in one chunk at a time (follow-on).
STREAM_KEEPALIVE_S = float(os.environ.get("STREAM_KEEPALIVE_S", 5.0))


class GenerationServer:
    """Serve a backend over HTTP. ``port=0`` picks an ephemeral port (tests).

    Usage::

        server = GenerationServer(backend, port=11434)
        server.start()          # returns once the socket is listening
        ...
        server.stop()

    or blocking: ``server.serve_forever()``.
    """

    def __init__(
        self,
        backend: GenerationBackend,
        host: str = "0.0.0.0",
        port: int = protocol.DEFAULT_PORT,
        models: Optional[List[str]] = None,
        quiet: bool = False,
        batch_window_ms: float = 0.0,
        max_batch: Optional[int] = None,  # backend-aware (scheduler)
        budget_aware: Optional[bool] = None,  # KV-budget admission
        access_log: bool = False,  # structured per-request log line
        scheduler: Optional[str] = None,  # None(auto)|window|continuous
        slice_steps: Optional[int] = None,  # continuous: decode-slice width
        prefill_chunk_tokens: Optional[int] = None,  # continuous: join chunk
        ttft_slo_ms: Optional[float] = None,  # queued-past-SLO rejection
        spec_accept_floor: Optional[float] = None,  # speculative fallback
        default_priority: Optional[int] = None,  # tier for bare requests
        preempt_policy: Optional[str] = None,  # off|swap|recompute
        preempt_max_wait_s: Optional[float] = None,  # victim aging clock
        model_policy: Optional[str] = None,  # fleet: small-first|cheapest-joules
        slo: Optional[str] = None,  # SLO objectives ('ttft_p99_ms<=250,...')
        slo_pairs=None,  # burn-rate window pairs override (tests/smoke)
        ts_interval_s: Optional[float] = None,  # time-series ring cadence
        ts_capacity: Optional[int] = None,  # time-series ring depth
        role: Optional[str] = None,  # disagg fleet role
        usage_ledger_dir: Optional[str] = None,  # tenant ledger
    ) -> None:
        """``batch_window_ms > 0`` or an explicit ``scheduler`` enables
        batching: concurrent non-streaming generate requests coalesce
        into shared decodes (:mod:`.scheduler`). Neither (default)
        preserves strictly serial one-at-a-time semantics — what the
        reference's measurement model assumes.

        ``scheduler`` picks the dispatch model: ``"window"`` (classic
        admission-window batches run to completion), ``"continuous"``
        (iteration-level admit/step/retire over the backend's
        stepped-decode protocol), or ``None`` — auto, which DEFAULTS TO
        CONTINUOUS for real batched backends (those overriding
        ``generate_batch`` AND speaking ``decode_open``, i.e. the
        engine) and window otherwise (fake backend). With batching on
        and no ``batch_window_ms``, the window defaults to 50 ms.

        ``budget_aware`` (default: auto — on for backends exposing
        ``max_admission_rows``) lets the scheduler raise each batch's
        cap to the widest fleet the backend's KV budget admits under its
        cache layout, so paged/int8-KV serving actually admits the
        larger fleet its denser cache pays for. ``access_log`` (default
        off — measurement runs stay quiet) emits one structured line per
        request: method, path, status, duration ms. Telemetry
        (``/metrics``, spans) is default-on with the obs kill switch
        (``TPU_LLM_OBS=0`` / ``--no-telemetry``).

        Continuous-only tuning (ignored under window dispatch):
        ``slice_steps`` is the bounded decode-slice width (default: the
        engine's DECODE_SLICE_STEPS, env ``DECODE_SLICE_STEPS``) and
        ``prefill_chunk_tokens`` the token budget of ONE chunk of a
        mid-flight joiner's prefill (default: the engine's auto, env
        ``PREFILL_CHUNK_TOKENS``) — together they bound how long
        in-flight rows stall per scheduler iteration.

        ``spec_accept_floor`` (CLI ``--spec-accept-floor``) tunes the
        continuous scheduler's speculative sessions: a session whose
        rolling measured draft-acceptance drops below the floor falls
        back to plain decode mid-flight (llm_spec_fallback_total).
        None = the backend engine's own default (never fall back unless
        the engine was built with a floor).

        ``ttft_slo_ms`` (CLI ``--ttft-slo-ms``) is the server-wide TTFT
        SLO: a queued request whose wait alone already exceeds it is
        rejected (HTTP 504) before admission instead of being served
        late — load shedding at the cheapest possible point. Requests
        can additionally carry their own ``x_deadline_ms``, enforced
        both pre-admission and mid-flight (the row retires,
        ``reason="deadline"``).

        SLO tiers + preemption: ``default_priority`` is the
        tier stamped on requests that do not send ``x_priority`` (CLI
        ``--default-priority``, default "normal"); the scheduler queue
        is per-tier FIFO. ``preempt_policy`` (continuous only; CLI
        ``--preempt-policy``, default "swap") lets the scheduler
        preempt a strictly-lower-tier in-flight row — KV swapped to
        host memory, or with "recompute" dropped and re-prefilled at
        resume (a contiguous session's; a paged one swaps only);
        "off" restores shed-at-the-edge-only overload handling.
        ``preempt_max_wait_s`` (CLI ``--preempt-max-wait-s``) is the
        starvation clock: a parked victim ages up one tier per full
        wait.

        ``model_policy`` (the multi-model fleet) is not ported: it
        raises ``NotImplementedError``.

        Windowed telemetry + SLOs: the server always owns a
        :class:`~..obs.timeseries.TimeSeriesRing`; a background sampler
        (started only while telemetry is ON) snapshots the ``llm_*``
        registry families every ``ts_interval_s`` (default 1 s, env
        ``TPU_LLM_TS_INTERVAL_S``) into ``ts_capacity`` slots (env
        ``TPU_LLM_TS_CAPACITY``) and serves windowed rollups on
        ``GET /debug/timeseries?family=&window=&step=``. ``slo`` (CLI
        ``--slo``) declares objectives — e.g.
        ``'ttft_p99_ms<=250,completion_p95_s<=4,joules_per_token<=0.35'``
        — evaluated on every sampler tick with multi-window burn-rate
        alerting (``slo_pairs`` overrides the (short, long, threshold)
        window pairs; tests/smoke use tiny ones). Under the kill switch
        the sampler never starts and the endpoint 404s.

        Disaggregated prefill/decode: ``role`` (CLI
        ``--role``, default "mixed") declares this replica's place in a
        role fleet. "mixed" is byte-identical today-behavior; "prefill"
        and "decode" only change what the replica REPORTS (/healthz
        gains ``role``) — a router does the role-aware dispatch, the
        server itself serves every endpoint under any role. Two POST
        endpoints ride along regardless of role: ``/api/migrate`` accepts
        a serialized primed-row bundle (serve/migrate.py) and answers with
        the seated row's SSE stream; ``/admin/evacuate`` asks the
        continuous scheduler to export every exportable in-flight row
        (drain evacuation — each row's bundle rides its own stream's final
        record) and returns the count. An ``x_prime`` body key on a
        streaming ``/api/generate`` primes the row: prefill here, then the
        final record carries its bundle.

        Tenant usage accounting: every request may carry
        ``x_tenant``; terminal outcomes land in the ``llm_tenant_*``
        families and the bounded aggregate table served on
        ``GET /debug/tenants``. ``usage_ledger_dir`` (CLI
        ``--usage-ledger-dir``) additionally installs a crash-safe
        append-only JSONL usage ledger there (one record per terminal
        request, monotonic ``seq`` resumed across restarts so a billing
        replay never double-bills) with a periodic aggregate snapshot
        on the sampler tick and a final flush at stop(). Inert under
        the telemetry kill switch."""
        if model_policy is not None:
            raise NotImplementedError(FLEET_NOT_PORTED)
        self.backend = backend
        if role is None:
            role = "mixed"
        if role not in protocol.SERVER_ROLES:
            raise ValueError(
                f"role must be one of {protocol.SERVER_ROLES}, got {role!r}"
            )
        self.role = role
        self.default_priority = (
            int(default_priority)
            if default_priority is not None
            else protocol.DEFAULT_PRIORITY
        )
        self.models = list(models) if models else []
        self.quiet = quiet
        self.access_log = access_log
        self._generate_lock = threading.Lock()
        self._scheduler = None
        if scheduler not in (None, "window", "continuous"):
            raise ValueError(
                f"scheduler must be None, 'window' or 'continuous', "
                f"got {scheduler!r}"
            )
        self.scheduler_mode = "off"
        if batch_window_ms > 0 or scheduler is not None:
            from .scheduler import BatchScheduler, ContinuousScheduler

            mode = scheduler
            if mode is None:
                batched = (
                    type(backend).generate_batch
                    is not GenerationBackend.generate_batch
                )
                mode = (
                    "continuous"
                    if batched and hasattr(backend, "decode_open")
                    else "window"
                )
            window_s = (
                batch_window_ms if batch_window_ms > 0 else 50.0
            ) / 1e3
            if mode == "continuous":
                preempt_kwargs = {}
                if preempt_policy is not None:
                    preempt_kwargs["preempt_policy"] = preempt_policy
                if preempt_max_wait_s is not None:
                    preempt_kwargs["preempt_max_wait_s"] = preempt_max_wait_s
                self._scheduler = ContinuousScheduler(
                    backend,
                    max_batch=max_batch,
                    window_s=window_s,
                    lock=self._generate_lock,
                    budget_aware=budget_aware,
                    slice_steps=slice_steps,
                    prefill_chunk_tokens=prefill_chunk_tokens,
                    ttft_slo_ms=ttft_slo_ms,
                    spec_accept_floor=spec_accept_floor,
                    **preempt_kwargs,
                )
            else:
                self._scheduler = BatchScheduler(
                    backend,
                    max_batch=max_batch,
                    window_s=window_s,
                    lock=self._generate_lock,
                    budget_aware=budget_aware,
                    ttft_slo_ms=ttft_slo_ms,
                )
            self.scheduler_mode = mode
        # Windowed telemetry + SLOs. Ring and engine are
        # constructed unconditionally (cheap, a few objects); only the
        # SAMPLER is gated on the kill switch — see start()/stop().
        self.ts_ring = obs_ts.TimeSeriesRing(
            capacity=(
                int(ts_capacity)
                if ts_capacity is not None
                else obs_ts.DEFAULT_CAPACITY
            ),
            interval_s=(
                float(ts_interval_s)
                if ts_interval_s is not None
                else obs_ts.DEFAULT_INTERVAL_S
            ),
        )
        objectives = obs_slo.parse_slo_spec(slo) if slo else []
        self.slo_engine = (
            obs_slo.SLOEngine(
                objectives,
                self.ts_ring,
                pairs=slo_pairs or obs_slo.DEFAULT_BURN_PAIRS,
                name="server",
            )
            if objectives
            else None
        )
        self._sampler = obs_ts.SamplerThread(
            self._telemetry_tick,
            interval_s=self.ts_ring.interval_s,
            name="serve-ts-sampler",
        )
        # Tenant usage ledger: opened only while telemetry is
        # ON (the accounting funnel is a no-op under the kill switch, so
        # an open ledger would only ever hold an empty file).
        self._usage_ledger: Optional[obs_tenants.UsageLedger] = None
        self._ledger_snap_seq = -1
        if usage_ledger_dir and obs_metrics.enabled():
            self._usage_ledger = obs_tenants.UsageLedger(usage_ledger_dir)
            obs_tenants.install_ledger(self._usage_ledger)
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None
        # Set whenever a serve loop is live (threaded start() OR blocking
        # serve_forever()) — stop() keys shutdown() on it, not on _thread.
        self._serving = threading.Event()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def _telemetry_tick(self) -> None:
        """One sampler-cadence tick: snapshot the registry into the
        ring, then re-evaluate the SLO objectives against it. No-op
        end to end while telemetry is disabled."""
        self.ts_ring.sample_once()
        if self.slo_engine is not None:
            self.slo_engine.evaluate()
        # periodic usage-ledger aggregate snapshot: written
        # only when new records landed since the last tick (atomic
        # rename; a consumer catches up without replaying the ledger)
        ledger = self._usage_ledger
        if ledger is not None and ledger.seq != self._ledger_snap_seq:
            try:
                ledger.write_snapshot(obs_tenants.TABLE)
                self._ledger_snap_seq = ledger.seq
            except OSError:
                pass

    def _close_usage_ledger(self) -> None:
        """Final ledger flush + snapshot (idempotent), detaching it from
        the process-wide funnel only if it is still the installed one
        (tests run several servers per process)."""
        ledger, self._usage_ledger = self._usage_ledger, None
        if ledger is None:
            return
        if obs_tenants.current_ledger() is ledger:
            obs_tenants.install_ledger(None)
        try:
            ledger.close(obs_tenants.TABLE)
        except OSError:
            pass

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: A003
                # http.server's per-request stderr noise is replaced by
                # the opt-in structured access log in _observed (below);
                # measurement runs stay quiet by default.
                pass

            def send_response(self, code, message=None):
                self._obs_status = code  # captured for metrics/access log
                super().send_response(code, message)

            def _observed(self, handler) -> None:
                """Run one request handler with timing: HTTP metrics
                always (cheap; no-ops when telemetry is off), plus the
                opt-in structured access-log line."""
                path = self.path.split("?", 1)[0]
                self._obs_status = 0
                t0 = time.monotonic()
                try:
                    handler()
                finally:
                    dur_s = time.monotonic() - t0
                    _HTTP_REQUESTS_C.labels(
                        method=self.command,
                        path=path,
                        status=str(self._obs_status),
                    ).inc()
                    _HTTP_SECONDS_H.labels(path=path).observe(dur_s)
                    if server.access_log:
                        term.log(
                            "serve: "
                            + json.dumps(
                                {
                                    "method": self.command,
                                    "path": path,
                                    "status": self._obs_status,
                                    "duration_ms": round(dur_s * 1e3, 3),
                                }
                            )
                        )

            def _send_metrics(self) -> None:
                """Prometheus text exposition; 404 while telemetry is
                disabled so scrapers see 'off', not silently-empty."""
                if not obs_metrics.enabled():
                    self._send_json(
                        404, {"error": "telemetry disabled (TPU_LLM_OBS=0)"}
                    )
                    return
                body = obs_metrics.REGISTRY.exposition().encode("utf-8")
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_debug_state(self) -> None:
                """Live scheduler/session/pool snapshot (forensics; 404
                while telemetry is off — same contract as /metrics).
                Best-effort: the snapshot races the scheduler loop by
                design and must never 500 a probe."""
                if not obs_metrics.enabled():
                    self._send_json(
                        404, {"error": "telemetry disabled (TPU_LLM_OBS=0)"}
                    )
                    return
                state = {
                    "t_s": round(time.monotonic(), 6),
                    "backend": type(server.backend).__name__,
                    "scheduler_mode": server.scheduler_mode,
                    "flight": FLIGHT.summary(),
                }
                # sharded backends (parallel/tp.py) report their device
                # mesh at the top level — present even between sessions,
                # when no live carry exists to introspect
                try:
                    mesh_info = getattr(server.backend, "mesh_info", None)
                    info = mesh_info() if callable(mesh_info) else None
                    if info is not None:
                        state["mesh"] = info
                except Exception:  # noqa: BLE001 — probe only
                    pass
                # the engine-owned prefix store: reported top-level —
                # present between sessions and across scheduler restarts,
                # exactly the lifetime the store exists to provide
                try:
                    store = getattr(server.backend, "prefix_store", None)
                    if store is not None:
                        state["prefix_store"] = store.debug_state()
                except Exception:  # noqa: BLE001 — probe only
                    pass
                # weight lifecycle: which models are
                # resident, their estimated bytes, and which hold live
                # stepped rows (the eviction-guard refcounts) — the
                # backend-owned view, present whatever scheduler runs
                try:
                    models_state = getattr(
                        server.backend, "models_debug_state", None
                    )
                    if models_state is not None:
                        state["models"] = models_state()
                except Exception:  # noqa: BLE001 — probe only
                    pass
                try:
                    if server._scheduler is not None:
                        state["scheduler"] = server._scheduler.debug_state()
                except Exception as exc:  # noqa: BLE001 — probe only
                    state["scheduler_error"] = f"{type(exc).__name__}: {exc}"
                # SLO attainment: the last evaluation's
                # per-objective attainment/burn/alert state rides the
                # forensic snapshot
                try:
                    if server.slo_engine is not None:
                        state["slo"] = server.slo_engine.snapshot()
                except Exception:  # noqa: BLE001 — probe only
                    pass
                self._send_json(200, state)

            def _send_debug_timeseries(self) -> None:
                """Windowed rollups from the in-process time-series
                ring: ``?family=`` selects one family (the
                payload then includes its strided point series),
                ``?window=`` the rollup window in seconds (default 60),
                ``?step=`` the point stride. 404 while telemetry is
                off — same contract as /metrics."""
                if not obs_metrics.enabled():
                    self._send_json(
                        404, {"error": "telemetry disabled (TPU_LLM_OBS=0)"}
                    )
                    return
                query = parse_qs(
                    self.path.partition("?")[2], keep_blank_values=False
                )
                family = query.get("family", [None])[0]
                try:
                    window_s = float(query.get("window", ["60"])[0])
                    step_raw = query.get("step", [None])[0]
                    step_s = float(step_raw) if step_raw else None
                except ValueError:
                    self._send_json(
                        400, {"error": "window/step must be numbers"}
                    )
                    return
                payload = server.ts_ring.debug_payload(
                    family=family, window_s=window_s, step_s=step_s
                )
                if server.slo_engine is not None:
                    payload["slo"] = server.slo_engine.snapshot()
                self._send_json(200, payload)

            def _send_debug_flight(self) -> None:
                """Flight-recorder tail: ``?n=`` bounds the event count
                (default 200), ``?type=`` filters by event type,
                ``?trace=`` by fleet-wide trace id (or process-local
                span id; the router's timeline endpoint
                pulls exactly this filter from every replica). 404
                while telemetry is off."""
                if not obs_metrics.enabled():
                    self._send_json(
                        404, {"error": "telemetry disabled (TPU_LLM_OBS=0)"}
                    )
                    return
                query = parse_qs(
                    self.path.partition("?")[2], keep_blank_values=False
                )
                try:
                    n = int(query.get("n", ["200"])[0])
                except ValueError:
                    self._send_json(400, {"error": "n must be an integer"})
                    return
                type_ = query.get("type", [None])[0]
                trace = query.get("trace", [None])[0]
                self._send_json(
                    200,
                    {
                        "summary": FLIGHT.summary(),
                        "events": FLIGHT.events(
                            n=n, type_=type_, trace=trace
                        ),
                    },
                )

            def _send_debug_tenants(self) -> None:
                """Per-tenant usage aggregates: the bounded
                tenant table's requests/tokens/Joules plus the ledger
                position when one is installed. 404 while telemetry is
                off — same contract as /metrics."""
                if not obs_metrics.enabled():
                    self._send_json(
                        404, {"error": "telemetry disabled (TPU_LLM_OBS=0)"}
                    )
                    return
                payload = obs_tenants.snapshot()
                payload["role"] = server.role
                self._send_json(200, payload)

            def _send_healthz(self) -> None:
                """Cheap liveness probe: status, scheduler
                kind and in-flight/queued row counts — the router's
                probe target and a k8s-style check. Unlike /metrics and
                /debug/*, this answers under the telemetry kill switch
                (liveness must not depend on observability), and every
                field beyond ``status`` is best-effort."""
                state = {
                    "status": "ok",
                    "backend": type(server.backend).__name__,
                    "scheduler": server.scheduler_mode,
                    "role": server.role,
                    "queue_depth": 0,
                    "inflight_rows": 0,
                }
                try:
                    if server._scheduler is not None:
                        health = server._scheduler.health_state()
                        state["scheduler"] = health.get(
                            "scheduler", server.scheduler_mode
                        )
                        state["queue_depth"] = health.get("queue_depth", 0)
                        state["inflight_rows"] = health.get(
                            "inflight_rows", 0
                        )
                        # live admission headroom: remote
                        # probes read capacity HERE, not from a
                        # best-effort /metrics scrape
                        if "max_admission_rows" in health:
                            state["max_admission_rows"] = health[
                                "max_admission_rows"
                            ]
                        if not health.get("running", True):
                            state["status"] = "stopping"
                except Exception:  # noqa: BLE001 — probe only
                    pass
                try:
                    # bounded radix-store prefix summary (affinity
                    # routing) — absent when prefix sharing is off or the
                    # backend has no store
                    store = getattr(server.backend, "prefix_store", None)
                    if store is not None and hasattr(store, "digest"):
                        state["prefix_digest"] = store.digest()
                except Exception:  # noqa: BLE001 — probe only
                    pass
                self._send_json(200, state)

            def _send_json(self, status: int, payload) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_json(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b"{}"
                return json.loads(raw.decode("utf-8"))

            def do_GET(self):  # noqa: N802
                self._observed(self._do_get)

            def do_POST(self):  # noqa: N802
                self._observed(self._do_post)

            def _do_get(self):
                if self.path == protocol.METRICS_PATH:
                    self._send_metrics()
                elif self.path.split("?", 1)[0] == protocol.DEBUG_STATE_PATH:
                    self._send_debug_state()
                elif self.path.split("?", 1)[0] == protocol.DEBUG_FLIGHT_PATH:
                    self._send_debug_flight()
                elif (
                    self.path.split("?", 1)[0]
                    == protocol.DEBUG_TIMESERIES_PATH
                ):
                    self._send_debug_timeseries()
                elif (
                    self.path.split("?", 1)[0] == protocol.DEBUG_TENANTS_PATH
                ):
                    self._send_debug_tenants()
                elif self.path == protocol.HEALTH_PATH:
                    self._send_healthz()
                elif self.path == protocol.TAGS_PATH:
                    self._send_json(
                        200,
                        {"models": [{"name": m} for m in server.models]},
                    )
                elif self.path == protocol.PS_PATH:
                    # Ollama parity: the models currently resident in
                    # accelerator memory (vs /api/tags: the servable set).
                    self._send_json(
                        200,
                        {
                            "models": [
                                {"name": m}
                                for m in server.backend.loaded_models()
                            ]
                        },
                    )
                elif self.path == protocol.VERSION_PATH:
                    self._send_json(
                        200, {"version": protocol.SERVER_VERSION}
                    )
                else:
                    self._send_json(404, {"error": f"unknown path {self.path}"})

            def _do_post(self):
                try:
                    body = self._read_json()
                except (ValueError, json.JSONDecodeError) as exc:
                    self._send_json(400, {"error": f"bad JSON: {exc}"})
                    return
                if self.path == protocol.GENERATE_PATH:
                    self._handle_generate(body)
                elif self.path == protocol.LOAD_PATH:
                    self._handle_load(body)
                elif self.path == protocol.MIGRATE_PATH:
                    self._handle_migrate(body)
                elif (
                    self.path.split("?", 1)[0]
                    == protocol.ADMIN_EVACUATE_PATH
                ):
                    self._handle_evacuate()
                else:
                    self._send_json(404, {"error": f"unknown path {self.path}"})

            def _handle_generate(self, body) -> None:
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
                # Fleet-wide trace: adopt the caller's x_trace
                # (a router hop, or a trace-minting load generator) or
                # mint one — the root span and every flight event this
                # request produces carry it, so /debug/flight?trace= and
                # the router's cross-process timeline can find them.
                request = protocol.ensure_trace(request)
                span_attrs = {"model": request.model}
                if request.trace.parent is not None:
                    # the forwarding hop's span id — the cross-process
                    # parent link a timeline viewer stitches on
                    span_attrs["parent_hop"] = request.trace.parent
                if body.get("stream"):
                    # Disaggregated prime: x_prime rides the raw body
                    # (request_from_wire ignores unknown keys) — run
                    # prefill to completion, export the row, answer with a
                    # final record carrying the bundle. Only the
                    # continuous scheduler speaks it; anything else decays
                    # to a normal stream (the caller treats the absence of
                    # a bundle as "serve it here").
                    prime = bool(body.get(protocol.PRIME_KEY))
                    with TRACER.span(
                        "request",
                        trace_id=request.trace.trace_id,
                        stream=True,
                        **span_attrs,
                    ):
                        self._handle_generate_stream(request, prime=prime)
                    return
                # The request's ROOT span: the scheduler's queue span and
                # the engine's prefill/decode spans parent under it (the
                # ticket carries it across the scheduler's thread hop).
                try:
                    with TRACER.span(
                        "request",
                        trace_id=request.trace.trace_id,
                        **span_attrs,
                    ):
                        if server._scheduler is not None:
                            result = server._scheduler.submit(request)
                        else:
                            with server._generate_lock:
                                result = server.backend.generate(request)
                except KeyError as exc:
                    self._send_json(404, {"error": f"model not found: {exc}"})
                except ValueError as exc:
                    # Engine-side request validation (empty-encoding prompt,
                    # budget over max_seq_len, …) is the client's fault.
                    self._send_json(400, {"error": str(exc)})
                except DeadlineExceeded as exc:
                    # queued past x_deadline_ms / --ttft-slo-ms, or the
                    # deadline passed mid-flight: the scheduler shed it
                    self._send_json(504, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001 — server must not die
                    self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
                else:
                    self._send_json(200, protocol.result_to_wire(result))

            def _write_sse_chunk(self, payload) -> None:
                """One SSE event as one HTTP/1.1 chunk (protocol.sse_event
                pins the framing; the golden test pins those bytes)."""
                data = protocol.sse_event(payload)
                self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            def _write_sse_keepalive(self) -> None:
                """One ``: keep-alive`` SSE comment as one HTTP/1.1
                chunk — ignored by every SSE parser (incl. our own
                sse_records), but bytes on the wire reset client/proxy
                idle timers during long prefill gaps."""
                data = protocol.SSE_KEEPALIVE
                self.wfile.write(f"{len(data):X}\r\n".encode("ascii"))
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            def _start_sse(self) -> None:
                self.send_response(200)
                self.send_header(
                    "Content-Type", protocol.STREAM_CONTENT_TYPE
                )
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                # A consumer that stops reading would otherwise block
                # flush() forever — bound every socket write so one
                # stalled client can't wedge its handler (or, on the
                # serial path, the generate lock).
                self.connection.settimeout(STREAM_WRITE_TIMEOUT_S)

            def _end_sse(self) -> None:
                try:
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    self.close_connection = True

            def _final_record(self, result) -> dict:
                final = protocol.result_to_wire(result)
                # Ollama-style: the final record's response is empty
                # (text was streamed); the authoritative full text
                # (per-chunk deltas can split multi-byte chars, and stop
                # strings cut retroactively) rides in x_text.
                final["response"] = ""
                final["x_text"] = result.text
                return final

            def _handle_generate_stream(self, request, prime=False) -> None:
                """``stream: true``: Server-Sent Events of incremental
                ``response`` deltas ending with a ``done: true`` event
                carrying the aggregate stats + extras (energy payload
                included). Routed through the continuous scheduler's
                per-request egress channel when one is running — tokens
                leave per decode slice, and a dead socket CANCELS the
                row mid-flight — else served from the backend's own
                generate_stream under the serial lock."""
                if (
                    server._scheduler is not None
                    and server.scheduler_mode == "continuous"
                ):
                    self._stream_via_scheduler(request, prime=prime)
                else:
                    self._stream_serial(request)

            def _stream_via_scheduler(self, request, prime=False) -> None:
                """Streaming delivery: the scheduler's slice
                loop produces into the bounded egress channel; this
                handler drains it onto the SSE socket. A failed socket
                write cancels the channel — the scheduler retires the
                row within one decode slice (``reason="cancelled"``) and
                its pages return to the pool."""
                try:
                    if prime and hasattr(server._scheduler, "submit_prime"):
                        channel = server._scheduler.submit_prime(request)
                    else:
                        channel = server._scheduler.submit_stream(request)
                except RuntimeError as exc:
                    self._send_json(503, {"error": str(exc)})
                    return
                self._pump_channel(channel, request.model)

            def _pump_channel(self, channel, model) -> None:
                """Drain one egress channel onto the SSE socket — the
                shared tail of /api/generate streaming and the migrate
                endpoint's seated-row stream."""
                events = channel.events(keepalive_s=STREAM_KEEPALIVE_S)
                # Headers wait for the first REAL event, so fast
                # pre-admission failures (bad prompt, unknown model,
                # deadline shed) surface as clean HTTP statuses, not
                # broken streams. If the producer is silent past the
                # keep-alive cadence (a long chunked join-prefill), the
                # stream opens anyway and comments flow — a late
                # failure then ends it as a terminal SSE error event.
                started = False
                try:
                    for event in events:
                        if event.kind == "keepalive":
                            if not started:
                                self._start_sse()
                                started = True
                            self._write_sse_keepalive()
                            continue
                        if not started:
                            if event.kind == "error":
                                self._send_stream_open_error(event.error)
                                return
                            self._start_sse()
                            started = True
                        if event.kind == "delta":
                            self._write_sse_chunk(
                                protocol.stream_chunk_to_wire(
                                    model, event.text, event.tokens
                                )
                            )
                        elif event.kind == "done":
                            self._write_sse_chunk(
                                self._final_record(event.result)
                            )
                        else:
                            # mid-stream failure (engine death, deadline
                            # passed in flight): a terminal error event
                            # so the client sees a clean end
                            self._write_sse_chunk(
                                {
                                    "error": (
                                        f"{type(event.error).__name__}: "
                                        f"{event.error}"
                                    ),
                                    "done": True,
                                }
                            )
                except OSError:
                    # Socket gone (client hung up / write timed out):
                    # cancel the channel — the scheduler notices between
                    # slices and retires the row, recycling its pages.
                    channel.cancel(cause="disconnect")
                    self.close_connection = True
                    return
                self._end_sse()

            def _send_stream_open_error(self, exc) -> None:
                if isinstance(exc, DeadlineExceeded):
                    self._send_json(504, {"error": str(exc)})
                elif isinstance(exc, StreamCancelled):
                    # consumer cancelled before the first token; nothing
                    # useful to send — close quietly
                    self.close_connection = True
                elif isinstance(exc, KeyError):
                    self._send_json(
                        404, {"error": f"model not found: {exc}"}
                    )
                elif isinstance(exc, ValueError):
                    self._send_json(400, {"error": str(exc)})
                else:
                    self._send_json(
                        500, {"error": f"{type(exc).__name__}: {exc}"}
                    )

            def _stream_serial(self, request) -> None:
                """The pre-scheduler streaming path (serial lock, the
                backend's own chunked generate_stream), now SSE-framed
                like the scheduler path so clients speak one format."""
                with server._generate_lock:
                    stream = server.backend.generate_stream(request)
                    try:
                        first = next(stream)
                    except StopIteration:
                        self._send_json(
                            500, {"error": "backend produced an empty stream"}
                        )
                        return
                    except KeyError as exc:
                        self._send_json(
                            404, {"error": f"model not found: {exc}"}
                        )
                        return
                    except ValueError as exc:
                        self._send_json(400, {"error": str(exc)})
                        return
                    except Exception as exc:  # noqa: BLE001
                        self._send_json(
                            500, {"error": f"{type(exc).__name__}: {exc}"}
                        )
                        return
                    self._start_sse()
                    try:
                        for chunk in itertools.chain([first], stream):
                            if chunk.done:
                                self._write_sse_chunk(
                                    self._final_record(chunk.result)
                                )
                            else:
                                self._write_sse_chunk(
                                    protocol.stream_chunk_to_wire(
                                        request.model, chunk.text, chunk.tokens
                                    )
                                )
                    except OSError:
                        # Socket gone (client hung up / write timed out):
                        # nothing more to send; drop the connection.
                        self.close_connection = True
                        return
                    except Exception as exc:  # noqa: BLE001 — backend died
                        # Headers are out; surface the failure as a final
                        # SSE error event so the client sees a clean,
                        # terminated stream instead of an IncompleteRead.
                        try:
                            self._write_sse_chunk(
                                {
                                    "error": f"{type(exc).__name__}: {exc}",
                                    "done": True,
                                }
                            )
                        except OSError:
                            self.close_connection = True
                            return
                    self._end_sse()

            def _handle_load(self, body) -> None:
                model = body.get("model")
                if not model:
                    self._send_json(400, {"error": "load requires 'model'"})
                    return
                if server.models and model not in server.models:
                    # 403, not 404: the client reads a 404 from /api/load as
                    # "plain Ollama without this endpoint" and falls back to
                    # a warm-up generate (serve/client.py) — an allowlist
                    # rejection must be distinguishable from that.
                    self._send_json(
                        403, {"error": f"model {model!r} not in served set"}
                    )
                    return
                try:
                    with server._generate_lock:
                        server.backend.load_model(str(model))
                        warm = body.get("x_warmup")
                        if warm:
                            server.backend.warmup(
                                protocol.request_from_wire(warm)
                            )
                except KeyError as exc:
                    self._send_json(404, {"error": f"model not found: {exc}"})
                except ValueError as exc:
                    # Bad x_warmup payloads (e.g. num_predict over the cap)
                    # are client errors, same as on /api/generate.
                    self._send_json(400, {"error": str(exc)})
                except Exception as exc:  # noqa: BLE001
                    self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
                else:
                    self._send_json(200, {"status": "loaded", "model": model})

            def _handle_migrate(self, body) -> None:
                """``POST /api/migrate``: seat one serialized
                primed/evacuated row (serve/migrate.py bundle) into the
                continuous scheduler and answer with the row's SSE
                stream — the same framing /api/generate streams, so the
                router relays it to the waiting client unchanged."""
                sched = server._scheduler
                if sched is None or not hasattr(sched, "submit_migrate"):
                    self._send_json(
                        503,
                        {
                            "error": (
                                "migrate requires the continuous "
                                "scheduler (got "
                                f"{server.scheduler_mode!r})"
                            )
                        },
                    )
                    return
                # The bundle's embedded request carries the fleet-wide
                # trace (x_trace) when the router stamped one — the
                # seated row's spans and flight events join it, so one
                # trace id covers both replicas' halves of the request.
                span_kwargs = {"model": body.get("model", "")}
                req_wire = body.get("request")
                xt = (
                    req_wire.get("x_trace")
                    if isinstance(req_wire, dict)
                    else None
                )
                if isinstance(xt, dict) and xt.get("id"):
                    span_kwargs["trace_id"] = str(xt["id"])
                with TRACER.span(
                    "request", stream=True, migrated=True, **span_kwargs
                ):
                    try:
                        channel = sched.submit_migrate(body)
                    except (ValueError, KeyError, TypeError) as exc:
                        self._send_json(
                            400, {"error": f"bad migrate bundle: {exc}"}
                        )
                        return
                    except RuntimeError as exc:
                        self._send_json(503, {"error": str(exc)})
                        return
                    self._pump_channel(channel, body.get("model", ""))

            def _handle_evacuate(self) -> None:
                """``POST /admin/evacuate``: export every
                exportable in-flight row as a migrate bundle (each rides
                its own stream's final record) and report the count —
                the router's drain(migrate=True) calls this on remote
                replicas before waiting out whatever refused to move."""
                sched = server._scheduler
                if sched is None or not hasattr(sched, "evacuate"):
                    self._send_json(
                        503,
                        {
                            "error": (
                                "evacuate requires the continuous "
                                "scheduler (got "
                                f"{server.scheduler_mode!r})"
                            )
                        },
                    )
                    return
                query = parse_qs(
                    self.path.partition("?")[2], keep_blank_values=False
                )
                try:
                    timeout_s = float(query.get("timeout", ["30"])[0])
                except ValueError:
                    self._send_json(
                        400, {"error": "timeout must be a number"}
                    )
                    return
                try:
                    count = sched.evacuate(timeout_s=timeout_s)
                except Exception as exc:  # noqa: BLE001 — admin probe
                    self._send_json(
                        500, {"error": f"{type(exc).__name__}: {exc}"}
                    )
                    return
                self._send_json(200, {"status": "ok", "evacuated": count})

        return Handler

    def start(self) -> None:
        """Serve on a daemon thread; returns once the socket is listening."""
        if self._scheduler is not None:
            self._scheduler.start()
        self._sampler.start()  # refuses under the telemetry kill switch
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="generation-server", daemon=True
        )
        self._thread.start()
        # Only after start() returns: if the thread failed to launch, a
        # cleanup stop() must not block in shutdown() waiting on a serve
        # loop that never began.
        self._serving.set()

    def serve_forever(self) -> None:
        if not self.quiet:
            term.log_ok(f"generation server listening on :{self.port}")
        if self._scheduler is not None:
            self._scheduler.start()
        self._sampler.start()  # refuses under the telemetry kill switch
        self._serving.set()
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._serving.clear()
            self._sampler.stop()
            self._close_usage_ledger()
            self._httpd.server_close()

    def stop(self) -> None:
        self._sampler.stop()
        if self._scheduler is not None:
            self._scheduler.stop()
        self._close_usage_ledger()
        # shutdown() blocks on an event only serve_forever() sets; skip it
        # when no serve loop ever started (e.g. setup failed before start).
        if self._serving.is_set():
            self._httpd.shutdown()
            self._serving.clear()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
