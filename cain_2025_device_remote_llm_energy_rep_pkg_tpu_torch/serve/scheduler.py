"""Batching schedulers for the generation server.

The reference's Ollama server handles one request at a time and the
experiment sends one request per run (experiment/RunnerConfig.py:128-131).
A GPU serving a fleet of clients would waste most of its memory bandwidth that
way: decode is bandwidth-bound, so co-scheduling concurrent requests into
one batched decode multiplies tokens/s at nearly constant energy/step.
Two schedulers give the HTTP server that ability without changing the
wire protocol:

- :class:`BatchScheduler` (WINDOW dispatch): concurrent ``/api/generate``
  POSTs arriving within a small admission window coalesce into one
  ``generate_batch`` call that runs to completion. Simple, and the right
  model when the backend has no resumable decode — but a request arriving
  just after a window closes waits for the slowest row of the previous
  batch, and the engine keeps stepping EOS-finished rows until the whole
  batch drains.

- :class:`ContinuousScheduler` (ITERATION-LEVEL dispatch, Orca-style):
  drives the backend's stepped-decode protocol (``decode_open`` →
  ``session.step``/``join`` — engine/stepped.py). The loop runs
  admit → step → retire phases: each bounded decode slice returns
  control, rows whose done-mask set RETIRE immediately (their ticket
  completes and, on the paged engine, their KV pages return to the pool
  mid-flight), and queued compatible requests JOIN the freed rows with
  the budget-aware admission cap re-evaluated at each admission. Joins
  are CHUNKED by default: a joiner's prompt prefill streams in as
  token-budgeted chunks interleaved with decode slices (at most one
  chunk between two slices, pending joiners round-robin), so one
  long-prompt joiner can no longer stall every in-flight row for its
  whole prefill. Callers stop waiting for strangers' long tails:
  time-to-first-token is bounded by one slice + a prefill instead of
  the previous batch's slowest row, and in-flight inter-token latency
  is bounded by one slice + one prefill chunk.

Both preserve per-request results exactly: the batched/stepped engines
are token-identical per row to a solo ``generate``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..engine.backend import (
    GenerationBackend,
    GenerationRequest,
    GenerationResult,
)
from ..obs.detect import SLICE_SPIKES
from ..obs.energy import charge_wasted
from ..obs.flight import (
    EV_BATCH_FALLBACK,
    EV_JOIN_CHUNK,
    EV_REQUEST_ADMITTED,
    EV_REQUEST_REJECTED,
    EV_ROW_PREEMPTED,
    EV_ROW_RESUMED,
    EV_ROW_MIGRATED,
    EV_ROW_RETIRED,
    EV_SLICE,
    EV_STREAM_CHUNK,
    FLIGHT,
    trace_attrs,
    trace_of,
)
from ..obs.metrics import (
    REGISTRY,
    ROW_BUCKETS,
    enabled as _obs_enabled,
    observe_migrate,
)
from ..obs.tenants import account_request
from ..obs.trace import TRACER
from .stream import (
    DeadlineExceeded,
    StreamCancelled,
    TokenStream,
    open_stream,
)

# Admission/queue telemetry (obs): the scheduler is where a request's
# wait is DECIDED — queue-wait and window-collect histograms plus the
# admission-cap distribution make the budget-admission win (the
# A/B tables) continuously visible instead of hand-run.
_QUEUE_WAIT_H = REGISTRY.histogram(
    "llm_sched_queue_wait_seconds",
    "Submit-to-dispatch wait of one request in the batching queue",
)
_COLLECT_H = REGISTRY.histogram(
    "llm_sched_window_collect_seconds",
    "Wall time the batch anchor spent collecting companions",
)
_ADMISSION_CAP_H = REGISTRY.histogram(
    "llm_sched_admission_cap_rows",
    "Row cap applied to each batch window (static or budget-raised)",
    buckets=ROW_BUCKETS,
)
_BATCH_ROWS_H = REGISTRY.histogram(
    "llm_sched_batch_rows",
    "Rows actually admitted into each dispatched batch/session open",
    buckets=ROW_BUCKETS,
)
_REQUESTS_C = REGISTRY.counter(
    "llm_sched_requests_total", "Requests submitted to the batch scheduler"
)
_BATCHES_C = REGISTRY.counter(
    "llm_sched_batches_total",
    "Batches dispatched to the backend (continuous: sessions opened)",
)
_BUDGET_ADMISSION_C = REGISTRY.counter(
    "llm_sched_budget_admission_total",
    "Admission-cap decisions by outcome: raised (budget estimate beat "
    "max_batch), static (estimate at/below it or budget admission off), "
    "error (probe failed; static cap used)",
    labels=("outcome",),
)
_BATCH_FALLBACK_C = REGISTRY.counter(
    "llm_sched_batch_fallback_total",
    "Batch-level dispatch failures that fell back to bisected isolation "
    "(each inc is one failed batch/session call, incl. recursive splits)",
)
# Iteration-level (continuous) scheduling telemetry: joins/retirements at
# decode-step granularity plus the per-request latency split that shows
# the win over window dispatch on /metrics.
_ROWS_JOINED_C = REGISTRY.counter(
    "llm_sched_rows_joined_total",
    "Requests admitted into an ALREADY-RUNNING continuous decode session "
    "(mid-flight joins; session-opening rows count in llm_sched_batch_rows)",
)
_ROWS_RETIRED_C = REGISTRY.counter(
    "llm_sched_rows_retired_total",
    "Continuous-session rows retired, by reason (eos: sampled EOS; "
    "budget: token budget exhausted; error: failed/salvaged; "
    "shutdown: scheduler stopped mid-flight; cancelled: the streaming "
    "client disconnected or cancelled; deadline: the request's "
    "deadline_ms passed mid-flight)",
    labels=("reason",),
)
# Deadline SLOs: rejections at the admission EDGE — a queued
# ticket whose own deadline already passed, or whose queue wait alone
# exceeds the server-wide --ttft-slo-ms, fails before any prefill is
# paid. Mid-flight deadline retirements count on
# llm_sched_rows_retired_total{reason="deadline"} instead.
_DEADLINE_REJECTED_C = REGISTRY.counter(
    "llm_sched_deadline_rejected_total",
    "Queued tickets rejected pre-admission, by reason (deadline: the "
    "request's deadline_ms already passed; ttft_slo: queue wait alone "
    "exceeded the server TTFT SLO, so the SLO is unmeetable)",
    labels=("reason",),
)
_INFLIGHT_G = REGISTRY.gauge(
    "llm_sched_inflight_rows",
    "Live rows in the current continuous decode session (0 when idle)",
)
_TTFT_H = REGISTRY.histogram(
    "llm_request_ttft_seconds",
    "Submit → the request's first generated token exists (continuous: "
    "measured at admission-prefill completion — a chunked joiner's "
    "spans all its prefill chunks; window: estimated as completion "
    "minus the shared decode window minus the recorded queue wait, "
    "which llm_sched_queue_wait_seconds reports separately)",
)
_COMPLETION_H = REGISTRY.histogram(
    "llm_request_completion_seconds",
    "Submit → result handed back to the caller",
)
# Chunked join-prefill (continuous scheduler): a joiner's prompt prefill
# is split into token-budgeted chunks interleaved with decode slices, so
# in-flight rows' stall per slice is bounded by the chunk budget instead
# of the joiner's prompt length. These three families make that policy's
# cost continuously visible: per-chunk wall, the stall decode actually
# paid, and chunk volume.
_JOIN_PREFILL_H = REGISTRY.histogram(
    "llm_sched_join_prefill_seconds",
    "Wall time of ONE join-prefill chunk (chunked joins; the final "
    "chunk includes the commit's first-token sample + row scatter)",
)
_DECODE_STALL_H = REGISTRY.histogram(
    "llm_sched_decode_stall_seconds",
    "Time in-flight decode rows waited on join-prefill work between two "
    "decode slices (observed only when live rows were actually waiting)",
)
_JOIN_CHUNKS_C = REGISTRY.counter(
    "llm_sched_join_chunks_total",
    "Join-prefill chunks executed by the continuous scheduler "
    "(a synchronous join executes its whole prompt as one admit call "
    "and does not count here)",
)
# SLO tiers + mid-flight preemption: the continuous
# scheduler preempts the youngest strictly-lower-tier in-flight row
# when a higher-tier ticket cannot be admitted (pages/slots short),
# parks the victim — its KV swapped to host (policy=swap) or dropped
# for re-prefill (policy=recompute) — and resumes it when capacity
# returns.
_PREEMPTED_C = REGISTRY.counter(
    "llm_sched_preempted_total",
    "In-flight rows preempted for a higher-tier ticket, by policy "
    "(swap: KV spilled to host memory; recompute: KV dropped, "
    "re-prefilled at resume)",
    labels=("policy",),
)
_RESUMED_C = REGISTRY.counter(
    "llm_sched_resumed_total",
    "Preempted rows re-admitted into their session (through the "
    "chunked-join machinery; the continued stream is bit-identical to "
    "an uninterrupted run)",
)
_PARKED_G = REGISTRY.gauge(
    "llm_sched_parked_rows",
    "Preempted rows currently parked on the resume queue (0 when idle)",
)
# Sampled (not just histogram-observed) queue depth: the time-series
# ring snapshots gauges on a cadence, so
# a live depth gauge gives the SLO/autoscaler loops a windowed
# min/mean/max — llm_sched_queue_wait_seconds only shows waits of
# requests that already LEFT the queue.
_QUEUE_DEPTH_G = REGISTRY.gauge(
    "llm_sched_queue_depth",
    "Tickets currently waiting in the scheduler queue (set at submit "
    "and at every dispatch-loop pull, so cadence samplers see depth "
    "between scrapes)",
)


class _Ticket:
    """One submitted request: the caller blocks on ``event`` until the
    scheduler fills ``result`` or ``error``. ``t_submit``/``span`` carry
    the submit-side clock and the submitting thread's current span so
    the scheduler thread can parent queue/backend spans under the HTTP
    request's root (obs); ``t_first`` is stamped when the request's
    first token exists (continuous admission). ``queue_wait_s`` is the
    recorded submit→dispatch wait (the TTFT fallback subtracts it);
    ``joined``/``join_chunks`` mark mid-flight admissions and how many
    prefill chunks the join took (0 = synchronous). ``stream`` is the
    per-request egress channel for streaming submissions (None =
    buffered): deltas are pushed per decode slice, the terminal event
    ends the channel, and the consumer cancelling it retires the row —
    for streamed tickets ``t_first`` is stamped at the FIRST PUSHED
    CHUNK, so llm_request_ttft_seconds records TTFT-at-first-chunk."""

    __slots__ = (
        "request", "event", "result", "error", "t_submit", "t_first",
        "span", "queue_wait_s", "joined", "join_chunks", "stream",
        "priority", "preempts", "resumed", "wasted",
        "prime", "prime_buf", "migrate_pr", "migrated", "accounted",
    )

    def __init__(self, request: GenerationRequest) -> None:
        self.request = request
        self.event = threading.Event()
        self.result: Optional[GenerationResult] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.span = TRACER.current()
        self.queue_wait_s: Optional[float] = None
        self.joined = False
        self.join_chunks = 0
        self.stream: Optional[TokenStream] = None
        # Wasted-energy ledger: modelled Joules burned on
        # this request's behalf that no response benefits from, by
        # cause (swap/recompute here; the router adds retry) — merged
        # into extras["energy"]["wasted_J"] at completion
        self.wasted: Dict[str, float] = {}
        # Live row migration (disaggregated prefill/decode). ``prime``:
        # run prefill to completion, then preempt + export the row as a
        # migrate bundle instead of decoding it locally — the final
        # stream event carries the bundle in extras["migrate"] (deltas
        # buffer in ``prime_buf`` meanwhile; an export refusal flushes
        # them and the ticket decays to a normal local stream).
        # ``migrate_pr``: an imported preempted row to SEAT (through
        # resume_begin) instead of prefilling; ``migrated`` stamps the
        # wire attribution (extras["sched"]["migrated"]).
        self.prime = False
        self.prime_buf: Optional[list] = None
        self.migrate_pr = None
        self.migrated = False
        # EFFECTIVE SLO tier: starts at the request's priority; a parked
        # preemption victim ages UP one tier per --preempt-max-wait-s
        # waited (starvation protection), so victim selection and resume
        # ordering read this, never request.priority directly.
        self.priority = getattr(request, "priority", 0)
        self.preempts = 0  # times this ticket's row was preempted
        self.resumed = False
        # Tenant usage accounting: flipped by the FIRST
        # terminal accounting of this ticket so retry/reap races can
        # never bill a tenant twice for one request.
        self.accounted = False


class _TierQueue:
    """Drop-in for the scheduler's ``queue.Queue`` with PER-TIER FIFO
    order: ``get`` returns the oldest ticket of the HIGHEST
    waiting tier; arrival order is preserved within a tier, so equal
    traffic keeps today's FIFO semantics exactly. ``None`` — the
    shutdown sentinel — short-circuits ahead of tickets so a stopping
    scheduler never dispatches new work first (its queued tickets are
    failed by ``stop()``'s drains either way)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._tiers: Dict[int, deque] = {}
        self._control = 0  # queued None sentinels

    def put(self, item) -> None:
        with self._cond:
            if item is None:
                self._control += 1
            else:
                tier = getattr(item, "priority", 0)
                self._tiers.setdefault(tier, deque()).append(item)
            self._cond.notify()

    def _pop(self):
        # caller holds the condition lock; IndexError when empty
        if self._control:
            self._control -= 1
            return None
        for tier in sorted(self._tiers, reverse=True):
            q = self._tiers[tier]
            if q:
                return q.popleft()
        raise IndexError("empty")

    def get(self, timeout: Optional[float] = None):
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        with self._cond:
            while True:
                try:
                    return self._pop()
                except IndexError:
                    pass
                remaining = (
                    None
                    if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._cond.wait(remaining)

    def get_nowait(self):
        with self._cond:
            try:
                return self._pop()
            except IndexError:
                raise queue.Empty from None

    def qsize(self) -> int:
        with self._cond:
            return self._control + sum(
                len(q) for q in self._tiers.values()
            )

    def max_tier(self) -> Optional[int]:
        """Highest tier with a waiting ticket (None when no tickets) —
        the resume phase's anti-thrash probe: a victim does not swap
        back in under a strictly-higher-tier backlog that would preempt
        it again immediately."""
        with self._cond:
            waiting = [t for t, q in self._tiers.items() if q]
            return max(waiting) if waiting else None

    def depths(self) -> Dict[int, int]:
        """Per-tier queue depth snapshot for ``/debug/state``."""
        with self._cond:
            return {t: len(q) for t, q in sorted(self._tiers.items()) if q}


class _Parked:
    """One preempted victim waiting on the resume queue: its ticket,
    the engine's :class:`~..engine.stepped.PreemptedRow` capture, and
    the clocks the starvation-aging policy reads."""

    __slots__ = ("ticket", "pr", "t_parked", "base_tier")

    def __init__(self, ticket: _Ticket, pr) -> None:
        self.ticket = ticket
        self.pr = pr
        self.t_parked = time.monotonic()
        self.base_tier = ticket.priority


def _is_resume(pj) -> bool:
    """Whether a pending-join object is a preemption RESUME riding the
    chunked-join machinery (works for the engine's _PendingJoin and the
    fake backend's dict pendings alike)."""
    if isinstance(pj, dict):
        return pj.get("resume") is not None
    return getattr(pj, "resume", None) is not None


def _pr_field(pr, name: str, default=None):
    """Read a field off a PreemptedRow capture — the engine's object or
    the fake backend's dict twin."""
    if isinstance(pr, dict):
        return pr.get(name, default)
    return getattr(pr, name, default)


def _pr_add_wasted(pr, joules: float) -> None:
    """Mirror a preemption charge onto the parked ROW's attribution
    account: the figure rides the park and surfaces in the
    row's ``energy_model["wasted_J"]`` close-out. Informational — the
    authoritative per-cause billing stays on the ticket's ledger."""
    if not joules or pr is None:
        return
    if isinstance(pr, dict):  # fake backend's dict twin parks the row
        row = pr.get("row")
        if isinstance(row, dict):
            row["attr_wasted_J"] = row.get("attr_wasted_J", 0.0) + joules
    elif hasattr(pr, "attr_wasted_J"):
        pr.attr_wasted_J += joules


def _account_ticket(ticket: "_Ticket", outcome: str, result=None) -> None:
    """Tenant usage accounting: every terminal ticket lands
    in ``obs.tenants`` EXACTLY ONCE, from the scheduler's two funnels
    (_finish_ticket / _fail_ticket). The completed path bills the
    slice-attributed ``energy_model["J"]``; failures bill streamed
    tokens only. Never raises, no-op under the kill switch."""
    if ticket.accounted or not _obs_enabled():
        return
    ticket.accounted = True
    try:
        req = ticket.request
        tokens_in = tokens_out = 0
        joules = 0.0
        wasted = dict(ticket.wasted) if ticket.wasted else {}
        if result is not None:
            tokens_in = int(result.prompt_tokens or 0)
            tokens_out = int(result.generated_tokens or 0)
            extras = result.extras or {}
            em = extras.get("energy_model") or {}
            joules = float(em.get("J") or 0.0)
            # fully-rejected draft rounds: already on the process-wide
            # wasted ledger (cause=draft); mirrored into the owning
            # tenant's account here
            dw = (extras.get("spec") or {}).get("draft_wasted_J")
            if dw:
                wasted["draft"] = wasted.get("draft", 0.0) + float(dw)
        elif ticket.stream is not None and ticket.stream.tokens_pushed:
            tokens_out = int(ticket.stream.tokens_pushed)
        account_request(
            getattr(req, "tenant", None),
            outcome,
            tokens_in=tokens_in,
            tokens_out=tokens_out,
            joules=joules,
            wasted=wasted or None,
            model=getattr(req, "model", None),
            trace=trace_attrs(ticket.span).get("trace"),
        )
    except Exception:  # noqa: BLE001 — telemetry only
        pass


class _SchedulerBase:
    """Submit/lifecycle machinery shared by the window and continuous
    schedulers (one queue, one worker thread, shutdown that can never
    strand a caller on ``event.wait()``).

    ``max_batch`` bounds a single decode's row count; the default is
    BACKEND-AWARE: 32 (the engine's known-safe sub-batch floor) for
    backends with a real batched decode, 8 for backends inheriting the
    base class's sequential ``generate_batch`` loop (fake backend),
    where a wider batch only multiplies every caller's wait.

    Admission is additionally BUDGET-AWARE on backends that expose
    ``max_admission_rows`` (the widest batch bucket whose estimated K+V
    footprint fits ``BATCH_KV_BUDGET_BYTES`` under the engine's cache
    layout): each dispatch's cap is the LARGER of ``max_batch`` and that
    estimate. Denser cache layouts therefore admit more concurrent
    callers at the same device budget — paged+int8 serving admits the
    2–4× fleet its pages pay for.
    ``budget_aware=False`` opts out (fixed-cap behavior).
    """

    def __init__(
        self,
        backend: GenerationBackend,
        max_batch: Optional[int] = None,
        window_s: float = 0.05,
        lock: Optional[threading.Lock] = None,
        budget_aware: Optional[bool] = None,
        ttft_slo_ms: Optional[float] = None,
    ) -> None:
        self.backend = backend
        # Server-wide TTFT SLO (`serve --ttft-slo-ms`): a queued ticket
        # whose wait alone already exceeds it is rejected before
        # admission — enforcing the SLO instead of merely histogramming
        # its violations. None = no SLO.
        self.ttft_slo_ms = ttft_slo_ms
        if max_batch is None:
            batched = (
                type(backend).generate_batch
                is not GenerationBackend.generate_batch
            )
            max_batch = 32 if batched else 8
        self.max_batch = max_batch
        if budget_aware is None:  # auto: on when the backend can estimate
            budget_aware = hasattr(backend, "max_admission_rows")
        self.budget_aware = bool(
            budget_aware and hasattr(backend, "max_admission_rows")
        )
        # Device-memory envelope split: the fraction of the engine's
        # KV budget THIS scheduler's sessions may claim. 1.0 = the
        # whole envelope (single-model serving); a multi-model fleet
        # (serve/model_fleet.py) divides it across its live per-model
        # lanes so N concurrent sessions' pools bill the same device
        # memory the single session used to own alone.
        self.kv_budget_frac = 1.0
        self.window_s = window_s
        # Shared with the server's streaming path so batched and streamed
        # generations never run concurrently on one accelerator.
        self._backend_lock = lock if lock is not None else threading.Lock()
        # Per-tier FIFO: higher-priority tickets dispatch
        # first; within a tier, arrival order — with one tier in play
        # (the default) this is exactly the old FIFO queue.
        self._queue: "_TierQueue" = _TierQueue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # Serialises submit() against stop() so a ticket can never be
        # enqueued after the shutdown drain (which would strand its caller
        # on event.wait() forever).
        self._state_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(
            target=self._bound_loop, name="batch-scheduler", daemon=True
        )
        self._thread.start()

    def _bound_loop(self) -> None:
        """The worker thread: binds the backend's device first (a CUDA
        engine's card becomes this thread's current device, so that every
        launch from here lands on its one stream), then runs the loop."""
        bind = getattr(self.backend, "bind_thread", None)
        if bind is not None:
            bind()
        self._loop()

    def stop(self, timeout_s: float = 30.0) -> None:
        with self._state_lock:
            if not self._running:
                return
            self._running = False
            self._queue.put(None)  # wake the loop
            thread, self._thread = self._thread, None
        # Join outside the state lock (new submits are already excluded by
        # _running=False) and drain between join attempts: a batch still
        # executing across the shutdown could otherwise re-queue
        # incompatible leftovers *after* a single premature drain, stranding
        # their submit() callers on event.wait() forever. The join is
        # bounded (a wedged backend must not hang server shutdown — the
        # worker is a daemon thread); the post-shutdown stranding case is
        # closed independently by the requeue helper, which fails leftovers
        # instead of re-queuing them once _running is False.
        deadline = time.monotonic() + timeout_s
        while (
            thread is not None
            and thread.is_alive()
            and time.monotonic() < deadline
        ):
            thread.join(timeout=1.0)
            self._fail_queued()
        self._fail_queued()

    @staticmethod
    def _fail_ticket(ticket: _Ticket, exc: BaseException) -> None:
        """Fail one ticket: the blocking caller unblocks with the error
        and a streaming consumer receives it as the terminal event."""
        if isinstance(exc, StreamCancelled):
            _account_ticket(ticket, "cancelled")
        elif isinstance(exc, DeadlineExceeded):
            _account_ticket(ticket, "deadline")
        else:
            _account_ticket(ticket, "error")
        ticket.error = exc
        if ticket.stream is not None:
            ticket.stream.fail(exc)
        ticket.event.set()

    def _fail_queued(self) -> None:
        """Fail every queued ticket so its caller unblocks (shutdown only)."""
        while True:
            try:
                ticket = self._queue.get_nowait()
            except queue.Empty:
                return
            if ticket is not None:
                self._fail_ticket(ticket, RuntimeError("server shutting down"))

    def _requeue(self, ticket: _Ticket) -> None:
        """Put an undispatched ticket back. Under the state lock so the
        re-queue cannot interleave with stop() flipping _running: either
        the ticket lands in the queue before the flip (stop()'s drains run
        after and fail it) or it is failed directly here — no window where
        it is re-queued after the final drain and stranded."""
        with self._state_lock:
            if self._running:
                self._queue.put(ticket)
            else:
                self._fail_ticket(ticket, RuntimeError("server shutting down"))

    # -- client side ----------------------------------------------------------
    def submit(self, request: GenerationRequest) -> GenerationResult:
        """Enqueue and block until the scheduler served the request."""
        ticket = _Ticket(request)
        _REQUESTS_C.inc()
        with self._state_lock:
            if not self._running:
                raise RuntimeError("scheduler is not running")
            self._queue.put(ticket)
        _QUEUE_DEPTH_G.set(self._queue.qsize())
        ticket.event.wait()
        if ticket.error is not None:
            raise ticket.error
        assert ticket.result is not None
        return ticket.result

    def submit_stream(self, request: GenerationRequest) -> TokenStream:
        """Enqueue a STREAMING request and return its egress channel
        immediately (non-blocking — the consumer iterates
        ``channel.events()``). Under continuous dispatch the scheduler
        pushes each decode slice's new tokens as delta events; under
        window dispatch the stream degenerates to the single final
        event. The final event carries the full result, extras riding
        along; every failure path ends the channel with a terminal
        error. ``channel.cancel()`` — explicit, or by the server on an
        SSE write failure — retires the row within one decode slice
        (``reason="cancelled"``, pages back to the pool)."""
        ticket = _Ticket(request)
        ticket.stream = open_stream()
        _REQUESTS_C.inc()
        with self._state_lock:
            if not self._running:
                raise RuntimeError("scheduler is not running")
            self._queue.put(ticket)
        _QUEUE_DEPTH_G.set(self._queue.qsize())
        return ticket.stream

    # -- introspection --------------------------------------------------------
    def health_state(self) -> Dict[str, object]:
        """CHEAP liveness surface for ``GET /healthz`` and the router's
        probe: scheduler kind, whether the loop is running,
        queue depth and in-flight rows. No telemetry dependency — it
        must answer under the obs kill switch — and best-effort like
        :meth:`debug_state` (a torn read costs a stale count, never an
        exception). ``max_admission_rows`` is the LIVE admission
        headroom (fleet-wide admission): how many more rows
        this scheduler can take right now — the router consults the
        probed value BEFORE dispatching instead of bouncing a request
        off a full replica."""
        queue = self._queue.qsize()
        return {
            "scheduler": "window",
            "running": self._running,
            "queue_depth": queue,
            "inflight_rows": 0,
            "max_admission_rows": max(0, int(self.max_batch) - queue),
        }

    def debug_state(self) -> Dict[str, object]:
        """Live snapshot for ``GET /debug/state``: what the scheduler is
        doing RIGHT NOW. Best-effort — it races the worker loop by
        design (forensic reads must not take the dispatch locks) — and
        every field is plain data, safe to JSON-serialise."""
        return {
            "mode": "window",
            "running": self._running,
            "queue_depth": self._queue.qsize(),
            "queue_tiers": self._queue.depths(),
            "max_batch": self.max_batch,
            "budget_aware": self.budget_aware,
            "kv_budget_frac": self.kv_budget_frac,
            "window_s": self.window_s,
            "ttft_slo_ms": self.ttft_slo_ms,
        }

    # -- shared dispatch helpers ----------------------------------------------
    @staticmethod
    def _compatible(a: GenerationRequest, b: GenerationRequest) -> bool:
        return a.model == b.model and a.top_k == b.top_k

    def _admission_cap(self, first: _Ticket) -> int:
        """Row cap for the batch/session ``first`` anchors (or joins): the
        static ``max_batch``, raised to the backend's budget-based
        estimate when it can provide one (see the class docstring). A
        probe failure (unknown model, bad prompt) falls back to the
        static cap — admission must never fail a request the backend
        would serve. Under a multi-model fleet the cap is additionally
        scaled by ``kv_budget_frac`` (this lane's share of the engine's
        KV envelope), floored at one row so a lane can always serve."""
        if not self.budget_aware:
            _BUDGET_ADMISSION_C.labels(outcome="static").inc()
            return self._split_cap(self.max_batch)
        try:
            estimated = self.backend.max_admission_rows(first.request)
        except Exception:  # noqa: BLE001 — estimate only, never fatal
            _BUDGET_ADMISSION_C.labels(outcome="error").inc()
            return self._split_cap(self.max_batch)
        raised = int(estimated) > self.max_batch
        _BUDGET_ADMISSION_C.labels(
            outcome="raised" if raised else "static"
        ).inc()
        return self._split_cap(max(self.max_batch, int(estimated)))

    def _split_cap(self, cap: int) -> int:
        frac = self.kv_budget_frac
        if frac >= 1.0:
            return cap
        return max(1, int(cap * frac))

    def _preadmit_reject(
        self, ticket: _Ticket, now: Optional[float] = None
    ) -> bool:
        """The deadline/SLO gate at the ADMISSION EDGE: a queued ticket
        whose own ``deadline_ms`` already passed — or whose queue wait
        alone exceeds the server-wide TTFT SLO — fails cleanly before
        any prefill is paid (the cheapest possible place to shed load a
        caller has already given up on). Returns True when the ticket
        was rejected (and its caller already failed)."""
        request = ticket.request
        if request.deadline_ms is None and self.ttft_slo_ms is None:
            return False
        now = time.monotonic() if now is None else now
        wait = now - ticket.t_submit
        if (
            request.deadline_ms is not None
            and wait > request.deadline_ms / 1e3
        ):
            reason, bound_ms = "deadline", request.deadline_ms
        elif self.ttft_slo_ms is not None and wait > self.ttft_slo_ms / 1e3:
            reason, bound_ms = "ttft_slo", self.ttft_slo_ms
        else:
            return False
        _DEADLINE_REJECTED_C.labels(reason=reason).inc()
        FLIGHT.emit(
            EV_REQUEST_REJECTED,
            reason=reason,
            wait_s=round(wait, 4),
            **trace_attrs(
                ticket.span, tenant=getattr(request, "tenant", None)
            ),
        )
        # admission-edge refusal: its own tenant outcome, distinct from
        # a mid-flight deadline (_fail_ticket sees accounted already)
        _account_ticket(ticket, "rejected")
        self._fail_ticket(
            ticket,
            DeadlineExceeded(
                f"queued {wait * 1e3:.0f} ms, past the "
                f"{'request deadline_ms' if reason == 'deadline' else 'server TTFT SLO'}"
                f" of {bound_ms:g} ms"
            ),
        )
        return True

    def _finish_ticket(
        self,
        ticket: _Ticket,
        result: GenerationResult,
        now: Optional[float] = None,
    ) -> None:
        """Complete one ticket: latency attribution (TTFT + completion
        histograms, mirrored into ``extras["sched"]`` so bench/load
        tools read per-request figures off the wire) then unblock the
        caller."""
        now = time.monotonic() if now is None else now
        completion_s = now - ticket.t_submit
        if ticket.t_first is not None:
            ttft_s = ticket.t_first - ticket.t_submit
        else:
            # window dispatch: the first token existed once the shared
            # decode window opened — completion minus that window is the
            # earliest the result could have carried it. The recorded
            # queue wait is subtracted too: it previously folded into
            # this estimate (satellite), skewing the window
            # histogram against the continuous one on the same scrape;
            # the queue component stays visible on its own family
            # (llm_sched_queue_wait_seconds).
            ttft_s = max(
                0.0,
                completion_s
                - result.decode_s
                - (ticket.queue_wait_s or 0.0),
            )
        _TTFT_H.observe(ttft_s)
        _COMPLETION_H.observe(completion_s)
        sched_extras = {
            "ttft_s": round(ttft_s, 6),
            "completion_s": round(completion_s, 6),
        }
        if ticket.joined:
            # mid-flight admission attribution: the TTFT above spans the
            # whole chunked prefill (queue → last chunk → first token)
            sched_extras["joined"] = True
            sched_extras["join_chunks"] = ticket.join_chunks
        if ticket.preempts:
            # SLO-tier attribution: this row was preempted
            # mid-flight and completed after resume — the bench's
            # resumed-row parity check reads these off the wire
            sched_extras["preempted"] = ticket.preempts
            sched_extras["resumed"] = ticket.resumed
            sched_extras["tier"] = ticket.priority
        if ticket.migrated:
            # live-migration attribution: this row was seated from
            # another server's exported bundle
            sched_extras["migrated"] = True
        result.extras = {
            **(result.extras or {}),
            "sched": sched_extras,
        }
        if ticket.wasted:
            # wasted-energy attribution: the Joules this
            # request burned that no response benefits from, by cause —
            # the per-request twin of llm_request_wasted_joules_total
            # (the router adds its retry charge to the same block)
            energy = dict(result.extras.get("energy") or {})
            wasted = dict(energy.get("wasted_J") or {})
            for cause, joules in ticket.wasted.items():
                wasted[cause] = round(
                    wasted.get(cause, 0.0) + joules, 6
                )
            energy["wasted_J"] = wasted
            result.extras["energy"] = energy
        _account_ticket(ticket, "ok", result)
        ticket.result = result
        if ticket.stream is not None:
            # the final egress event carries the COMPLETE wire result —
            # extras (sched attribution, energy payload) included
            ticket.stream.finish(result)
        ticket.event.set()

    def _dispatch_isolated(self, tickets: "List[_Ticket]") -> None:
        """Salvage a failed batch dispatch by BISECTION instead of a
        serial per-ticket sweep: each recursive half retries as one
        batch, so a single pathological request is isolated in O(log n)
        batch calls and its companions keep batched latency instead of
        queueing behind a one-by-one retry under the backend lock. Each
        failed batch call increments ``llm_sched_batch_fallback_total``;
        per-ticket errors fan out only to their own caller."""
        if not tickets:
            return
        if len(tickets) == 1:
            ticket = tickets[0]
            try:
                with TRACER.attach(ticket.span), self._backend_lock:
                    result = self.backend.generate(ticket.request)
            except BaseException as exc:  # noqa: BLE001
                self._fail_ticket(ticket, exc)
            else:
                self._finish_ticket(ticket, result)
            return
        try:
            with TRACER.attach(tickets[0].span), self._backend_lock:
                results = self.backend.generate_batch(
                    [t.request for t in tickets]
                )
        except BaseException:  # noqa: BLE001
            _BATCH_FALLBACK_C.inc()
            FLIGHT.emit(
                EV_BATCH_FALLBACK,
                rows=len(tickets),
                stage="bisect",
                **trace_attrs(tickets[0].span),
            )
            mid = len(tickets) // 2
            self._dispatch_isolated(tickets[:mid])
            self._dispatch_isolated(tickets[mid:])
        else:
            now = time.monotonic()
            for ticket, result in zip(tickets, results):
                self._finish_ticket(ticket, result, now)

    def _loop(self) -> None:  # pragma: no cover — subclasses implement
        raise NotImplementedError


class BatchScheduler(_SchedulerBase):
    """WINDOW dispatch: coalesce concurrent generate calls into batched
    backend calls run to completion.

    ``window_s`` is how long the first request of a batch waits for
    companions (the classic admission window — ``serve --window-ms``);
    requests that are mutually incompatible (different model or top_k)
    run as separate batches in arrival order. See :class:`_SchedulerBase`
    for the cap/budget-admission semantics shared with the continuous
    scheduler.
    """

    def _collect(self, first: _Ticket) -> List[_Ticket]:
        """Admission: wait up to ``window_s`` for companions compatible with
        ``first``; incompatible arrivals are re-queued (order within each
        compatibility class is preserved)."""
        batch = [first]
        leftovers: List[_Ticket] = []
        t_collect = time.monotonic()
        cap = self._admission_cap(first)
        _ADMISSION_CAP_H.observe(cap)
        deadline = time.monotonic() + self.window_s
        while len(batch) < cap:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                ticket = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if ticket is None:  # shutdown sentinel — put back and stop
                self._queue.put(None)
                break
            if self._compatible(first.request, ticket.request):
                batch.append(ticket)
            else:
                leftovers.append(ticket)
        # Observe at the collection break, BEFORE the leftover re-queue
        # loop: each re-queue takes the state lock, and a stop() racing
        # those acquisitions would inflate the histogram with lock
        # contention that is not collection time.
        _COLLECT_H.observe(time.monotonic() - t_collect)
        for ticket in leftovers:
            self._requeue(ticket)
        return batch

    def _loop(self) -> None:
        while self._running:
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                _QUEUE_DEPTH_G.set(self._queue.qsize())
                continue
            if first is None:
                break
            _QUEUE_DEPTH_G.set(self._queue.qsize())
            batch = self._collect(first)
            # Deadline/SLO gate at the dispatch edge: tickets that can
            # no longer meet their bound fail here instead of burning a
            # shared decode on work the caller has abandoned.
            batch = [t for t in batch if not self._preadmit_reject(t)]
            if not batch:
                continue
            # Queue accounting at dispatch: each ticket's wait (its own
            # submit clock) plus a "queue" span parented under ITS OWN
            # request root — the span tree survives the thread hop.
            t_dispatch = time.monotonic()
            for ticket in batch:
                ticket.queue_wait_s = t_dispatch - ticket.t_submit
                _QUEUE_WAIT_H.observe(ticket.queue_wait_s)
                TRACER.add_span(
                    "queue", ticket.t_submit, t_dispatch,
                    attrs={"batch_rows": len(batch)}, parent=ticket.span,
                )
            _BATCH_ROWS_H.observe(len(batch))
            _BATCHES_C.inc()
            if _obs_enabled():
                for ticket in batch:
                    FLIGHT.emit(
                        EV_REQUEST_ADMITTED,
                        mode="window",
                        rows=len(batch),
                        model=ticket.request.model,
                        queue_wait_s=round(ticket.queue_wait_s or 0.0, 6),
                        **trace_attrs(ticket.span),
                    )
            try:
                # Backend spans (prefill/decode) emitted on THIS thread
                # parent under the anchor request's root via attach().
                with TRACER.attach(batch[0].span), self._backend_lock:
                    if len(batch) == 1:
                        results = [self.backend.generate(batch[0].request)]
                    else:
                        results = self.backend.generate_batch(
                            [t.request for t in batch]
                        )
            except BaseException as exc:  # noqa: BLE001
                if len(batch) == 1:
                    self._fail_ticket(batch[0], exc)
                else:
                    # A batch-level failure (e.g. the combined KV footprint
                    # exceeding max_seq_len) must not 500 callers whose
                    # requests are individually fine — and must not poison
                    # every companion's latency with a serial one-by-one
                    # sweep either: bisect to isolate the failing ticket
                    # (see _dispatch_isolated).
                    _BATCH_FALLBACK_C.inc()
                    FLIGHT.emit(
                        EV_BATCH_FALLBACK,
                        rows=len(batch),
                        stage="batch",
                        error=f"{type(exc).__name__}: {exc}",
                        **trace_attrs(batch[0].span),
                    )
                    # forensics BEFORE the salvage mutates anything: the
                    # last events + live scheduler state, next to the
                    # span trace (TPU_LLM_CRASH_DIR)
                    FLIGHT.crash_dump(
                        f"window batch dispatch failed: "
                        f"{type(exc).__name__}: {exc}",
                        state=self.debug_state(),
                    )
                    mid = len(batch) // 2
                    self._dispatch_isolated(batch[:mid])
                    self._dispatch_isolated(batch[mid:])
            else:
                now = time.monotonic()
                for ticket, result in zip(batch, results):
                    self._finish_ticket(ticket, result, now)


class ContinuousScheduler(_SchedulerBase):
    """ITERATION-LEVEL dispatch over the backend's stepped-decode
    protocol (see the module docstring and engine/stepped.py).

    The loop phases per session:

    - **admit**: an anchor ticket opens a session immediately (no
      admission window — TTFT is the point) together with any compatible
      tickets already queued, up to the budget-aware cap;
    - **step**: one bounded decode slice (``slice_steps``) under the
      backend lock, then control returns here;
    - **retire**: rows whose done-mask set complete their tickets NOW —
      not at batch end — and free their rows (and pool pages) for
      joiners;
    - **join**: queued compatible requests enter freed rows, with the
      budget-aware cap re-evaluated at each admission. By default joins
      are CHUNKED (``chunked_joins``): admission reserves the slot
      (``session.join_begin``) and the joiner's prompt prefill then
      streams in as token-budgeted chunks — AT MOST ONE chunk (at most
      ``prefill_chunk_tokens`` prompt tokens) between two decode slices,
      multiple pending joiners progressed round-robin — so in-flight
      rows' stall per slice is bounded by the chunk budget instead of
      the joiner's prompt length (the Sarathi-Serve chunked-prefill
      argument applied to mid-flight admission). The joiner's row only
      enters decode at ``join_commit`` (first token sampled there; TTFT
      spans all its chunks). ``chunked_joins=False`` restores the
      synchronous one-shot join (the whole prompt prefills between two
      slices — the pre-behavior the chunked_join bench A/Bs
      against).

    Two more phases ride the same loop:

    - **egress**: after every slice, each STREAMING row's new tokens
      push into its per-request channel (serve/stream.py) — the
      producer side of SSE delivery; a retiring row's tail deltas
      precede its final event;
    - **reap**: between every two slices, rows whose stream was
      cancelled (client disconnect / explicit / backpressure) or whose
      ``deadline_ms`` passed retire NOW via ``session.cancel`` — pages
      recycled mid-flight, ticket failed cleanly
      (``retired{reason=cancelled|deadline}``). Queued tickets past
      their deadline — or past the server-wide ``ttft_slo_ms`` — are
      rejected BEFORE admission instead.

    Incompatible arrivals re-queue and anchor their own session once this
    one drains (same FIFO-per-compatibility-class rule as the window
    scheduler; under a saturating stream of compatible traffic an
    incompatible request can wait for the session to drain — the known
    trade of model-affine continuous batching).
    """

    def __init__(
        self,
        backend: GenerationBackend,
        max_batch: Optional[int] = None,
        window_s: float = 0.05,
        lock: Optional[threading.Lock] = None,
        budget_aware: Optional[bool] = None,
        slice_steps: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = None,
        chunked_joins: bool = True,
        ttft_slo_ms: Optional[float] = None,
        spec_accept_floor: Optional[float] = None,
        preempt_policy: str = "swap",
        preempt_max_wait_s: float = 30.0,
    ) -> None:
        super().__init__(
            backend,
            max_batch=max_batch,
            window_s=window_s,
            lock=lock,
            budget_aware=budget_aware,
            ttft_slo_ms=ttft_slo_ms,
        )
        # Speculative auto-fallback floor (`serve --spec-accept-floor`): forwarded
        # to every session open — a speculating
        # session whose rolling measured acceptance drops below it falls
        # back to plain decode mid-flight. None = the backend's default.
        self.spec_accept_floor = spec_accept_floor
        if not hasattr(backend, "decode_open"):
            raise ValueError(
                f"{type(backend).__name__} has no stepped-decode support "
                "(decode_open); use BatchScheduler"
            )
        if slice_steps is None:
            from ..engine.torch_engine import DECODE_SLICE_STEPS

            slice_steps = DECODE_SLICE_STEPS
        self.slice_steps = max(1, int(slice_steps))
        # None = the backend's auto default (engine:
        # JOIN_PREFILL_CHUNK_TOKENS, env PREFILL_CHUNK_TOKENS); the
        # serve CLI's --prefill-chunk-tokens lands here.
        self.prefill_chunk_tokens = (
            max(1, int(prefill_chunk_tokens))
            if prefill_chunk_tokens
            else None
        )
        self.chunked_joins = bool(chunked_joins)
        # SLO tiers + mid-flight preemption. ``off`` disables
        # preemption entirely (shed-at-the-edge only — the pre-preemption
        # behavior and the bench's baseline arm); ``swap`` spills the
        # victim's KV to host memory and restores it at resume;
        # ``recompute`` drops the KV and re-prefills prompt + generated
        # tokens through the chunked-join machinery (the contiguous
        # session: a paged one keeps a row's generated K/V in its side
        # caches and refuses, so its rows keep running). With one
        # priority tier in play nothing ever preempts, so "swap" is safe
        # as the default. ``preempt_max_wait_s`` is the
        # starvation-protection clock: a parked victim ages up one tier
        # per full wait (0 disables aging).
        if preempt_policy not in ("off", "swap", "recompute"):
            raise ValueError(
                f"preempt_policy must be 'off', 'swap' or 'recompute', "
                f"got {preempt_policy!r}"
            )
        self.preempt_policy = preempt_policy
        self.preempt_max_wait_s = float(preempt_max_wait_s or 0.0)
        # Optional fine-grained probe for benches: called with
        # (gap_seconds, live_rows) for every gap between two consecutive
        # decode-slice completions that live rows sat through — the
        # inter-token arrival gap an in-flight caller experiences,
        # including any join work the scheduler did in between. The
        # /metrics twin is llm_sched_decode_stall_seconds (join work
        # only, bucketed).
        self.slice_gap_sink = None
        # Live-session reference for debug_state(): (session, live,
        # pending) while a session runs, None when idle. Read
        # best-effort by the /debug/state endpoint — never locked.
        self._dbg = None
        # Pending drain-evacuation request: set by evacuate() from ANY
        # thread, consumed by the loop thread's _evac_sweep between two
        # decode slices (the loop thread owns all session state —
        # evacuate never touches it directly).
        self._evac_req: Optional[dict] = None
    def health_state(self) -> Dict[str, object]:
        """The base liveness fields plus the continuous loop's in-flight
        row count (live rows + pending chunked joiners — what a router's
        least-queue policy should weigh next to the queue depth)."""
        state = super().health_state()
        state["scheduler"] = "continuous"
        dbg = self._dbg
        if dbg is not None:
            session, live, pending, parked = dbg
            try:
                state["inflight_rows"] = (
                    len(live) + len(pending) + len(parked)
                )
                # LIVE headroom: the running session's free
                # row slots minus the queue already waiting for them —
                # sharper than the base max_batch-queue estimate
                state["max_admission_rows"] = max(
                    0, int(session.free_slots) - state["queue_depth"]
                )
            except Exception:  # noqa: BLE001 — racing the loop is fine
                pass
        return state

    def debug_state(self) -> Dict[str, object]:
        """The window snapshot plus the live continuous session: in-
        flight rows with ages/token counts, pending joiners with chunk
        progress, and (paged) pool occupancy — the "which decisions is
        the scheduler making RIGHT NOW" surface. Racing the loop is
        fine; a torn read costs a stale field, never an exception that
        escapes (the endpoint guards)."""
        state = super().debug_state()
        state["mode"] = "continuous"
        state["slice_steps"] = self.slice_steps
        state["chunked_joins"] = self.chunked_joins
        state["prefill_chunk_tokens"] = self.prefill_chunk_tokens
        state["spec_accept_floor"] = self.spec_accept_floor
        state["preempt_policy"] = self.preempt_policy
        state["preempt_max_wait_s"] = self.preempt_max_wait_s
        # Sharded serving: a TP backend reports its mesh here
        # so one /debug/state probe shows WHICH device topology the
        # continuous loop is driving (None on single-device backends —
        # the loop itself is device-count-agnostic).
        mesh_info = getattr(self.backend, "mesh_info", None)
        try:
            state["backend_mesh"] = (
                mesh_info() if callable(mesh_info) else None
            )
        except Exception:  # noqa: BLE001 — probe only
            state["backend_mesh"] = None
        # the ENGINE-owned prefix store rides the backend — a scheduler
        # restart builds a new loop over the same backend, so this block
        # (and the hits it promises) survives it
        try:
            store = getattr(self.backend, "prefix_store", None)
            if store is not None:
                state["prefix_store"] = store.debug_state()
        except Exception:  # noqa: BLE001 — probe only
            pass
        dbg = self._dbg
        if dbg is None:
            state["session"] = None
            return state
        session, live, pending, parked = dbg
        now = time.monotonic()
        try:
            state["session"] = session.debug_state()
        except Exception:  # noqa: BLE001 — snapshot raced close()
            state["session"] = None
        state["inflight"] = [
            {
                "model": t.request.model,
                "age_s": round(now - t.t_submit, 4),
                "max_new_tokens": t.request.max_new_tokens,
                "joined": t.joined,
                "tier": t.priority,
                "preempts": t.preempts,
                "streaming": t.stream is not None,
                "tokens_streamed": (
                    t.stream.tokens_pushed if t.stream is not None else 0
                ),
                "deadline_ms": t.request.deadline_ms,
                "trace": trace_of(t.span),
            }
            for t in list(live.values())
        ]
        state["pending_joins"] = [
            {
                "model": t.request.model,
                "age_s": round(now - t.t_submit, 4),
                "join_chunks_done": t.join_chunks,
                "trace": trace_of(t.span),
            }
            for t, _pj in list(pending)
        ]
        state["parked"] = [
            {
                "model": p.ticket.request.model,
                "tier": p.ticket.priority,
                "base_tier": p.base_tier,
                "policy": _pr_field(p.pr, "policy"),
                "parked_s": round(now - p.t_parked, 4),
                "host_bytes": _pr_field(p.pr, "host_bytes", 0),
                "generated_tokens": len(
                    _pr_field(p.pr, "generated", ()) or ()
                ),
                "trace": trace_of(p.ticket.span),
            }
            for p in list(parked)
        ]
        return state

    # -- live row migration (disaggregated prefill/decode) ----------------------
    def submit_prime(self, request: GenerationRequest) -> TokenStream:
        """Enqueue a PRIME request: the row runs its (chunked) prefill
        here, is then preempted and exported as a migrate bundle
        instead of decoding locally — the returned stream's FINAL event
        carries the bundle under ``extras["migrate"]`` and no token
        deltas are pushed meanwhile (the decode replica re-streams from
        token 0). When the row cannot export (spec-active session,
        shared prefix pages, engine refusing the capture) it decays to
        a NORMAL local stream — callers must handle a final event
        without the bundle; a prime is never dropped."""
        ticket = _Ticket(request)
        ticket.stream = open_stream()
        ticket.prime = True
        _REQUESTS_C.inc()
        with self._state_lock:
            if not self._running:
                raise RuntimeError("scheduler is not running")
            self._queue.put(ticket)
        _QUEUE_DEPTH_G.set(self._queue.qsize())
        return ticket.stream

    def submit_migrate(self, bundle: dict) -> TokenStream:
        """Seat another replica's exported row: deserialize ``bundle``
        (serve/migrate.py), enqueue a ticket that RESUMES it through
        ``resume_begin``/``_seat_row`` — no re-prefill — and return its
        egress stream; re-emitted deltas start at the bundle's streamed
        watermark, so a disagg prime streams from token 0 while a
        drain evacuation continues exactly at the client's cursor.
        Raises when the bundle cannot deserialize; a seating failure
        after that fails the returned stream instead (the router falls
        back to the source, counted ``migrate_failed``)."""
        from .migrate import bundle_nbytes, charge_transfer, import_bundle

        pr = import_bundle(bundle, self.backend)
        ticket = _Ticket(_pr_field(pr, "request"))
        ticket.stream = open_stream()
        ticket.migrate_pr = pr
        ticket.migrated = True
        nbytes = bundle_nbytes(bundle)
        observe_migrate("in", nbytes)
        # The port has no replica router yet, which charges each transfer
        # in the JAX package: the seating server charges the bundle it
        # takes, into the ledger and the ticket's wasted_J.
        joules = charge_transfer(bundle, str(bundle.get("reason") or "disagg"))
        if joules:
            ticket.wasted["migration"] = joules
        FLIGHT.emit(
            EV_ROW_MIGRATED,
            direction="in",
            reason=bundle.get("reason"),
            src=bundle.get("src"),
            dst=bundle.get("dst"),
            nbytes=nbytes,
            **trace_attrs(ticket.span),
        )
        _REQUESTS_C.inc()
        with self._state_lock:
            if not self._running:
                raise RuntimeError("scheduler is not running")
            self._queue.put(ticket)
        _QUEUE_DEPTH_G.set(self._queue.qsize())
        return ticket.stream

    def evacuate(self, timeout_s: float = 30.0) -> int:
        """Drain evacuation: ask the LOOP THREAD (which owns all
        session state) to preempt + export every live STREAMING row as
        a migrate bundle — each affected ticket's stream ends with
        ``extras["migrate"]`` + ``extras["evacuated"]``, which the
        router's relay splices onto a surviving replica mid-stream.
        Returns the number of rows evacuated (0 when idle). Buffered
        (non-streaming) rows, joiners mid-prefill and parked victims
        wait out instead — there is no live relay to splice them into."""
        req = {"event": threading.Event(), "count": 0}
        self._evac_req = req
        try:
            deadline = time.monotonic() + timeout_s
            while not req["event"].is_set():
                if self._dbg is None:  # idle — nothing live to move
                    return 0
                if time.monotonic() >= deadline:
                    return 0
                req["event"].wait(0.05)
            return int(req["count"])
        finally:
            self._evac_req = None

    def _session_exportable(self, session) -> bool:
        """Speculating sessions never export rows: draft cache layout
        and rng discipline are properties of the SOURCE engine's draft
        config, not of the row (real sessions carry ``spec``, the fake
        twin ``spec_active``)."""
        return (
            getattr(session, "spec", None) is None
            and not getattr(session, "spec_active", False)
        )

    def _export_row(self, session, ticket: _Ticket, reason: str):
        """Preempt ``ticket``'s live row and serialize it. Returns
        ``(pr, bundle)`` on success — with the SOURCE swap ledger
        settled (the bundle ships ``host_bytes=0``, see
        serve/migrate.py); ``(pr, None)`` when the row was captured but
        refused export (caller parks it for LOCAL resume — never
        dropped); ``(None, None)`` when the engine refused the capture
        itself (the row keeps running untouched)."""
        from .migrate import MigrateRefused, bundle_nbytes, export_bundle

        try:
            with self._backend_lock:
                pr = session.preempt(ticket.request, policy="swap")
        except Exception:  # noqa: BLE001 — engine refused the capture
            pr = None
        if pr is None:
            return None, None
        try:
            bundle = export_bundle(
                pr,
                reason=reason,
                streamed=0 if ticket.prime else None,
            )
        except MigrateRefused:
            return pr, None
        except Exception:  # noqa: BLE001 — serialization failure
            return pr, None
        try:
            with self._backend_lock:
                discard = getattr(session, "resume_discard", None)
                if discard is not None:
                    discard(pr)
        except Exception:  # noqa: BLE001 — ledger only
            pass
        nbytes = bundle_nbytes(bundle)
        observe_migrate("out", nbytes)
        FLIGHT.emit(
            EV_ROW_MIGRATED,
            direction="out",
            reason=reason,
            nbytes=nbytes,
            **trace_attrs(ticket.span),
        )
        return pr, bundle

    def _prime_fallback(self, ticket: _Ticket) -> None:
        """Decay a prime ticket to a normal local stream: buffered
        deltas flush to the consumer (stamping TTFT at the flush — the
        first moment the caller could see a token) and subsequent
        egress pushes directly."""
        ticket.prime = False
        buf, ticket.prime_buf = ticket.prime_buf, None
        if ticket.stream is None:
            return
        for text, tokens in buf or ():
            if (
                ticket.stream.push(text, tokens)
                and ticket.t_first is None
            ):
                ticket.t_first = ticket.stream.t_first_chunk

    def _finish_migrated(
        self, ticket: _Ticket, pr, bundle: dict, evacuated: bool
    ) -> None:
        """Complete an exported row's ticket: the stream's final event
        carries the bundle (and the ``evacuated`` marker for drain
        moves) — the router's relay consumes it instead of the client."""
        generated = _pr_field(pr, "generated", ()) or ()
        extras = {"migrate": bundle, "generated": len(generated)}
        if evacuated:
            extras["evacuated"] = True
        result = GenerationResult(
            request=ticket.request,
            tokens=[],
            text="",
            prompt_tokens=int(_pr_field(pr, "prompt_len", 0) or 0),
            generated_tokens=0,
            prefill_s=float(bundle.get("prefill_s", 0.0)),
            decode_s=0.0,
            total_s=time.monotonic() - ticket.t_submit,
            extras=extras,
        )
        _ROWS_RETIRED_C.labels(reason="migrated").inc()
        FLIGHT.emit(
            EV_ROW_RETIRED,
            reason="migrated",
            generated_tokens=len(generated),
            **trace_attrs(ticket.span),
        )
        self._finish_ticket(ticket, result)

    def _prime_sweep(
        self, session, live: Dict[int, _Ticket], parked: "List[_Parked]"
    ) -> None:
        """PRIME phase: a prime ticket whose row is LIVE has finished
        its prefill — preempt + export it now, before the next decode
        slice advances it here. Every refusal decays the ticket to a
        normal local stream (see submit_prime)."""
        for ticket in list(live.values()):
            if not ticket.prime:
                continue
            if not self._session_exportable(session):
                self._prime_fallback(ticket)
                continue
            pr, bundle = self._export_row(session, ticket, "disagg")
            if pr is None:
                # the engine refused the capture (recompute-only shape,
                # overflow) — that will not change next slice: decay
                self._prime_fallback(ticket)
                continue
            live.pop(id(ticket.request), None)
            if bundle is None:
                # captured but not exportable (shared prefix run): park
                # for LOCAL resume — the stream continues here
                ticket.preempts += 1
                _PREEMPTED_C.labels(policy="swap").inc()
                self._prime_fallback(ticket)
                parked.append(_Parked(ticket, pr))
                _PARKED_G.set(len(parked))
                continue
            self._finish_migrated(ticket, pr, bundle, evacuated=False)

    def _evac_sweep(
        self, session, live: Dict[int, _Ticket], parked: "List[_Parked]"
    ) -> None:
        """Serve a pending evacuate() request (loop thread only): every
        live STREAMING row exports as a drain bundle; a row captured
        but refused export parks for local resume (wait-out)."""
        req = self._evac_req
        if req is None or req["event"].is_set():
            return
        count = 0
        if self._session_exportable(session):
            for ticket in list(live.values()):
                if ticket.stream is None:
                    continue  # buffered caller — no relay to splice
                pr, bundle = self._export_row(session, ticket, "drain")
                if pr is None:
                    continue
                live.pop(id(ticket.request), None)
                if bundle is None:
                    ticket.preempts += 1
                    _PREEMPTED_C.labels(policy="swap").inc()
                    if ticket.prime:
                        self._prime_fallback(ticket)
                    parked.append(_Parked(ticket, pr))
                    _PARKED_G.set(len(parked))
                    continue
                count += 1
                self._finish_migrated(ticket, pr, bundle, evacuated=True)
        req["count"] = count
        req["event"].set()

    def _loop(self) -> None:
        while self._running:
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                _QUEUE_DEPTH_G.set(self._queue.qsize())
                continue
            if first is None:
                break
            _QUEUE_DEPTH_G.set(self._queue.qsize())
            if self._preadmit_reject(first):
                continue
            if first.migrate_pr is not None:
                self._run_migrate(first)
            else:
                self._run_session(first)
        _INFLIGHT_G.set(0)

    def _drain_compatible(
        self, anchor: GenerationRequest, limit: int
    ) -> List[_Ticket]:
        """Non-blocking pull of queued tickets compatible with ``anchor``
        (bounded by the queue's current size so re-queued incompatible
        tickets cannot spin this loop forever). Expired tickets
        (deadline/TTFT-SLO) fail here instead of entering the session."""
        got: List[_Ticket] = []
        for _ in range(self._queue.qsize()):
            if len(got) >= limit:
                break
            try:
                ticket = self._queue.get_nowait()
            except queue.Empty:
                break
            if ticket is None:
                self._queue.put(None)
                break
            if self._preadmit_reject(ticket):
                continue
            if ticket.migrate_pr is not None:
                # a migrate-in ticket never rides a session OPEN's request
                # list (its prefill already happened on the source server):
                # it seats mid-session via _admit_into's resume branch or
                # anchors _run_migrate
                self._requeue(ticket)
                continue
            if self._compatible(anchor, ticket.request):
                got.append(ticket)
            else:
                self._requeue(ticket)
        return got

    def _run_session(self, first: _Ticket) -> None:
        anchor = first.request
        cap = self._admission_cap(first)
        _ADMISSION_CAP_H.observe(cap)
        batch = [first] + self._drain_compatible(anchor, cap - 1)
        t_open = time.monotonic()
        for ticket in batch:
            ticket.queue_wait_s = t_open - ticket.t_submit
            _QUEUE_WAIT_H.observe(ticket.queue_wait_s)
            TRACER.add_span(
                "queue", ticket.t_submit, t_open,
                attrs={"batch_rows": len(batch)}, parent=ticket.span,
            )
        _BATCH_ROWS_H.observe(len(batch))
        _BATCHES_C.inc()
        # pass the spec floor only when configured: duck-typed stepped
        # backends predating the knob keep working unchanged
        open_kwargs = (
            {"spec_accept_floor": self.spec_accept_floor}
            if self.spec_accept_floor is not None
            else {}
        )
        try:
            with TRACER.attach(first.span), self._backend_lock:
                session = self.backend.decode_open(
                    [t.request for t in batch],
                    reserve_rows=min(cap, max(2 * len(batch), 4)),
                    slice_steps=self.slice_steps,
                    **open_kwargs,
                )
        except BaseException as exc:  # noqa: BLE001
            # a failed open (one bad prompt poisons the group) salvages
            # exactly like a failed window batch: bisected isolation
            if len(batch) == 1:
                self._fail_ticket(first, exc)
            else:
                _BATCH_FALLBACK_C.inc()
                mid = len(batch) // 2
                self._dispatch_isolated(batch[:mid])
                self._dispatch_isolated(batch[mid:])
            return
        live: Dict[int, _Ticket] = {}
        now = time.monotonic()
        for ticket in batch:
            if ticket.stream is None:
                # admission prefill done: token 1 exists. Streamed
                # tickets stamp t_first at their FIRST PUSHED CHUNK
                # instead (TTFT-at-first-chunk).
                ticket.t_first = now
            live[id(ticket.request)] = ticket
            FLIGHT.emit(
                EV_REQUEST_ADMITTED,
                mode="continuous",
                rows=len(batch),
                model=ticket.request.model,
                queue_wait_s=round(ticket.queue_wait_s or 0.0, 6),
                **trace_attrs(ticket.span),
            )
        # chunked joiners mid-prefill: (ticket, pending_join) in
        # round-robin order — _progress_joins advances the head one
        # chunk per loop iteration
        pending: "deque[tuple[_Ticket, object]]" = deque()
        # preemption victims parked for resume
        parked: "List[_Parked]" = []
        self._drive(first, session, live, pending, parked)

    def _run_migrate(self, first: _Ticket) -> None:
        """Anchor a session with a MIGRATED-IN row: open an
        idle session — no admission prefill, the row's KV arrives in
        the imported bundle — seat the row through ``resume_begin``
        (committing on the first interleave turn exactly like a local
        swap resume), then drive the standard loop. Backends whose
        ``decode_open`` refuses an empty request list (the real engine
        anchors its carry shapes on the first request) fail the ticket
        here; the JAX package's router counts ``migrate_failed`` and falls
        back to decoding on the source server. The port has no router
        yet: the client sees the failure and holds the bundle, which
        seats on any server with an open session."""
        pr = first.migrate_pr
        open_kwargs = (
            {"spec_accept_floor": self.spec_accept_floor}
            if self.spec_accept_floor is not None
            else {}
        )
        try:
            with TRACER.attach(first.span), self._backend_lock:
                session = self.backend.decode_open(
                    [],
                    reserve_rows=4,
                    slice_steps=self.slice_steps,
                    **open_kwargs,
                )
        except BaseException as exc:  # noqa: BLE001
            self._fail_ticket(first, exc)
            return
        try:
            with TRACER.attach(first.span), self._backend_lock:
                if not session.can_resume(pr):
                    raise RuntimeError(
                        "migrated row cannot seat here (no free "
                        "slot/pages or the bundle's resume plan is "
                        "incompatible with this session)"
                    )
                pj = session.resume_begin(pr, self.prefill_chunk_tokens)
        except BaseException as exc:  # noqa: BLE001
            try:
                with self._backend_lock:
                    session.close()
            except Exception:  # noqa: BLE001
                pass
            self._fail_ticket(first, exc)
            return
        _BATCHES_C.inc()
        now = time.monotonic()
        first.queue_wait_s = now - first.t_submit
        _QUEUE_WAIT_H.observe(first.queue_wait_s)
        TRACER.add_span(
            "queue", first.t_submit, now,
            attrs={"migrated": True}, parent=first.span,
        )
        FLIGHT.emit(
            EV_REQUEST_ADMITTED,
            mode="continuous",
            migrated=True,
            model=first.request.model,
            queue_wait_s=round(first.queue_wait_s or 0.0, 6),
            **trace_attrs(first.span),
        )
        live: Dict[int, _Ticket] = {}
        pending: "deque[tuple[_Ticket, object]]" = deque()
        parked: "List[_Parked]" = []
        pending.append((first, pj))
        self._drive(first, session, live, pending, parked)

    def _drive(
        self,
        first: _Ticket,
        session,
        live: Dict[int, _Ticket],
        pending: "deque",
        parked: "List[_Parked]",
    ) -> None:
        """The continuous loop proper — admit/step/retire/join/egress
        phases over an OPEN session (see the class docstring). Shared by
        :meth:`_run_session` (prefilled anchors) and :meth:`_run_migrate`
        (a seated import), plus the migration sweeps: primes export after
        their prefill, and a pending drain-evacuation request exports
        every live streaming row between two slices."""
        self._dbg = (session, live, pending, parked)
        _INFLIGHT_G.set(session.active)
        try:
            prev_slice_end: Optional[float] = None
            # prefill tokens egress immediately: a streamed anchor's
            # first chunk exists before any decode slice ran
            self._push_deltas(session, live)
            # a prime ANCHOR's prefill is already complete at open —
            # export it before paying any decode slice here
            self._prime_sweep(session, live, parked)
            while self._running and (
                session.active or pending or parked
            ):
                # cancellation/deadline sweep BETWEEN slices: a client
                # that hung up (or a deadline that passed) retires its
                # row within one decode slice
                self._reap_expired(session, live, pending, parked)
                # drain evacuation: a pending evacuate() request exports
                # every live streaming row between two slices — their
                # streams end carrying migrate bundles
                self._evac_sweep(session, live, parked)
                rows_before = session.active
                if rows_before:
                    t_slice0 = time.monotonic()
                    with self._backend_lock:
                        retired = session.step(self.slice_steps)
                    t_slice_end = time.monotonic()
                    if _obs_enabled():
                        FLIGHT.emit(
                            EV_SLICE,
                            rows=rows_before,
                            retired=len(retired),
                            dur_s=round(t_slice_end - t_slice0, 6),
                            **trace_attrs(first.span),
                        )
                        # spike detection over the slice wall itself:
                        # a slice at a rolling-median multiple fires an
                        # anomaly event carrying the recorder's recent
                        # context as the exemplar
                        SLICE_SPIKES.observe(
                            t_slice_end - t_slice0,
                            trace=trace_of(first.span),
                        )
                    if (
                        prev_slice_end is not None
                        and self.slice_gap_sink is not None
                    ):
                        try:
                            self.slice_gap_sink(
                                t_slice_end - prev_slice_end, rows_before
                            )
                        except Exception:  # noqa: BLE001 — probe only
                            pass
                    prev_slice_end = t_slice_end
                    # token egress BEFORE ticket completion: a retiring
                    # row's tail deltas precede its final event
                    self._push_deltas(session, live)
                    for result in retired:
                        self._complete_row(live, result, t_slice_end)
                else:
                    # every live row retired while joiners are still
                    # prefilling: no decode to slice, chunks run
                    # back-to-back until one commits
                    prev_slice_end = None
                self._progress_joins(session, live, pending)
                # SLO tiers: age parked victims up, resume
                # those that fit (and are not about to be re-preempted),
                # THEN admit queued tickets — which may itself preempt
                self._age_parked(parked)
                self._resume_victims(session, live, pending, parked)
                self._admit_into(
                    session, live, first.request, pending, parked
                )
                # newly committed/admitted streaming rows egress their
                # prefill token now, and the session's stream_tokens
                # flag is refreshed before the next slice
                self._push_deltas(session, live)
                # prime rows whose chunked prefill just committed export
                # now — before the next slice decodes them here
                self._prime_sweep(session, live, parked)
                _INFLIGHT_G.set(session.active + len(pending))
                _PARKED_G.set(len(parked))
        except BaseException as exc:  # noqa: BLE001 — engine died mid-session
            _BATCH_FALLBACK_C.inc()
            FLIGHT.emit(
                EV_BATCH_FALLBACK,
                rows=session.active,
                stage="session",
                error=f"{type(exc).__name__}: {exc}",
                **trace_attrs(first.span),
            )
            FLIGHT.crash_dump(
                f"continuous session died: {type(exc).__name__}: {exc}",
                state=self.debug_state(),
            )
            leftovers = (
                list(live.values())
                + [t for t, _ in pending]
                + [p.ticket for p in parked]
            )
            live.clear()
            pending.clear()
            parked.clear()
            for ticket in leftovers:
                _ROWS_RETIRED_C.labels(reason="error").inc()
                FLIGHT.emit(
                    EV_ROW_RETIRED,
                    reason="error",
                    **trace_attrs(ticket.span),
                )
            self._dispatch_isolated(leftovers)
        finally:
            self._dbg = None
            try:
                with self._backend_lock:
                    session.close()  # aborts pending joins, frees pages
            except Exception:  # noqa: BLE001
                pass
            for ticket, _pj in pending:
                # only reachable when stop() interrupted the loop
                _ROWS_RETIRED_C.labels(reason="shutdown").inc()
                FLIGHT.emit(
                    EV_ROW_RETIRED,
                    reason="shutdown",
                    **trace_attrs(ticket.span),
                )
                self._fail_ticket(
                    ticket, RuntimeError("server shutting down")
                )
            pending.clear()
            for entry in parked:
                # only reachable when stop() interrupted the loop (the
                # session's close above already settled the swap ledger)
                _ROWS_RETIRED_C.labels(reason="shutdown").inc()
                FLIGHT.emit(
                    EV_ROW_RETIRED,
                    reason="shutdown",
                    **trace_attrs(entry.ticket.span),
                )
                self._fail_ticket(
                    entry.ticket, RuntimeError("server shutting down")
                )
            parked.clear()
            _PARKED_G.set(0)
            for ticket in live.values():
                # only reachable when stop() interrupted the loop
                _ROWS_RETIRED_C.labels(reason="shutdown").inc()
                FLIGHT.emit(
                    EV_ROW_RETIRED,
                    reason="shutdown",
                    **trace_attrs(ticket.span),
                )
                self._fail_ticket(
                    ticket, RuntimeError("server shutting down")
                )
            live.clear()
            _INFLIGHT_G.set(0)

    def _push_deltas(self, session, live: Dict[int, _Ticket]) -> None:
        """The EGRESS phase: hand each streaming row's new tokens to its
        per-request channel (serve/stream.py). Also maintains the
        session's ``stream_tokens`` flag so retiring rows buffer their
        tails only while someone is listening. A failed push means the
        consumer is gone — the next reap sweep retires the row."""
        streaming = any(t.stream is not None for t in live.values())
        if hasattr(session, "stream_tokens"):
            session.stream_tokens = streaming
        if not streaming or not hasattr(session, "stream_deltas"):
            return
        for request, tokens, text in session.stream_deltas():
            ticket = live.get(id(request))
            if ticket is None or ticket.stream is None:
                continue
            if ticket.prime:
                # prime rows buffer instead of pushing: the deltas either
                # ship inside the migrate bundle (the decode server
                # re-streams from token 0, TTFT stamps there) or flush
                # here on an export fallback
                if ticket.prime_buf is None:
                    ticket.prime_buf = []
                ticket.prime_buf.append((text, tokens))
                continue
            if ticket.stream.push(text, tokens) and ticket.t_first is None:
                # TTFT-at-first-chunk: the stream's own first-push clock
                ticket.t_first = ticket.stream.t_first_chunk
            if _obs_enabled():
                # the wire-visible delivery moment — the "stream chunks"
                # phase of a /debug/timeline; one event per
                # egress push (≈ rows × slices, same order as EV_SLICE)
                FLIGHT.emit(
                    EV_STREAM_CHUNK,
                    tokens=len(tokens),
                    total=ticket.stream.tokens_pushed,
                    **trace_attrs(ticket.span),
                )

    def _reap_expired(self, session, live, pending, parked=None) -> None:
        """The CANCELLATION/DEADLINE sweep, run between two decode
        slices: live rows whose stream was cancelled (disconnect,
        explicit cancel, or backpressure) or whose ``deadline_ms``
        passed retire NOW through ``session.cancel`` — done-mask set,
        pages back to the pool free-list, ticket failed cleanly — and
        pending chunked joiners abort their reservation the same way.
        PARKED preemption victims are swept too: their host blob is
        discarded (``session.resume_discard`` settles the swap ledger)
        instead of ever swapping back in."""
        parked = parked if parked is not None else []
        if not live and not pending and not parked:
            return
        now = time.monotonic()
        for entry in list(parked):
            reason = self._reap_reason(entry.ticket, now)
            if reason is None:
                continue
            try:
                with self._backend_lock:
                    discard = getattr(session, "resume_discard", None)
                    if discard is not None:
                        discard(entry.pr)
            except Exception:  # noqa: BLE001 — ledger only
                pass
            try:
                parked.remove(entry)
            except ValueError:
                pass
            _PARKED_G.set(len(parked))
            self._fail_reaped(entry.ticket, reason)
        for ticket in list(live.values()):
            reason = self._reap_reason(ticket, now)
            if reason is None:
                continue
            try:
                with self._backend_lock:
                    session.cancel(ticket.request)
            except Exception:  # noqa: BLE001 — row may have just retired
                pass
            live.pop(id(ticket.request), None)
            self._fail_reaped(ticket, reason)
        for entry in list(pending):
            ticket, pj = entry
            reason = self._reap_reason(ticket, now)
            if reason is None:
                continue
            try:
                with self._backend_lock:
                    session.join_abort(pj)
            except Exception:  # noqa: BLE001
                pass
            try:
                pending.remove(entry)
            except ValueError:
                pass
            self._fail_reaped(ticket, reason)

    @staticmethod
    def _reap_reason(ticket: _Ticket, now: float) -> Optional[str]:
        if ticket.stream is not None and ticket.stream.cancelled:
            return "cancelled"
        deadline_ms = ticket.request.deadline_ms
        if deadline_ms is not None and now - ticket.t_submit > deadline_ms / 1e3:
            return "deadline"
        return None

    def _fail_reaped(self, ticket: _Ticket, reason: str) -> None:
        _ROWS_RETIRED_C.labels(reason=reason).inc()
        FLIGHT.emit(
            EV_ROW_RETIRED,
            reason=reason,
            generated_tokens=(
                ticket.stream.tokens_pushed
                if ticket.stream is not None
                else None
            ),
            **trace_attrs(
                ticket.span, tenant=getattr(ticket.request, "tenant", None)
            ),
        )
        if reason == "cancelled":
            self._fail_ticket(
                ticket,
                StreamCancelled(
                    "stream cancelled "
                    f"({ticket.stream.cancel_cause or 'disconnect'})"
                ),
            )
        else:
            self._fail_ticket(
                ticket,
                DeadlineExceeded(
                    f"deadline_ms={ticket.request.deadline_ms:g} passed "
                    "mid-flight; row retired"
                ),
            )

    def _progress_joins(
        self,
        session,
        live: Dict[int, _Ticket],
        pending: "deque",
    ) -> None:
        """The INTERLEAVE policy: run AT MOST ONE prefill chunk of AT
        MOST ONE pending joiner between two decode slices (round-robin
        across joiners), so in-flight rows' stall per slice is bounded
        by the chunk budget. A chunk failure is the joiner's own fault:
        its reservation is aborted and only its caller fails."""
        if not pending:
            return
        ticket, pj = pending.popleft()
        stalled_rows = session.active  # rows that wait on this chunk
        t0 = time.monotonic()
        committed = False
        try:
            with TRACER.attach(ticket.span), self._backend_lock:
                if session.join_step(pj):
                    session.join_commit(pj)
                    committed = True
        except BaseException as exc:  # noqa: BLE001
            try:
                with self._backend_lock:
                    session.join_abort(pj)
            except Exception:  # noqa: BLE001
                pass
            FLIGHT.emit(
                EV_ROW_RETIRED,
                reason="error",
                join_aborted=True,
                **trace_attrs(ticket.span),
            )
            self._fail_ticket(ticket, exc)
            return
        dt = time.monotonic() - t0
        ticket.join_chunks += 1
        _JOIN_CHUNKS_C.inc()
        _JOIN_PREFILL_H.observe(dt)
        if _obs_enabled():
            FLIGHT.emit(
                EV_JOIN_CHUNK,
                chunk=ticket.join_chunks,
                committed=committed,
                stalled_rows=stalled_rows,
                dur_s=round(dt, 6),
                **trace_attrs(ticket.span),
            )
        if stalled_rows:
            _DECODE_STALL_H.observe(dt)
        if committed:
            now = time.monotonic()
            if ticket.stream is None and ticket.t_first is None:
                # first token sampled at commit; streamed joiners stamp
                # t_first at their first pushed chunk instead (a RESUME
                # keeps its original first-token clock — the row's TTFT
                # happened before it was ever preempted)
                ticket.t_first = now
            if _is_resume(pj):
                ticket.resumed = True
                live[id(ticket.request)] = ticket
            else:
                ticket.joined = True
                live[id(ticket.request)] = ticket
                _ROWS_JOINED_C.inc()
        else:
            pending.append((ticket, pj))  # round-robin: back of the line

    def _complete_row(
        self, live: Dict[int, _Ticket], result: GenerationResult, now: float
    ) -> None:
        ticket = live.pop(id(result.request), None)
        reason = (result.extras or {}).get("retire_reason", "eos")
        _ROWS_RETIRED_C.labels(reason=reason).inc()
        FLIGHT.emit(
            EV_ROW_RETIRED,
            reason=reason,
            generated_tokens=result.generated_tokens,
            **trace_attrs(
                ticket.span if ticket is not None else None,
                tenant=getattr(result.request, "tenant", None),
            ),
        )
        if ticket is None:  # defensive: a row the session invented
            return
        self._finish_ticket(ticket, result, now)

    def _age_parked(self, parked: "List[_Parked]") -> None:
        """Starvation protection: a parked victim ages UP one tier per
        full ``preempt_max_wait_s`` waited, so a low-tier victim under a
        sustained high-tier storm eventually outranks the storm (the
        resume gate reads the EFFECTIVE tier) and cannot be preempted
        again once resumed at the aged tier."""
        if not parked or self.preempt_max_wait_s <= 0:
            return
        now = time.monotonic()
        for entry in parked:
            aged = entry.base_tier + int(
                (now - entry.t_parked) / self.preempt_max_wait_s
            )
            if aged > entry.ticket.priority:
                entry.ticket.priority = aged

    def _resume_victims(
        self,
        session,
        live: Dict[int, _Ticket],
        pending: "deque",
        parked: "List[_Parked]",
    ) -> None:
        """The RESUME phase: parked victims re-enter when capacity
        returns — through the chunked-join machinery (``resume_begin``
        reserves slot + pages; a recompute victim's re-prefill then
        interleaves like any joiner's chunks; a swap victim commits on
        the next interleave turn). Highest effective tier
        resumes first. Anti-thrash gate: while a strictly-higher-tier
        ticket waits in the queue a victim stays parked (it would be
        preempted again immediately) — unless the session is otherwise
        idle, where resuming is always better than stalling. A victim
        that can never resume (its plan is gone) fails once the session
        is drained rather than parking forever."""
        if not parked or not hasattr(session, "resume_begin"):
            return
        queue_tier = self._queue.max_tier()
        for entry in sorted(
            parked, key=lambda p: (-p.ticket.priority, p.t_parked)
        ):
            ticket, pr = entry.ticket, entry.pr
            idle = session.active == 0 and not pending
            if (
                not idle
                and queue_tier is not None
                and queue_tier > ticket.priority
            ):
                continue
            try:
                with self._backend_lock:
                    ok = session.can_resume(pr)
            except Exception:  # noqa: BLE001 — probe only
                ok = False
            if not ok:
                if idle and self._queue.qsize() == 0:
                    # drained session, empty queue, still unresumable:
                    # that never changes — fail it instead of spinning
                    try:
                        with self._backend_lock:
                            discard = getattr(
                                session, "resume_discard", None
                            )
                            if discard is not None:
                                discard(pr)
                    except Exception:  # noqa: BLE001
                        pass
                    parked.remove(entry)
                    _PARKED_G.set(len(parked))
                    _ROWS_RETIRED_C.labels(reason="error").inc()
                    FLIGHT.emit(
                        EV_ROW_RETIRED,
                        reason="error",
                        resume_failed=True,
                        **trace_attrs(ticket.span),
                    )
                    self._fail_ticket(
                        ticket,
                        RuntimeError(
                            "preempted row could not resume (its shared "
                            "prefix or session shapes are gone)"
                        ),
                    )
                continue
            try:
                with TRACER.attach(ticket.span), self._backend_lock:
                    pj = session.resume_begin(
                        pr, self.prefill_chunk_tokens
                    )
            except BaseException as exc:  # noqa: BLE001
                parked.remove(entry)
                _PARKED_G.set(len(parked))
                self._fail_ticket(ticket, exc)
                continue
            parked.remove(entry)
            pending.append((ticket, pj))
            _RESUMED_C.inc()
            _PARKED_G.set(len(parked))
            # Wasted-energy ledger: a recompute resume re-prefills prompt
            # + generated-so-far — token positions the request already
            # paid for once. Charged at the live J/token and stamped on
            # the ticket so the figure rides extras["energy"]["wasted_J"]
            # to the caller.
            if _pr_field(pr, "policy") == "recompute":
                redo_tokens = (
                    _pr_field(pr, "prompt_len", 0) or 0
                ) + len(_pr_field(pr, "generated", ()) or ())
                if redo_tokens:
                    j = charge_wasted("recompute", tokens=redo_tokens)
                    ticket.wasted["recompute"] = (
                        ticket.wasted.get("recompute", 0.0) + j
                    )
                    _pr_add_wasted(pr, j)
            FLIGHT.emit(
                EV_ROW_RESUMED,
                policy=_pr_field(pr, "policy"),
                tier=ticket.priority,
                aged=ticket.priority - entry.base_tier,
                parked_s=round(time.monotonic() - entry.t_parked, 4),
                **trace_attrs(ticket.span),
            )

    def _preempt_for(
        self,
        session,
        live: Dict[int, _Ticket],
        ticket: _Ticket,
        parked: "List[_Parked]",
        cap: int,
        pending: "deque",
    ) -> bool:
        """Make room for a higher-tier ticket by preempting the
        YOUNGEST STRICTLY-LOWER-TIER live row(s), until the ticket fits
        or no eligible victim remains. Victims park on the resume queue
        (``_Parked``); each preemption emits the ``preempted`` flight
        event trace-linked to BOTH tickets. Returns True when at least
        one victim was parked (the caller retries the admit)."""
        if not hasattr(session, "preempt"):
            return False
        tier = ticket.priority
        did = False
        skip: set = set()
        while True:
            try:
                with self._backend_lock:
                    if session.active + len(pending) < cap and (
                        session.can_join(ticket.request)
                    ):
                        return did
            except Exception:  # noqa: BLE001 — probe only
                return did
            victims = [
                t
                for t in live.values()
                if t.priority < tier and id(t.request) not in skip
            ]
            if not victims:
                return did
            # lowest tier first; among equals the YOUNGEST (least sunk
            # decode work is thrown away or swapped)
            victim = min(
                victims, key=lambda t: (t.priority, -t.t_submit)
            )
            try:
                with self._backend_lock:
                    pr = session.preempt(
                        victim.request, policy=self.preempt_policy
                    )
            except Exception:  # noqa: BLE001 — engine refused
                pr = None
            if pr is None:
                skip.add(id(victim.request))
                continue
            live.pop(id(victim.request), None)
            victim.preempts += 1
            parked.append(_Parked(victim, pr))
            did = True
            _PREEMPTED_C.labels(policy=self.preempt_policy).inc()
            _PARKED_G.set(len(parked))
            # Wasted-energy ledger: a swap preemption moves
            # the victim's KV payload over the host link TWICE (out
            # now, back in at resume) — charged here once at 2× so a
            # victim discarded while parked still accounts the out leg
            # it already paid (the in leg it never takes is noise at
            # SWAP_J_PER_BYTE scale).
            host_bytes = _pr_field(pr, "host_bytes", 0) or 0
            if host_bytes:
                j = charge_wasted("swap", nbytes=2 * host_bytes)
                victim.wasted["swap"] = (
                    victim.wasted.get("swap", 0.0) + j
                )
                _pr_add_wasted(pr, j)
            FLIGHT.emit(
                EV_ROW_PREEMPTED,
                by=trace_of(ticket.span),
                by_trace_id=getattr(ticket.span, "trace_id", None),
                policy=self.preempt_policy,
                tier=victim.priority,
                by_tier=tier,
                generated_tokens=len(_pr_field(pr, "generated", ()) or ()),
                swapped_bytes=host_bytes,
                **trace_attrs(
                    victim.span,
                    tenant=getattr(victim.request, "tenant", None),
                ),
            )

    def _admit_into(
        self,
        session,
        live: Dict[int, _Ticket],
        anchor,
        pending: "deque",
        parked: "Optional[List[_Parked]]" = None,
    ) -> None:
        """The JOIN phase: move queued compatible tickets into freed
        rows, re-evaluating the budget-aware cap at each admission
        (pending chunked joiners count against it — they hold slots and
        pages). With ``chunked_joins`` and a resumable backend, admission
        only RESERVES (``join_begin``: slot + pages, no device compute);
        the prefill then streams in one chunk per iteration via
        :meth:`_progress_joins`. Otherwise the whole prompt prefills here
        (synchronous ``join``). A compatible ticket that does NOT fit may
        PREEMPT: when the preempt policy is on and a strictly
        lower-tier live row exists, the youngest such victim is parked
        (pages swapped out or dropped) and the admit retried — the
        high-tier ticket enters within the same scheduler iteration.
        Bounded by the queue's snapshot size; a ticket that cannot join
        right now (incompatible, cap, no free slot/pages, no victim)
        re-queues for the next slice or its own session."""
        parked = parked if parked is not None else []
        chunked = self.chunked_joins and hasattr(session, "join_begin")
        for _ in range(self._queue.qsize()):
            try:
                ticket = self._queue.get_nowait()
            except queue.Empty:
                return
            if ticket is None:
                self._queue.put(None)
                return
            if self._preadmit_reject(ticket):
                continue
            request = ticket.request
            admitted = False
            pj = None
            if ticket.migrate_pr is not None:
                # migrate-in: seat through resume_begin —
                # never a join (its prefill happened on the source
                # server). No capacity → requeue; it retries next
                # slice or anchors its own session via _run_migrate.
                if self._compatible(anchor, request):
                    try:
                        with TRACER.attach(
                            ticket.span
                        ), self._backend_lock:
                            if session.can_resume(ticket.migrate_pr):
                                pj = session.resume_begin(
                                    ticket.migrate_pr,
                                    self.prefill_chunk_tokens,
                                )
                                admitted = True
                    except BaseException as exc:  # noqa: BLE001
                        self._fail_ticket(ticket, exc)
                        continue
                if not admitted:
                    self._requeue(ticket)
                    continue
                now = time.monotonic()
                ticket.queue_wait_s = now - ticket.t_submit
                _QUEUE_WAIT_H.observe(ticket.queue_wait_s)
                TRACER.add_span(
                    "queue", ticket.t_submit, now,
                    attrs={"migrated": True}, parent=ticket.span,
                )
                FLIGHT.emit(
                    EV_REQUEST_ADMITTED,
                    mode="continuous",
                    migrated=True,
                    model=request.model,
                    queue_wait_s=round(ticket.queue_wait_s or 0.0, 6),
                    **trace_attrs(ticket.span),
                )
                pending.append((ticket, pj))
                continue
            if self._compatible(anchor, request):
                cap = self._admission_cap(ticket)

                def _try_admit():
                    nonlocal pj
                    if session.active + len(pending) >= cap:
                        return False
                    with TRACER.attach(ticket.span), self._backend_lock:
                        if not session.can_join(request):
                            return False
                        if chunked:
                            pj = session.join_begin(
                                request, self.prefill_chunk_tokens
                            )
                        else:
                            session.join(request)
                    return True

                try:
                    admitted = _try_admit()
                    if (
                        not admitted
                        and self.preempt_policy != "off"
                        and self._preempt_for(
                            session, live, ticket, parked, cap, pending
                        )
                    ):
                        admitted = _try_admit()
                except BaseException as exc:  # noqa: BLE001
                    # the join's prefill failed: this request's own
                    # fault (bad prompt) — fail only its caller
                    self._fail_ticket(ticket, exc)
                    continue
            if admitted:
                now = time.monotonic()
                ticket.queue_wait_s = now - ticket.t_submit
                _QUEUE_WAIT_H.observe(ticket.queue_wait_s)
                TRACER.add_span(
                    "queue", ticket.t_submit, now,
                    attrs={"joined": True}, parent=ticket.span,
                )
                FLIGHT.emit(
                    EV_REQUEST_ADMITTED,
                    mode="continuous",
                    joined=True,
                    chunked=chunked,
                    model=request.model,
                    queue_wait_s=round(ticket.queue_wait_s or 0.0, 6),
                    **trace_attrs(ticket.span),
                )
                if chunked:
                    pending.append((ticket, pj))
                else:
                    if ticket.stream is None:
                        ticket.t_first = now
                    ticket.joined = True
                    live[id(request)] = ticket
                    _ROWS_JOINED_C.inc()
            else:
                self._requeue(ticket)
