"""Per-request token egress channels: the streaming-delivery spine.

The paper's remote-fetch arm measures the energy of *delivered* content,
and the ROADMAP's north-star traffic is streaming traffic — yet until
the HTTP layer buffered full completions even though the stepped
decode loop already surfaces tokens every ``--decode-slice-steps``. This
module is the missing conduit between the two clocks involved:

- the PRODUCER is the scheduler's slice loop (``serve/scheduler.py``):
  after every bounded decode slice it pushes each streaming row's new
  tokens into that row's :class:`TokenStream`;
- the CONSUMER is the HTTP handler thread (``serve/server.py``): it
  blocks on the channel and writes one SSE event per delta, with the
  final event carrying the full wire result (extras/energy payload
  included).

The channel is BOUNDED (drop nothing, but a producer facing a full
queue treats the consumer as gone — see below) and doubles as the
CANCELLATION rendezvous: the consumer calling :meth:`TokenStream.cancel`
(explicitly, or because an SSE socket write failed — the client hung
up) flips a flag the scheduler checks between slices, retiring the row
mid-flight through the session's early-retirement machinery. The
symmetric producer-side terminals (:meth:`finish` / :meth:`fail`) mean a
consumer can never be stranded: every scheduler exit path ends the
channel.

Backpressure policy: decode produces tokens far faster than any client
needs them, so a consumer that stops draining for ``PUSH_TIMEOUT_S``
while the queue is full is indistinguishable from a disconnected one —
the push marks the channel cancelled (``cause="backpressure"``) and the
row retires instead of wedging the shared decode loop behind one stalled
socket.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional

from ..engine.backend import GenerationResult
from ..obs.metrics import REGISTRY

# A slice pushes one event; 1024 events ≈ many minutes of decode ahead of
# the slowest reasonable consumer while bounding memory per stream.
DEFAULT_STREAM_DEPTH = 1024
# How long a producer waits on a full queue before declaring the consumer
# gone (backpressure cancellation). Decode slices are ms-scale; seconds of
# a full queue means nobody is reading.
PUSH_TIMEOUT_S = 10.0
# Consumer-side default wait for the next event: generous enough for a
# scheduler queue + prefill ahead of the first chunk, finite so a dead
# producer cannot strand an HTTP thread forever.
EVENT_TIMEOUT_S = 600.0

_STREAM_REQUESTS_C = REGISTRY.counter(
    "llm_stream_requests_total",
    "Streaming generations opened through a scheduler egress channel",
)
_STREAM_CHUNKS_C = REGISTRY.counter(
    "llm_stream_chunks_total",
    "Token-delta events pushed into per-request egress channels",
)
_STREAM_TOKENS_C = REGISTRY.counter(
    "llm_stream_tokens_total",
    "Tokens delivered through egress channels (final-event tokens excluded)",
)
_STREAM_CANCELLED_C = REGISTRY.counter(
    "llm_stream_cancelled_total",
    "Streams cancelled before completion, by cause (disconnect: an SSE "
    "socket write failed; explicit: the consumer called cancel(); "
    "backpressure: the bounded channel stayed full past the push timeout)",
    labels=("cause",),
)


class StreamCancelled(RuntimeError):
    """The consumer cancelled the stream (disconnect or explicit)."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline_ms (or the server TTFT SLO) expired before
    the work completed; the server maps this to HTTP 504."""


class StreamEvent:
    """One channel event: a token ``delta``, the terminal ``done`` (with
    the full :class:`GenerationResult`), a terminal ``error``, or a
    non-terminal ``keepalive`` synthesised by :meth:`TokenStream.events`
    when the producer has been silent for ``keepalive_s`` (a long
    chunked join-prefill produces no deltas — the consumer writes an
    SSE comment so the client's idle timeout never fires)."""

    __slots__ = ("kind", "text", "tokens", "result", "error")

    def __init__(
        self,
        kind: str,
        text: str = "",
        tokens: Optional[List[int]] = None,
        result: Optional[GenerationResult] = None,
        error: Optional[BaseException] = None,
    ) -> None:
        self.kind = kind  # "delta" | "done" | "error" | "keepalive"
        self.text = text
        self.tokens = tokens or []
        self.result = result
        self.error = error


class TokenStream:
    """One request's bounded egress channel (see the module docstring).

    Producer API (scheduler thread): :meth:`push`, :meth:`finish`,
    :meth:`fail`. Consumer API (HTTP handler thread): :meth:`events`,
    :meth:`cancel`. Thread-safe for exactly that one-producer /
    one-consumer split.
    """

    def __init__(self, maxsize: int = DEFAULT_STREAM_DEPTH) -> None:
        self._q: "queue.Queue[StreamEvent]" = queue.Queue(maxsize=maxsize)
        self._cancelled = threading.Event()
        self.cancel_cause: Optional[str] = None
        self.tokens_pushed = 0
        self.chunks_pushed = 0
        self.t_first_chunk: Optional[float] = None
        self._terminated = False

    # -- consumer side ---------------------------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self, cause: str = "explicit") -> None:
        """Mark the stream cancelled. The scheduler notices between two
        decode slices and retires the row (``reason="cancelled"``); the
        queue is drained so a producer blocked on a full channel
        unblocks immediately."""
        if self._cancelled.is_set():
            return
        self.cancel_cause = cause
        self._cancelled.set()
        _STREAM_CANCELLED_C.labels(cause=cause).inc()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def events(
        self,
        timeout_s: float = EVENT_TIMEOUT_S,
        keepalive_s: Optional[float] = None,
    ) -> Iterator[StreamEvent]:
        """Yield events until a terminal one (``done``/``error``). A
        producer silent past ``timeout_s`` yields a terminal error —
        the consumer must never be stranded.

        With ``keepalive_s``, every ``keepalive_s`` of producer silence
        yields a NON-terminal ``keepalive`` event instead of blocking
        through the gap — the SSE handler turns it into a comment line
        so a client behind a long chunked join-prefill (or an idle
        proxy) sees bytes while no tokens exist yet. The overall
        ``timeout_s`` bound still applies to the total silent span."""
        silent = 0.0
        wait = (
            min(keepalive_s, timeout_s)
            if keepalive_s is not None
            else timeout_s
        )
        while True:
            try:
                event = self._q.get(timeout=wait)
            except queue.Empty:
                silent += wait
                if silent < timeout_s:
                    yield StreamEvent("keepalive")
                    continue
                yield StreamEvent(
                    "error",
                    error=RuntimeError(
                        f"stream produced no event for {timeout_s:.0f}s"
                    ),
                )
                return
            silent = 0.0
            yield event
            if event.kind in ("done", "error"):
                return

    # -- producer side ---------------------------------------------------------
    def push(self, text: str, tokens: List[int]) -> bool:
        """Enqueue one token delta. Returns False when the consumer is
        gone (cancelled, or the bounded queue stayed full past the push
        timeout — then the channel marks itself cancelled with
        ``cause="backpressure"``); the caller retires the row."""
        if self._cancelled.is_set():
            return False
        try:
            self._q.put(StreamEvent("delta", text=text, tokens=tokens),
                        timeout=PUSH_TIMEOUT_S)
        except queue.Full:
            self.cancel(cause="backpressure")
            return False
        if self.t_first_chunk is None:
            self.t_first_chunk = time.monotonic()
        self.tokens_pushed += len(tokens)
        self.chunks_pushed += 1
        _STREAM_CHUNKS_C.inc()
        _STREAM_TOKENS_C.inc(len(tokens))
        return True

    def finish(self, result: GenerationResult) -> None:
        """Terminal success: the full result (extras/energy payload
        riding along) becomes the final event."""
        self._terminate(StreamEvent("done", result=result))

    def fail(self, exc: BaseException) -> None:
        """Terminal failure (scheduler shutdown, engine error, deadline)."""
        self._terminate(StreamEvent("error", error=exc))

    def _terminate(self, event: StreamEvent) -> None:
        if self._terminated:
            return
        self._terminated = True
        # A full queue cannot block the terminal: drop the oldest pending
        # delta until the terminal fits (the final result supersedes any
        # undelivered delta — it carries the authoritative text/tokens).
        while True:
            try:
                self._q.put_nowait(event)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass


def open_stream() -> TokenStream:
    """Channel factory: counts the open on llm_stream_requests_total so
    the metric cannot drift from construction sites."""
    _STREAM_REQUESTS_C.inc()
    return TokenStream()
