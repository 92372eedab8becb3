"""The generation-backend contract.

Equivalent of the reference's HTTP request/response with Ollama
(``POST /api/generate`` with ``{model, prompt, stream:false}``,
experiment/RunnerConfig.py:128-131): a request names a model, a prompt and a
token budget; the result carries the generated tokens plus the timing
breakdown the energy analysis needs (the reference only gets a wall-clock
around curl; we split prefill vs decode and report tokens/s).

A copy of the JAX package's contract, so that both engines take the same
requests and return the same results.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

from ..obs.trace import TraceContext


@dataclasses.dataclass(frozen=True)
class GenerationRequest:
    model: str
    prompt: str
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0  # 1.0 disables nucleus filtering
    repeat_penalty: float = 1.0  # 1.0 disables
    seed: int = 0
    stop_at_eos: bool = True
    # Ollama's options.stop: generation output is cut before the first
    # occurrence of any of these strings.
    stop: "tuple[str, ...]" = ()
    # Wall-clock budget for the WHOLE request, submit to completion
    # (wire: x_deadline_ms). None = no deadline. Schedulers enforce it:
    # queued past the deadline rejects before admission, in-flight past
    # it retires the row (reason="deadline") and fails the caller.
    deadline_ms: Optional[float] = None
    # SLO tier (wire: x_priority; serve --default-priority). Higher is
    # more important. The scheduler queue is per-tier FIFO, and the
    # continuous scheduler may PREEMPT a strictly-lower-tier in-flight
    # row (pages swapped to host or dropped for recompute) to admit a
    # higher-tier ticket under overload. The canonical named tiers are
    # serve/protocol.PRIORITY_TIERS (low=0, normal=1, high=2); any
    # non-negative integer is a valid tier.
    priority: int = 1
    # Usage-accounting tenant (wire: x_tenant). Every request
    # belongs to exactly one tenant; "default" when the caller names
    # none. Terminal outcomes, served/generated tokens and attributed
    # Joules are accounted per tenant (obs/tenants.py) — the substrate
    # energy contracts and billing replay consume. Scrape-label
    # cardinality is bounded THERE (overflow folds into "_other"); the
    # request keeps the raw id.
    tenant: str = "default"
    # Fleet-wide trace context (wire: x_trace): minted at the
    # front door (router/server) when absent, or accepted from the
    # caller; every hop the request touches (both attempts of a retry
    # included) tags its spans and flight events with trace.trace_id,
    # so GET /debug/timeline?trace= can reassemble the cross-process
    # story. None = untraced (a hop will mint one).
    trace: Optional[TraceContext] = None

    def __post_init__(self) -> None:
        # Degenerate knobs would silently corrupt sampling (top_p<=0 masks
        # the whole vocab to -inf; repeat_penalty<=0 divides logits by
        # zero), so reject them where every entry path — wire or direct
        # construction — passes through.
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.repeat_penalty <= 0:
            raise ValueError(
                f"repeat_penalty must be > 0, got {self.repeat_penalty}"
            )
        if any(not s for s in self.stop):
            raise ValueError(
                "stop strings must be non-empty (an empty string matches at "
                "position 0 and would blank every result)"
            )
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {self.deadline_ms}"
            )
        if not isinstance(self.priority, int) or self.priority < 0:
            raise ValueError(
                f"priority must be a non-negative integer tier, "
                f"got {self.priority!r}"
            )
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(
                f"tenant must be a non-empty string, got {self.tenant!r}"
            )


@dataclasses.dataclass
class GenerationResult:
    request: GenerationRequest
    tokens: List[int]  # generated token ids (prompt excluded)
    text: str
    prompt_tokens: int
    generated_tokens: int
    prefill_s: float
    decode_s: float
    total_s: float
    # Backend-specific extras (e.g. speculative decoding's rounds/accepted
    # counters); absent for plain decoding.
    extras: Optional[dict] = None

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s > 0 else 0.0


@dataclasses.dataclass
class GenerationChunk:
    """One streamed increment of a generation.

    ``text`` is the new text since the previous chunk; ``tokens`` the new
    token ids. The final chunk has ``done=True`` and carries the full
    :class:`GenerationResult` (Ollama's streaming wire likewise ends with a
    ``done: true`` record holding the aggregate statistics).
    """

    text: str
    tokens: List[int]
    done: bool = False
    result: Optional[GenerationResult] = None


class GenerationBackend:
    """Abstract backend: load models, serve generation requests.

    Backends MAY additionally speak the optional STEPPED-DECODE protocol
    (iteration-level continuous batching — serve/scheduler.py's
    ``ContinuousScheduler`` drives it when present):

    - ``decode_open(requests, reserve_rows=None) -> session`` prefills
      the rows and returns a resumable session;
    - ``session.step(max_steps) -> list[GenerationResult]`` runs one
      bounded decode slice and returns rows that retired during it;
    - ``session.can_join(request) -> bool`` / ``session.join(request)``
      admit a compatible queued request into a freed row mid-flight;
    - ``session.active`` counts live rows; ``session.close()`` releases
      the session;
    - ``session.cancel(request) -> bool`` retires a live row NOW without
      completing it (client disconnect / deadline — the row's pages
      return to the pool, its partial stream is discarded);
    - ``session.stream_deltas() -> list[(request, tokens, text)]``
      returns each row's tokens generated since the previous call
      (honoured only while ``session.stream_tokens`` is set by the
      scheduler) — the producer side of serve/stream.py's egress
      channels.

    Presence of ``decode_open`` is the capability signal (the base class
    deliberately does not define it). The port's TorchEngine
    (``paged_kv=True``, ``engine/stepped.py``) and FakeBackend implement
    it.
    """

    def load_model(self, model: str) -> None:
        """Make ``model`` servable (weights into device memory)."""
        raise NotImplementedError

    def loaded_models(self) -> List[str]:
        """Models currently resident in memory (the ``/api/ps`` surface).
        Default: unknown/empty."""
        return []

    def generate(self, request: GenerationRequest) -> GenerationResult:
        raise NotImplementedError

    def generate_batch(
        self, requests: List[GenerationRequest]
    ) -> List[GenerationResult]:
        """Serve several requests together. Default: sequentially — backends
        with a real batched path (a shared decode loop) override this for near-linear decode throughput scaling."""
        return [self.generate(r) for r in requests]

    def generate_stream(
        self, request: GenerationRequest
    ) -> Iterator[GenerationChunk]:
        """Stream a generation as incremental chunks ending with a
        ``done=True`` chunk carrying the full result. Default: degenerate
        single-chunk stream over blocking :meth:`generate` (backends with a
        real incremental path override this)."""
        result = self.generate(request)
        yield GenerationChunk(
            text=result.text, tokens=list(result.tokens), done=False
        )
        yield GenerationChunk(text="", tokens=[], done=True, result=result)

    def warmup(self, request: GenerationRequest) -> None:
        """Bring the backend to steady state for this request shape (weights
        loaded, kernels compiled) so a following ``generate`` measures pure
        serving work — the reference's Ollama server is likewise warm before
        the measurement window opens. Default: no-op."""

    def unload_all(self) -> None:
        """Release model state (between treatments)."""
