"""Multi-model serving: concurrent per-model sessions under one HBM
envelope + energy-aware model routing.

The source paper's scenario matrix is 7 Ollama models × 2 locations × 3
content lengths, and its core question — WHICH model should answer, and
at what energy cost — is answered offline there. Below this module the
serving stack is model-affine: the continuous scheduler batches only
same-model tickets, so mixed-model traffic SERIALIZES behind one
session (a small-model request queues until the big model's session
drains — head-of-line blocking across models), and the live per-request
J/token attribution never influences which model runs.

:class:`ModelFleetScheduler` fixes both:

- **One lane per model.** Each served model gets its own
  :class:`~.scheduler.ContinuousScheduler` (queue + admit/step/retire
  loop + its own session ``PagePool``) over ONE shared backend and ONE
  shared backend lock. Decode slices of different models interleave
  under the lock at slice granularity, so a small model's tickets
  admit, step and retire WHILE the big model decodes — no lane ever
  waits for another lane's session to drain, and no cross-model ticket
  ever trips the window-batch incompatibility fallback
  (``llm_sched_batch_fallback_total`` stays flat on a mixed trace).
- **One HBM envelope.** The engine's KV budget is split across the
  live lanes (``kv_budget_frac`` on each lane's admission cap =
  1/N-lanes), so N concurrent per-model pools bill the same device
  memory the single session used to own, next to the weight LRU and
  the prefix store (which stays per-model — its radix trees are keyed
  by model already). The engine side of the same envelope: evicting a
  model's weights while it has live stepped rows is REFUSED/DEFERRED
  (``llm_model_evict_deferred_total``; engine/torch_engine.py's
  ``_live_sessions`` refcount) instead of undefined.
- **Energy-aware model routing.** A request with ``model: "auto"``
  (protocol.AUTO_MODEL) resolves through the pluggable
  ``--model-policy``:

  - ``cheapest-joules`` picks the model with the lowest LIVE J/token
    (the per-model split of ``llm_request_joules_per_token`` the
    engines publish as ``last_joules_per_token_by_model``), falling
    back to estimated weight bytes — the physics proxy: decode J/token
    tracks the weight stream — for models with no attribution yet;
  - ``small-first`` is a CASCADE: the request runs on the smallest
    model first and ESCALATES to the biggest when the small answer
    trips the confidence proxy (a length cut: the row hit its token
    budget without sampling EOS, after at least ``escalate_max_tokens``
    tokens — a tightly-capped short answer is not evidence of low
    confidence). The abandoned small-model tokens (prefill +
    generated) charge the wasted-energy ledger with the new
    ``cause="escalation"``, the figure riding the final result's
    ``x_extras.energy.wasted_J`` next to the ``x_extras.fleet``
    attribution. Streamed ``auto`` requests resolve through the same
    policy but never cascade — tokens already on the wire cannot be
    un-streamed.

The scheduler surface (``submit``/``submit_stream``/``start``/``stop``/
``health_state``/``debug_state``) matches the single schedulers', so
``GenerationServer`` (and through it the router's replicas) hosts
a fleet with no wire changes: ``serve --models a,b --model-policy
small-first``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from ..engine.backend import (
    GenerationBackend,
    GenerationRequest,
    GenerationResult,
)
from ..obs.energy import charge_wasted
from ..obs.flight import EV_MODEL_ESCALATED, FLIGHT, trace_attrs
from ..obs.metrics import REGISTRY, enabled as _obs_enabled
from ..obs.trace import TRACER
from .protocol import AUTO_MODEL
from .scheduler import ContinuousScheduler

MODEL_POLICIES = (
    "small-first",  # cascade: smallest model, escalate on low confidence
    "cheapest-joules",  # lowest live J/token (weight-bytes fallback)
)

# Confidence-proxy floor of the small-first cascade: a budget-cut answer
# escalates only once it ran at least this many tokens without
# concluding (EOS). Below it, the caller's own tight cap — not the
# model — explains the cut. `serve --escalate-max-tokens` overrides.
DEFAULT_ESCALATE_MAX_TOKENS = 32

_ROUTE_C = REGISTRY.counter(
    "llm_model_route_total",
    "model:\"auto\" requests resolved to a concrete model by the fleet "
    "scheduler's --model-policy (escalations count again on the model "
    "they escalate to)",
    labels=("model", "policy"),
)
_ESCALATE_C = REGISTRY.counter(
    "llm_model_escalations_total",
    "small-first cascade escalations: the small model's answer tripped "
    "the confidence proxy (length cut) and the request re-ran on the "
    "big model — the abandoned tokens charge llm_request_wasted_joules_"
    "total{cause=\"escalation\"}",
    labels=("from_model", "to_model"),
)
_LANES_G = REGISTRY.gauge(
    "llm_model_fleet_lanes",
    "Live per-model scheduler lanes in the fleet (each owns one "
    "continuous admit/step/retire loop and 1/N of the KV envelope)",
)


class ModelFleetScheduler:
    """N concurrent per-model continuous schedulers over one backend
    (see the module docstring). ``models`` pre-opens a lane per name
    (recommended — the lane count fixes each lane's envelope share up
    front); unnamed models get a lane lazily on first request.
    ``lock`` is the shared backend lock (one engine, one in-flight
    compute — the same lock the server's serial paths take);
    ``lane_kwargs`` forward to every lane's ContinuousScheduler
    (slice_steps, prefill_chunk_tokens, ttft_slo_ms, preemption
    knobs, ...)."""

    def __init__(
        self,
        backend: GenerationBackend,
        models: Optional[List[str]] = None,
        model_policy: str = "small-first",
        escalate_max_tokens: Optional[int] = None,
        lock: Optional[threading.Lock] = None,
        **lane_kwargs,
    ) -> None:
        if model_policy not in MODEL_POLICIES:
            raise ValueError(
                f"model policy must be one of {MODEL_POLICIES}, "
                f"got {model_policy!r}"
            )
        if not hasattr(backend, "decode_open"):
            raise ValueError(
                f"{type(backend).__name__} has no stepped-decode support "
                "(decode_open); the model fleet needs continuous lanes"
            )
        self.backend = backend
        # price cross-model draft waste at the DRAFT model's own live
        # J/token: a fully-rejected speculative round burns
        # the draft lane's energy, and the fleet is the one place that
        # knows each model's attributed figure
        if hasattr(backend, "spec_draft_jpt"):
            backend.spec_draft_jpt = self._live_jpt
        self.model_policy = model_policy
        self.escalate_max_tokens = (
            int(escalate_max_tokens)
            if escalate_max_tokens is not None
            else DEFAULT_ESCALATE_MAX_TOKENS
        )
        if self.escalate_max_tokens < 1:
            raise ValueError(
                f"escalate_max_tokens must be >= 1, "
                f"got {escalate_max_tokens}"
            )
        self._backend_lock = lock if lock is not None else threading.Lock()
        self._lane_kwargs = dict(lane_kwargs)
        self._lanes: "Dict[str, ContinuousScheduler]" = {}
        self._order: List[str] = []
        self._lanes_lock = threading.Lock()
        self._running = False
        self.escalations = 0
        for name in models or []:
            self._ensure_lane(name)

    # -- lane lifecycle --------------------------------------------------------
    def _ensure_lane(self, model: str) -> ContinuousScheduler:
        with self._lanes_lock:
            lane = self._lanes.get(model)
            if lane is None:
                lane = ContinuousScheduler(
                    self.backend,
                    lock=self._backend_lock,
                    **self._lane_kwargs,
                )
                self._lanes[model] = lane
                self._order.append(model)
                # the HBM envelope split: every live lane's admission
                # cap scales to its 1/N share the moment the lane set
                # changes, so concurrent pools stay inside the budget
                frac = 1.0 / len(self._lanes)
                for other in self._lanes.values():
                    other.kv_budget_frac = frac
                _LANES_G.set(len(self._lanes))
                if self._running:
                    lane.start()
            return lane

    def start(self) -> None:
        self._running = True
        with self._lanes_lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.start()

    def stop(self, timeout_s: float = 30.0) -> None:
        self._running = False
        with self._lanes_lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.stop(timeout_s=timeout_s)

    # -- model ordering / policy ----------------------------------------------
    def _weight_bytes(self, model: str) -> int:
        probe = getattr(self.backend, "model_weight_bytes", None)
        if probe is not None:
            try:
                return int(probe(model))
            except Exception:  # noqa: BLE001 — estimate only
                pass
        # unknown size: fall back to configuration order (first = small)
        try:
            return self._order.index(model)
        except ValueError:
            return len(self._order)

    def models_by_size(self) -> List[str]:
        """The fleet's models smallest-first (estimated weight bytes,
        ties by name — deterministic under a pinned registry)."""
        with self._lanes_lock:
            names = list(self._order)
        return sorted(names, key=lambda m: (self._weight_bytes(m), m))

    def _live_jpt(self, model: str) -> Optional[float]:
        by_model = getattr(
            self.backend, "last_joules_per_token_by_model", None
        )
        if not by_model:
            return None
        value = by_model.get(model)
        return float(value) if value else None

    def _choose(self) -> Tuple[str, bool]:
        """Resolve ``model: "auto"`` → (model, cascade?). Deterministic
        for a fixed registry + attribution state: small-first always
        picks the smallest model; cheapest-joules prefers the lowest
        LIVE J/token and ranks un-attributed models by weight bytes
        BEHIND attributed ones (a measured figure beats a proxy)."""
        sized = self.models_by_size()
        if not sized:
            raise KeyError(AUTO_MODEL)
        if self.model_policy == "cheapest-joules":
            def key(m: str):
                jpt = self._live_jpt(m)
                if jpt is not None:
                    return (0, jpt, m)
                return (1, self._weight_bytes(m), m)

            return min(sized, key=key), False
        # small-first: cascade only when there is a bigger model to
        # escalate to
        return sized[0], len(sized) > 1

    def _resolve(
        self, request: GenerationRequest
    ) -> Tuple[GenerationRequest, bool]:
        """Pin an ``auto`` request to a concrete model (cascade flag
        rides back); named-model requests pass through untouched."""
        if request.model != AUTO_MODEL:
            return request, False
        model, cascade = self._choose()
        _ROUTE_C.labels(model=model, policy=self.model_policy).inc()
        return dataclasses.replace(request, model=model), cascade

    # -- dispatch --------------------------------------------------------------
    def submit(self, request: GenerationRequest) -> GenerationResult:
        if not self._running:
            raise RuntimeError("scheduler is not running")
        resolved, cascade = self._resolve(request)
        lane = self._ensure_lane(resolved.model)
        result = lane.submit(resolved)
        if cascade and self._low_confidence(resolved, result):
            return self._escalate(request, resolved, result)
        if resolved is not request:
            self._stamp_fleet(result, resolved.model)
        return result

    def submit_stream(self, request: GenerationRequest):
        """Streaming dispatch: ``auto`` resolves through the policy but
        NEVER cascades — tokens already streamed cannot be replaced by
        a bigger model's answer (documented; buffered requests get the
        cascade)."""
        if not self._running:
            raise RuntimeError("scheduler is not running")
        resolved, _cascade = self._resolve(request)
        lane = self._ensure_lane(resolved.model)
        return lane.submit_stream(resolved)

    # -- small-first escalation ------------------------------------------------
    def _low_confidence(
        self, request: GenerationRequest, result: GenerationResult
    ) -> bool:
        """The confidence proxy: the small model's answer was LENGTH
        CUT — it burned its whole token budget without concluding
        (sampling EOS) — after at least ``escalate_max_tokens`` tokens.
        Stepped results carry the authoritative ``retire_reason``; the
        budget-vs-request fallback covers salvage paths that ran
        through plain ``generate``."""
        if result.generated_tokens < self.escalate_max_tokens:
            return False
        reason = (result.extras or {}).get("retire_reason")
        if reason is not None:
            return reason != "eos"
        return (
            request.stop_at_eos
            and result.generated_tokens >= request.max_new_tokens
        )

    def _escalate(
        self,
        original: GenerationRequest,
        small_request: GenerationRequest,
        small_result: GenerationResult,
    ) -> GenerationResult:
        """Abandon the small model's answer and re-run on the BIGGEST
        model, charging the abandoned tokens (prefill + generated) to
        the wasted-energy ledger at the small model's own live J/token
        (``cause="escalation"``)."""
        big = self.models_by_size()[-1]
        small = small_request.model
        abandoned = (
            small_result.prompt_tokens + small_result.generated_tokens
        )
        wasted_j = charge_wasted(
            "escalation",
            tokens=abandoned,
            jpt=self._live_jpt(small),
        )
        self.escalations += 1
        _ESCALATE_C.labels(from_model=small, to_model=big).inc()
        _ROUTE_C.labels(model=big, policy=self.model_policy).inc()
        if _obs_enabled():
            FLIGHT.emit(
                EV_MODEL_ESCALATED,
                from_model=small,
                to_model=big,
                abandoned_tokens=abandoned,
                wasted_j=round(wasted_j, 6),
                **trace_attrs(TRACER.current()),
            )
        big_request = dataclasses.replace(original, model=big)
        lane = self._ensure_lane(big)
        result = lane.submit(big_request)
        self._stamp_fleet(
            result, big, escalated_from=small, wasted_j=wasted_j
        )
        return result

    def _stamp_fleet(
        self,
        result: GenerationResult,
        model: str,
        escalated_from: Optional[str] = None,
        wasted_j: float = 0.0,
    ) -> None:
        """Route attribution onto the wire (``x_extras.fleet``), plus
        the escalation's wasted-Joules figure into the shared
        ``x_extras.energy.wasted_J`` block the other causes ride."""
        fleet: Dict[str, object] = {
            "model": model,
            "policy": self.model_policy,
        }
        if escalated_from is not None:
            fleet["escalated"] = True
            fleet["escalated_from"] = escalated_from
        result.extras = {**(result.extras or {}), "fleet": fleet}
        if wasted_j > 0:
            energy = dict(result.extras.get("energy") or {})
            wasted = dict(energy.get("wasted_J") or {})
            wasted["escalation"] = round(
                wasted.get("escalation", 0.0) + wasted_j, 6
            )
            energy["wasted_J"] = wasted
            result.extras["energy"] = energy

    # -- introspection ---------------------------------------------------------
    def health_state(self) -> Dict[str, object]:
        """The router-probe surface: totals across lanes (the fleet is
        one replica from the router's point of view) plus the
        per-model split."""
        with self._lanes_lock:
            lanes = dict(self._lanes)
        per_model = {}
        queue_depth = 0
        inflight = 0
        for name, lane in lanes.items():
            try:
                health = lane.health_state()
            except Exception:  # noqa: BLE001 — probe only
                continue
            per_model[name] = {
                "queue_depth": health.get("queue_depth", 0),
                "inflight_rows": health.get("inflight_rows", 0),
            }
            queue_depth += int(health.get("queue_depth") or 0)
            inflight += int(health.get("inflight_rows") or 0)
        return {
            "scheduler": "fleet",
            "running": self._running,
            "queue_depth": queue_depth,
            "inflight_rows": inflight,
            "models": per_model,
        }

    def debug_state(self) -> Dict[str, object]:
        with self._lanes_lock:
            lanes = dict(self._lanes)
            order = list(self._order)
        state: Dict[str, object] = {
            "mode": "fleet",
            "running": self._running,
            "model_policy": self.model_policy,
            "escalate_max_tokens": self.escalate_max_tokens,
            "escalations": self.escalations,
            "models_by_size": self.models_by_size(),
            "configured": order,
            "kv_budget_frac": (
                round(1.0 / len(lanes), 4) if lanes else 1.0
            ),
        }
        per_model = {}
        for name, lane in lanes.items():
            try:
                per_model[name] = lane.debug_state()
            except Exception as exc:  # noqa: BLE001 — probe only
                per_model[name] = {
                    "error": f"{type(exc).__name__}: {exc}"
                }
        state["lanes"] = per_model
        # the engines' weight-lifecycle block rides along so one probe
        # answers "which weights are resident, who holds live rows"
        try:
            models_state = getattr(
                self.backend, "models_debug_state", None
            )
            if models_state is not None:
                state["weights"] = models_state()
        except Exception:  # noqa: BLE001 — probe only
            pass
        return state
