"""Wire protocol for the generation server.

Field names follow the API the reference's experiment speaks — the Ollama
REST surface it curls (experiment/RunnerConfig.py:128-131): request
``{"model", "prompt", "stream": false}`` with sampling knobs under
``options`` (``num_predict``, ``temperature``, ``top_k``, ``seed``);
response ``{"model", "response", "done", "eval_count", "eval_duration", …}``
with durations in nanoseconds. A client written against the reference's
server works against ours unchanged; our extensions ride under ``x_*`` keys.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Iterator

from ..engine.backend import GenerationRequest, GenerationResult
from ..obs.tenants import DEFAULT_TENANT
from ..obs.trace import TraceContext

DEFAULT_PORT = 11434  # the port the reference's curl targets (README.md:31)

# Ollama's num_predict accepts -1 ("until done") and -2 ("fill context");
# this server's decode loop stops at EOS anyway, so negatives map to a
# bounded budget rather than being rejected.
UNLIMITED_NUM_PREDICT_CAP = 512

# The engine's largest generation bucket (engine/torch_engine.GEN_BUCKETS[-1];
# duplicated here so the wire layer stays importable without torch). Values above it would only surface later as a 500
# from the engine's bucket lookup; reject them at the wire as a 400.
MAX_NUM_PREDICT = 2048

GENERATE_PATH = "/api/generate"
TAGS_PATH = "/api/tags"
PS_PATH = "/api/ps"  # loaded models (Ollama parity)
VERSION_PATH = "/api/version"
LOAD_PATH = "/api/load"  # extension: explicit weight-load outside the window
HEALTH_PATH = "/healthz"
METRICS_PATH = "/metrics"  # Prometheus text exposition (obs; 404 when off)
# Debug introspection (obs; all 404 when telemetry is off):
DEBUG_STATE_PATH = "/debug/state"  # live scheduler/session/pool snapshot
DEBUG_FLIGHT_PATH = "/debug/flight"  # flight events (?n=, ?type=, ?trace=)
DEBUG_TIMELINE_PATH = "/debug/timeline"  # router: one request's full
#   cross-process lifecycle, reassembled per trace id (?trace=)
DEBUG_TIMESERIES_PATH = "/debug/timeseries"  # windowed rollups from the
#   in-process time-series ring (?family=, ?window=, ?step=)
DEBUG_TENANTS_PATH = "/debug/tenants"  # per-tenant usage snapshot
#   (tokens/J/wasted-by-cause/outcomes; router merges replicas)
# Live row migration (disaggregated prefill/decode):
MIGRATE_PATH = "/api/migrate"  # POST a serialized row bundle
#   (serve/migrate.py); the receiver seats it through resume_begin/
#   _seat_row and answers with the row's SSE stream (or buffered result)
ADMIN_EVACUATE_PATH = "/admin/evacuate"  # POST: preempt + export every
#   live streamed row as a migrate bundle (replica-side drain support)
ADMIN_DRAIN_PATH = "/admin/drain"  # POST ?replica=<name>[&migrate=1]
#   on the ROUTER front door: drain one replica (evacuating in-flight
#   rows to survivors when migrate=1), result in the response body
ADMIN_ADD_REPLICA_PATH = "/admin/add_replica"  # POST ?target=<base_url>
#   [&name=]: attach a remote replica to the running router fleet

# Replica roles: what work a replica accepts. ``mixed`` is
# the default and keeps the single-role behavior byte-identical;
# ``prefill`` replicas prime rows (prefill + first token) and export
# them as migrate bundles; ``decode`` replicas only accept migrated-in
# rows (the router never dispatches fresh prefill work to them).
SERVER_ROLES = ("mixed", "prefill", "decode")

# Wire flag (rides the generate JSON body next to "stream"; unknown keys
# are ignored by request_from_wire, so plain servers are unaffected): ask
# the replica to PRIME the request — run prefill to completion, then
# preempt and export the row as a migrate bundle instead of decoding it
# locally. The stream's final record carries the bundle under
# ``x_extras["migrate"]``; a replica that cannot export (spec-active
# session, shared prefix mid-row) falls back to a normal local stream.
PRIME_KEY = "x_prime"


def trace_to_wire(trace: "TraceContext | None") -> "Dict[str, Any] | None":
    """``x_trace`` wire shape of a trace context: ``{"id": <hex>,
    "parent": <forwarding hop's span id>}`` (parent omitted when the
    caller minted the trace itself)."""
    if trace is None:
        return None
    out: Dict[str, Any] = {"id": trace.trace_id}
    if trace.parent is not None:
        out["parent"] = trace.parent
    return out


def trace_from_wire(value) -> "TraceContext | None":
    """Parse an ``x_trace`` body field (dict, or a bare trace-id string
    for curl-friendliness). Malformed values raise ValueError — a trace
    the caller garbled must 400, not silently drop correlation."""
    if value is None:
        return None
    if isinstance(value, str):
        if not value:
            raise ValueError("x_trace id must be non-empty")
        return TraceContext(trace_id=value)
    if isinstance(value, dict):
        trace_id = value.get("id")
        if not trace_id or not isinstance(trace_id, str):
            raise ValueError("x_trace requires a non-empty string 'id'")
        parent = value.get("parent")
        return TraceContext(
            trace_id=trace_id,
            parent=str(parent) if parent is not None else None,
        )
    raise ValueError(f"x_trace must be a string or object, got {value!r}")


def ensure_trace(request: GenerationRequest) -> GenerationRequest:
    """Give a request a fleet-wide trace if the caller sent none — the
    front door (router or single server) mints exactly once; every
    later hop (and every retry attempt) reuses what is already there."""
    if request.trace is not None:
        return request
    import dataclasses

    from ..obs.trace import mint_trace_id

    return dataclasses.replace(
        request, trace=TraceContext(trace_id=mint_trace_id())
    )

SERVER_VERSION = "0.1.0"

# Multi-model serving: a request whose ``model`` is this
# sentinel asks the server to PICK the model — resolved by the fleet
# scheduler's ``--model-policy`` (serve/model_fleet.py: small-first
# cascade with big-model escalation, or cheapest-joules on the live
# per-model J/token attribution). The final wire record names the model
# that actually answered; a server with no fleet treats "auto" as an
# unknown model (404).
AUTO_MODEL = "auto"

# SLO tiers: the canonical named priority tiers of the wire
# field ``x_priority``. Requests may send the name or any non-negative
# integer; absent means the server's ``--default-priority`` (which
# itself defaults to "normal"). Higher = more important: the scheduler
# queue is per-tier FIFO and the continuous scheduler may preempt
# strictly-lower-tier in-flight rows to admit a higher-tier ticket.
PRIORITY_TIERS = {"low": 0, "normal": 1, "high": 2}
DEFAULT_PRIORITY = PRIORITY_TIERS["normal"]
_TIER_NAMES = {v: k for k, v in PRIORITY_TIERS.items()}


def parse_priority(value) -> int:
    """Wire/CLI priority value → integer tier: a PRIORITY_TIERS name or
    a non-negative integer (strings of digits accepted)."""
    if isinstance(value, str):
        name = value.strip().lower()
        if name in PRIORITY_TIERS:
            return PRIORITY_TIERS[name]
        if not name.isdigit():
            raise ValueError(
                f"priority must be one of {sorted(PRIORITY_TIERS)} or a "
                f"non-negative integer, got {value!r}"
            )
        return int(name)
    tier = int(value)
    if tier < 0:
        raise ValueError(f"priority must be >= 0, got {value!r}")
    return tier


def tier_name(priority: int) -> str:
    """Human/debug name of an integer tier (falls back to the number)."""
    return _TIER_NAMES.get(priority, str(priority))


# Streaming wire format: Server-Sent Events over chunked
# transfer. Each record is one ``data: <json>`` line followed by a blank
# line (the SSE event separator); the final event's JSON carries the
# full result (``done: true`` + extras/energy payload). The client
# detects the format by Content-Type, falling back to NDJSON line
# records for plain-Ollama servers.
STREAM_CONTENT_TYPE = "text/event-stream"


def sse_event(payload: Dict[str, Any]) -> bytes:
    """Frame one JSON payload as an SSE event. The exact byte shape
    (``data: `` prefix, compact JSON, double newline terminator) is
    pinned by the framing golden test — clients depend on it."""
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode(
        "utf-8"
    ) + b"\n\n"


# Keep-alive comment (SSE spec: a line starting with ``:`` is ignored by
# clients): written during idle prefill gaps — a long chunked join
# produces no deltas for its whole interleaved prefill, and proxies/
# clients with idle timeouts would otherwise drop the stream.
# sse_records() and serve/client.py already skip comment lines, and the
# byte shape is pinned by the framing golden test.
SSE_KEEPALIVE = b": keep-alive\n\n"


def sse_records(lines: Iterable[str]) -> Iterator[Dict[str, Any]]:
    """Parse decoded SSE lines back into JSON records (the inverse of
    :func:`sse_event`, tolerant of multi-``data:``-line events and
    ``:`` comment lines per the SSE spec)."""
    buf: list = []
    for line in lines:
        line = line.rstrip("\r\n")
        if not line:
            if buf:
                yield json.loads("\n".join(buf))
                buf = []
            continue
        if line.startswith("data:"):
            buf.append(line[5:].lstrip())
    if buf:
        yield json.loads("\n".join(buf))


def request_to_wire(
    request: GenerationRequest, stream: bool = False
) -> Dict[str, Any]:
    return {
        "model": request.model,
        "prompt": request.prompt,
        "stream": stream,
        "options": {
            "num_predict": request.max_new_tokens,
            "temperature": request.temperature,
            "top_k": request.top_k,
            "top_p": request.top_p,
            "repeat_penalty": request.repeat_penalty,
            "seed": request.seed,
            **({"stop": list(request.stop)} if request.stop else {}),
        },
        "x_stop_at_eos": request.stop_at_eos,
        **(
            {"x_deadline_ms": request.deadline_ms}
            if request.deadline_ms is not None
            else {}
        ),
        **(
            {"x_priority": request.priority}
            if request.priority != DEFAULT_PRIORITY
            else {}
        ),
        **(
            {"x_tenant": request.tenant}
            if request.tenant != DEFAULT_TENANT
            else {}
        ),
        **(
            {"x_trace": trace_to_wire(request.trace)}
            if request.trace is not None
            else {}
        ),
    }


def request_from_wire(
    body: Dict[str, Any], default_priority: int = DEFAULT_PRIORITY
) -> GenerationRequest:
    if "model" not in body or "prompt" not in body:
        raise ValueError("generate request requires 'model' and 'prompt'")
    options = body.get("options") or {}
    num_predict = int(options.get("num_predict", 128))
    if num_predict < 0:
        num_predict = UNLIMITED_NUM_PREDICT_CAP
    if num_predict > MAX_NUM_PREDICT:
        raise ValueError(
            f"num_predict {num_predict} exceeds the maximum generation "
            f"budget {MAX_NUM_PREDICT}"
        )
    return GenerationRequest(
        model=str(body["model"]),
        prompt=str(body["prompt"]),
        max_new_tokens=num_predict,
        temperature=float(options.get("temperature", 0.0)),
        top_k=int(options.get("top_k", 0)),
        top_p=float(options.get("top_p", 1.0)),
        repeat_penalty=float(options.get("repeat_penalty", 1.0)),
        seed=int(options.get("seed", 0)),
        stop_at_eos=bool(body.get("x_stop_at_eos", True)),
        stop=_stop_from_wire(options.get("stop")),
        deadline_ms=(
            float(body["x_deadline_ms"])
            if body.get("x_deadline_ms") is not None
            else None
        ),
        priority=(
            parse_priority(body["x_priority"])
            if body.get("x_priority") is not None
            else int(default_priority)
        ),
        # tenant parsing is NOT gated on the telemetry kill switch: the
        # request field is protocol state; only the accounting is
        # telemetry (obs/tenants.account_request no-ops when off)
        tenant=_tenant_from_wire(body.get("x_tenant")),
        trace=trace_from_wire(body.get("x_trace")),
    )


def _tenant_from_wire(value) -> str:
    """``x_tenant`` body field → tenant id ("default" when absent).
    Malformed values 400 at the wire like every other x_* field."""
    if value is None:
        return DEFAULT_TENANT
    if not isinstance(value, str) or not value.strip():
        raise ValueError(
            f"x_tenant must be a non-empty string, got {value!r}"
        )
    return value.strip()


def _stop_from_wire(value) -> "tuple[str, ...]":
    """Ollama takes a list; OpenAI-style clients send a bare string — wrap
    it rather than iterating it character-by-character."""
    if value is None:
        return ()
    if isinstance(value, str):
        return (value,)
    return tuple(str(s) for s in value)


def stream_chunk_to_wire(
    model: str, text: str, tokens: "list[int] | None" = None
) -> Dict[str, Any]:
    """One non-final NDJSON record of a streamed generation (Ollama's
    ``stream: true`` wire shape: incremental ``response``, ``done: false``;
    the chunk's new token ids ride in ``x_tokens``)."""
    record: Dict[str, Any] = {"model": model, "response": text, "done": False}
    if tokens:
        record["x_tokens"] = list(tokens)
    return record


def result_to_wire(result: GenerationResult) -> Dict[str, Any]:
    ns = 1_000_000_000
    return {
        "model": result.request.model,
        "response": result.text,
        "done": True,
        "prompt_eval_count": result.prompt_tokens,
        "prompt_eval_duration": int(result.prefill_s * ns),
        "eval_count": result.generated_tokens,
        "eval_duration": int(result.decode_s * ns),
        "total_duration": int(result.total_s * ns),
        "x_tokens": list(result.tokens),
        **({"x_extras": result.extras} if result.extras else {}),
    }


def result_from_wire(
    body: Dict[str, Any], request: GenerationRequest
) -> GenerationResult:
    ns = 1_000_000_000
    prefill_s = float(body.get("prompt_eval_duration", 0)) / ns
    decode_s = float(body.get("eval_duration", 0)) / ns
    total_s = float(body.get("total_duration", 0)) / ns or (prefill_s + decode_s)
    return GenerationResult(
        request=request,
        tokens=[int(t) for t in body.get("x_tokens", [])],
        text=str(body.get("response", "")),
        prompt_tokens=int(body.get("prompt_eval_count", 0)),
        generated_tokens=int(body.get("eval_count", 0)),
        prefill_s=prefill_s,
        decode_s=decode_s,
        total_s=total_s,
        extras=body.get("x_extras"),
    )
