"""HTTP client backend — the experiment-side of the machine boundary.

Replaces the reference's ``curl`` subprocess (experiment/RunnerConfig.py:
128-131) with an in-process stdlib HTTP client that implements the
:class:`~..engine.backend.GenerationBackend` contract, so the experiment's
"remote" treatment is just another backend: the client blocks on the POST
exactly as the reference blocked on curl, and the host-side profilers see
the same network-wait workload. Speaks the Ollama wire format, so it can
also point at a real Ollama server for cross-framework comparison runs.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Iterator, Optional

from ..engine.backend import (
    GenerationBackend,
    GenerationChunk,
    GenerationRequest,
    GenerationResult,
)
from . import protocol


class RemoteServerError(RuntimeError):
    """The generation server answered with an error status."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"server returned {status}: {message}")
        self.status = status


def fetch_flight(
    base_url: str,
    trace: Optional[str] = None,
    n: int = 500,
    type_: Optional[str] = None,
    timeout_s: float = 5.0,
) -> dict:
    """One ``GET /debug/flight`` fetch (``?trace=`` filters by the
    fleet-wide wire trace id): the router's cross-process
    timeline pulls each involved replica's story through this. Raises
    on unreachable/disabled-telemetry replicas; the timeline endpoint
    degrades that hop to an error entry rather than failing whole."""
    from urllib.parse import quote

    query = f"n={int(n)}"
    if trace is not None:
        query += f"&trace={quote(str(trace), safe='')}"
    if type_ is not None:
        query += f"&type={quote(type_, safe='')}"
    url = f"{base_url.rstrip('/')}{protocol.DEBUG_FLIGHT_PATH}?{query}"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


class RemoteHTTPBackend(GenerationBackend):
    def __init__(
        self,
        base_url: str,
        timeout_s: float = 600.0,
        load_timeout_s: float = 1800.0,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.load_timeout_s = load_timeout_s  # weight load + jit compile

    def _post(self, path: str, payload: dict, timeout_s: float) -> dict:
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            try:
                message = json.loads(exc.read().decode("utf-8")).get("error", "")
            except Exception:  # noqa: BLE001
                message = exc.reason
            raise RemoteServerError(exc.code, str(message)) from exc

    def health(self) -> bool:
        try:
            with urllib.request.urlopen(
                f"{self.base_url}{protocol.HEALTH_PATH}", timeout=5.0
            ) as resp:
                return resp.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def list_models(self) -> list:
        with urllib.request.urlopen(
            f"{self.base_url}{protocol.TAGS_PATH}", timeout=self.timeout_s
        ) as resp:
            body = json.loads(resp.read().decode("utf-8"))
        return [m["name"] for m in body.get("models", [])]

    def load_model(self, model: str) -> None:
        try:
            self._post(protocol.LOAD_PATH, {"model": model}, self.load_timeout_s)
        except RemoteServerError as exc:
            if exc.status != 404:
                raise
            # A real Ollama server has no /api/load; a 1-token generate
            # forces the weight load there instead.
            self._ollama_touch(model)

    def warmup(self, request: GenerationRequest) -> None:
        """Server-side load + compile for this request shape, outside the
        measurement window (the reference's Ollama is likewise warm before
        curl fires)."""
        try:
            self._post(
                protocol.LOAD_PATH,
                {
                    "model": request.model,
                    "x_warmup": protocol.request_to_wire(request),
                },
                self.load_timeout_s,
            )
        except RemoteServerError as exc:
            if exc.status != 404:
                raise
            self._ollama_touch(request.model)

    def _ollama_touch(self, model: str) -> None:
        """Warm a plain-Ollama server (404 on our /api/load extension) by
        generating a single token, which loads the model server-side."""
        self._post(
            protocol.GENERATE_PATH,
            protocol.request_to_wire(
                GenerationRequest(model=model, prompt="hi", max_new_tokens=1)
            ),
            self.load_timeout_s,
        )

    def generate(self, request: GenerationRequest) -> GenerationResult:
        t0 = time.monotonic()
        body = self._post(
            protocol.GENERATE_PATH,
            protocol.request_to_wire(request),
            self.timeout_s,
        )
        wall_s = time.monotonic() - t0
        result = protocol.result_from_wire(body, request)
        # Client-side wall time is the measured quantity (the energy of
        # *fetching*): keep the server's prefill/decode split but make
        # total_s the client's wait, network included, matching what the
        # reference's curl wall-clock captured.
        result.total_s = wall_s
        return result

    def generate_stream(
        self, request: GenerationRequest, prime: bool = False
    ) -> Iterator[GenerationChunk]:
        """Stream over the wire: POST with ``stream: true`` and re-yield
        the server's records as :class:`GenerationChunk`s. Our server
        speaks SSE (``text/event-stream``, ``data: <json>`` events —
        detected by Content-Type); plain Ollama servers speak NDJSON
        line records — both parse to the same chunk stream. The final
        record rebuilds the full :class:`GenerationResult` (its text is
        the server's authoritative ``x_text``, falling back to the
        concatenated deltas).

        EARLY CLOSE = SERVER-SIDE CANCELLATION: closing this generator
        (``gen.close()``, breaking out of the loop, or ``with
        contextlib.closing(...)``) closes the HTTP connection; the
        server's next SSE write fails and the continuous scheduler
        retires the row mid-flight (``reason="cancelled"``, pages back
        to the pool) — the wire path tests and the load generator's
        ``--cancel-frac`` exercise exactly this.

        ``prime=True`` stamps ``x_prime`` on the wire body:
        the server runs prefill to completion and exports the row — a
        successful prime streams NO deltas, just the final record whose
        ``x_extras["migrate"]`` carries the bundle; a server that
        cannot prime streams the full answer instead."""
        t0 = time.monotonic()
        payload = protocol.request_to_wire(request, stream=True)
        if prime:
            payload[protocol.PRIME_KEY] = True
        text_parts = []
        records = self._stream_records(protocol.GENERATE_PATH, payload)
        for record in records:
            if "error" in record:
                # Mid-stream backend failure, surfaced by the server
                # as a terminal error record.
                raise RemoteServerError(500, str(record["error"]))
            if record.get("done"):
                result = protocol.result_from_wire(record, request)
                # x_text is the server's authoritative full decode
                # (per-chunk deltas can split multi-byte UTF-8);
                # fall back to the concatenated deltas for plain
                # Ollama servers that don't send it.
                result.text = str(
                    record.get("x_text", "".join(text_parts))
                )
                result.total_s = time.monotonic() - t0
                yield GenerationChunk(
                    text="", tokens=[], done=True, result=result
                )
            else:
                delta = str(record.get("response", ""))
                text_parts.append(delta)
                yield GenerationChunk(
                    text=delta,
                    tokens=[int(t) for t in record.get("x_tokens", [])],
                )

    def _stream_records(self, path: str, payload: dict) -> Iterator[dict]:
        """POST ``payload`` and yield the response's parsed stream
        records (SSE by Content-Type, NDJSON fallback) — the shared
        wire-reader under generate_stream and migrate_stream."""
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            f"{self.base_url}{path}",
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                content_type = resp.headers.get("Content-Type", "")
                lines = (raw.decode("utf-8") for raw in resp)
                if content_type.startswith(protocol.STREAM_CONTENT_TYPE):
                    records = protocol.sse_records(lines)
                else:  # plain-Ollama NDJSON fallback
                    records = (
                        json.loads(line)
                        for line in (ln.strip() for ln in lines)
                        if line
                    )
                for record in records:
                    yield record
        except urllib.error.HTTPError as exc:
            try:
                message = json.loads(exc.read().decode("utf-8")).get("error", "")
            except Exception:  # noqa: BLE001
                message = exc.reason
            raise RemoteServerError(exc.code, str(message)) from exc

    def migrate_stream(self, bundle: dict) -> Iterator[GenerationChunk]:
        """Ship one primed/evacuated row bundle to ``/api/migrate``
        and yield the seated row's chunks — the same shapes
        generate_stream yields, so the router relays either
        interchangeably. The request the chunks answer is rebuilt from
        the bundle's embedded wire request."""
        request = protocol.request_from_wire(dict(bundle["request"]))
        t0 = time.monotonic()
        text_parts = []
        for record in self._stream_records(protocol.MIGRATE_PATH, bundle):
            if "error" in record:
                raise RemoteServerError(500, str(record["error"]))
            if record.get("done"):
                result = protocol.result_from_wire(record, request)
                result.text = str(
                    record.get("x_text", "".join(text_parts))
                )
                result.total_s = time.monotonic() - t0
                yield GenerationChunk(
                    text="", tokens=[], done=True, result=result
                )
            else:
                delta = str(record.get("response", ""))
                text_parts.append(delta)
                yield GenerationChunk(
                    text=delta,
                    tokens=[int(t) for t in record.get("x_tokens", [])],
                )

    def evacuate(self, timeout_s: float = 30.0) -> int:
        """``POST /admin/evacuate``: ask the replica to export every
        exportable in-flight row; returns the evacuated-row count."""
        body = self._post(
            f"{protocol.ADMIN_EVACUATE_PATH}?timeout={timeout_s:g}",
            {},
            timeout_s + 30.0,
        )
        return int(body.get("evacuated", 0))

    def unload_all(self) -> None:  # nothing held client-side
        return None


def backend_from_env(
    env_var: str = "SERVER_IP", port: Optional[int] = None
) -> Optional[RemoteHTTPBackend]:
    """Build a client from the reference's ``.env`` convention: ``SERVER_IP``
    names the serving host (experiment/RunnerConfig.py:125-126). Accepts a
    bare IP/host (reference form) or a full ``http://host:port`` URL."""
    import os

    from ..utils.env import load_dotenv

    load_dotenv()
    value = os.environ.get(env_var)
    if not value:
        return None
    if not value.startswith("http"):
        value = f"http://{value}:{port or protocol.DEFAULT_PORT}"
    return RemoteHTTPBackend(value)
