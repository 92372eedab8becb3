"""CI smoke of the PyTorch port's serving stack: fake-engine server end
to end + /metrics scrape + span trace. The port's copy of
``scripts/serve_metrics_smoke.py``: the same phases, positional outputs
and status line over the port's fake backend, server, router, ``obs``
families, prefix store and model fleet; phase 7's sharded engine is the
port's ``parallel/tp.py::TensorParallelEngine`` over two CPU shards.

Three phases, all over the deterministic fake backend:

1. WINDOW batching: one request through the full HTTP → scheduler →
   backend path, scrape ``GET /metrics``, assert the scheduler/HTTP
   metric families are present, and export the recorded span tree as a
   Chrome trace (the workflow uploads it as an artifact, so every CI run
   leaves an inspectable serving trace).
2. CONTINUOUS (iteration-level) batching under STAGGERED arrivals: a
   long-budget request anchors a decode session, short requests arrive
   mid-flight and JOIN it, and the scrape asserts the join/retire
   counters (``llm_sched_rows_joined_total``,
   ``llm_sched_rows_retired_total``) and the in-flight gauge family
   moved — the observability surface of the admit/step/retire loop.
3. CHUNKED JOIN-PREFILL: a LONG-PROMPT request joins a running session
   and its prefill streams in as token-budgeted chunks interleaved with
   the anchor's decode slices (``--prefill-chunk-tokens``); the scrape
   asserts the chunk counters moved (``llm_sched_join_chunks_total`` by
   several chunks, ``llm_sched_join_prefill_seconds`` per chunk,
   ``llm_sched_decode_stall_seconds`` — the bounded stall the in-flight
   anchor actually paid) and the joiner's wire result attributes its
   TTFT across the chunks (``extras.sched.join_chunks``).
4. DEBUG INTROSPECTION + FLIGHT RECORDER: drive the continuous fake
   server again, scrape ``GET /debug/state`` mid-flight (live session
   rows / queue depth / flight summary) and ``GET /debug/flight`` after,
   and assert the structured event log tells the request's story in
   ORDER — admitted → slice(s) → retired — with trace ids matching the
   joined ticket's admitted/join-chunk/retired events; the flight dump
   is written next to the span trace (the workflow uploads both).
5. STREAMING DELIVERY + CANCELLATION: stream a long request
   over SSE from the continuous fake server, KILL the client after a
   few delta events, and assert the server retired the row — the
   ``row_retired{reason="cancelled"}`` flight event fired,
   ``llm_sched_rows_retired_total{reason="cancelled"}`` moved on
   ``/metrics``, the stream counters
   (``llm_stream_requests_total``/``llm_stream_chunks_total``/
   ``llm_stream_cancelled_total``) are live, and ``/debug/state`` shows
   the session's slots recycled (no in-flight rows left behind).
6. SHARED-PREFIX PAGING: two staggered requests sharing a
   system-prompt prefix through the continuous fake server
   (``FakeBackend(prefix_share=True)``, the hermetic twin of
   ``TorchEngine(prefix_share=True)``); assert
   ``llm_prefix_hit_tokens_total`` moved, the shared-page gauge
   (``llm_prefix_shared_pages``) ROSE mid-flight and returned to zero
   after both rows retired, and the ``prefix_hit`` flight event fired
   linked to the joined ticket's trace.

7. SHARDED CONTINUOUS SERVING: the fake-free path — a REAL
   ``TensorParallelEngine`` (tiny model, paged KV) on a 2-shard mesh
   whose shards are both the CPU, behind the continuous scheduler. Two staggered
   requests serve token-for-token through the sharded stepped session
   (the second joins mid-flight); the scrape asserts the ``llm_sched_*``
   counters moved (session opened, rows retired) and ``/debug/state``
   reports the MESH — shape at the top level and under the scheduler's
   ``backend_mesh``, and (probed mid-flight) the live session's
   per-device pool occupancy from the carry's committed shardings.

8. BATCHED SPECULATIVE DECODING: the fake backend speaks the
   spec protocol with configurable synthetic acceptance
   (``FakeBackend(spec_k=4, spec_acceptance=0.75)``): assert the
   ``llm_spec_*`` counters moved with the exact synthetic arithmetic,
   the live session's ``/debug/state`` rows carry the per-row
   ``spec_rounds``/``spec_accepted`` fields, and — on a second server
   with acceptance 0 under ``spec_accept_floor`` — the AUTO-FALLBACK
   fires (``llm_spec_fallback_total`` + the ``spec_fallback`` flight
   event carrying the floor).

9. SLO TIERS + MID-FLIGHT PREEMPTION: two long LOW-tier
   requests fill a 2-row fake session; a HIGH-tier request
   (``x_priority: "high"``) arrives and must be admitted by PREEMPTING
   the youngest low-tier row (swap policy — simulated KV bytes move to
   host). Asserts the ``preempted``/``resumed`` flight events (trace-
   linked to both tickets), ``llm_sched_preempted_total{policy}`` /
   ``llm_sched_resumed_total``, ``llm_swap_bytes_total{direction}``
   moving symmetrically, the mid-flight ``/debug/state`` showing
   per-tier queue depths + the parked victim + non-zero session swap
   accounting, the victim COMPLETING after resume with its full
   stream, and the host-residency gauges returning exactly to zero.

10. REPLICA-FLEET ROUTING: a 2-replica fake fleet behind the
    front-door router (``serve/router.py``): dispatch counters split
    across both replicas (``llm_router_dispatch_total{replica,...}``
    and the per-request ``x_extras.router`` attribution agree); one
    replica's engine is KILLED mid-trace while a long accepted stream
    is still in flight on it — the stream completes in full (zero
    accepted tickets lost), the next ticket routed to the dead replica
    is retried ONCE onto the survivor
    (``llm_router_retries_total``), the ``replica_down`` flight event
    fires and ``llm_router_replica_healthy`` drops to 0; then the
    survivor DRAINS cleanly (``replica_drained`` event, membership
    shrinks) and a final request is shed 503 with nobody healthy left.

11. FLEET-WIDE OBSERVABILITY: two fake continuous servers
    reached OVER THE WIRE as RemoteReplicas behind the front-door
    router (the ``serve-fleet`` shape). Two long low-tier requests
    saturate replica B's 2-row session; replica A's engine is killed;
    a caller-traced high-tier stream dispatched through the router
    lands on dead A, is retried onto B, and preempts a low row there.
    Asserts: BOTH dispatch attempts share ONE trace id (attempts 1, 2
    in order); ``GET /debug/timeline?trace=`` reconstructs the story
    in order (dispatched → retry dispatched → admitted (queue wait
    attached) → stream chunks → retired) and the VICTIM's trace shows
    preempted → resumed in order; the router ``/metrics`` carries
    ``llm_fleet_*`` rollups whose counters equal the sum of the
    individual replica scrapes (merged by the same
    ``merge_expositions`` the golden test pins); and
    ``llm_request_wasted_joules_total{cause="retry"}`` moved, with the
    same figure riding the retried ticket's ``x_extras.energy``.

12. PERSISTENT CROSS-SESSION PREFIX STORE: two SEQUENTIAL
    fake-server sessions — the second session's joiner hits the
    backend-owned store, a tightened HBM budget forces spills, and a
    later request restores the spilled entry (all events trace-linked).

13. MULTI-MODEL FLEET SERVING: two fake models behind ONE
    server in fleet mode (``--model-policy small-first``). A long
    big-model decode anchors its lane while two small-model requests
    retire CONCURRENTLY on theirs (no cross-model head-of-line
    blocking; ``llm_sched_batch_fallback_total`` stays flat on the
    mixed trace); a ``model: "auto"`` request runs the small-first
    cascade and ESCALATES — ``llm_request_wasted_joules_total
    {cause="escalation"}`` moves with the same figure riding
    ``x_extras.energy`` and the ``model_escalated`` flight event
    fires; a FORCED weight eviction shows up on ``/api/ps`` and as a
    ``model_evicted`` flight event.

14. SAMPLED SPECULATION + DRAFT SOURCES: the fake backend
    speaks the spec protocol extensions — a separate synthetic
    acceptance for SAMPLED rows (``spec_sampled_acceptance``) and a
    configurable draft source labelling every ``llm_spec_*`` family.
    One cross-source server (``spec_source="cross"``,
    ``spec_draft="small:1b"``) serves a healthy greedy row (labelled
    counters move under ``source="cross"``) then a sampled row at
    acceptance 0 under a floor: the per-source fallback fires
    (``llm_spec_fallback_total{source="cross"}`` + the flight event
    carrying the source), the fully-rejected rounds' draft tokens are
    billed to ``llm_request_wasted_joules_total{cause="draft"}`` at the
    draft model's J/token, and the SAME figure rides the wire as
    ``x_extras.spec.draft_wasted_J``. A second ngram-source server pins
    the zero-weight label (``source="ngram"``, no draft model on the
    wire).

15. WINDOWED TELEMETRY + SLO ALERTING: a 2-replica local
    fake fleet behind the router with ``--slo`` objectives and
    compressed burn windows. Asserts the ``/debug/timeseries`` fleet
    rollup's counter delta equals the hand-computed difference of two
    ``/metrics`` scrapes; a mixed workload breaches the completion
    contract and the burn-rate alert FIRES within one fast window
    (``slo_alert{state=firing}`` flight event, episode trace id);
    the router's ``llm_slo_attainment`` gauge is BYTE-consistent with
    recomputing attainment from the per-replica ``/debug/timeseries``
    bucket deltas; idling past the slow window RESOLVES the alert on
    the same trace id; the ring dump lands as a CI artifact
    (``serve_timeseries.json``).

Usage: ``python scripts/torch_serve_metrics_smoke.py [trace_out.json]
[flight_out.json] [timeseries_out.json]``
Exit 0 on success; prints one JSON status line either way.
"""

import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _post_generate(
    base: str, prompt: str, num_predict: int, priority=None,
    model: str = "smoke:1b", trace=None,
):
    body = {
        "model": model,
        "prompt": prompt,
        "options": {"num_predict": num_predict},
    }
    if priority is not None:
        body["x_priority"] = priority
    if trace is not None:
        body["x_trace"] = {"id": trace}
    req = urllib.request.Request(
        f"{base}/api/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _scrape(base: str) -> str:
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as resp:
        return resp.read().decode()


def _metric_value(text: str, name: str) -> float:
    """Sum of a family's samples (labelled children sum together)."""
    total, seen = 0.0, False
    for line in text.splitlines():
        m = re.match(rf"^{re.escape(name)}(\{{[^}}]*\}})? ([0-9.e+-]+)$", line)
        if m:
            total += float(m.group(2))
            seen = True
    if not seen:
        raise AssertionError(f"metric family {name} absent from /metrics")
    return total


def _get_json(base: str, path: str):
    with urllib.request.urlopen(f"{base}{path}", timeout=10) as resp:
        return json.loads(resp.read())


# The phases that stagger arrivals release each later request once the
# rows before it are live, never after a sleep: a sleep races the fake
# decode, and a loaded host loses that race.
def _wait_live(base: str, rows: int = 1, lane=None, timeout_s: float = 10.0):
    """Poll ``/debug/state`` until ``rows`` rows are live (admitted and
    decoding) in the continuous scheduler — in ``lane``'s lane when the
    server runs a model fleet — and return that snapshot."""
    deadline = time.monotonic() + timeout_s
    while True:
        state = _get_json(base, "/debug/state")
        sched = state.get("scheduler") or {}
        if lane is not None:
            sched = (sched.get("lanes") or {}).get(lane) or {}
        if len(sched.get("inflight") or []) >= rows:
            return state
        assert time.monotonic() < deadline, (
            f"{rows} rows never went live: {sched}"
        )
        time.sleep(0.01)


def _retire_order(base: str, traces) -> dict:
    """The flight-recorder ``seq`` of each trace's ``row_retired`` event:
    the order in which the scheduler retired those rows."""
    events = _get_json(base, "/debug/flight?n=500&type=row_retired")[
        "events"
    ]
    seq = {
        e["trace_id"]: e["seq"] for e in events if e.get("trace_id") in traces
    }
    assert set(seq) == set(traces), (traces, events[-10:])
    return seq


def _run_threads(threads, timeout_s: float = 30.0) -> None:
    """Start ``threads`` and join each within ``timeout_s``."""
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
        assert not t.is_alive(), f"{t.name} still runs after {timeout_s} s"


def main() -> int:
    trace_out = sys.argv[1] if len(sys.argv) > 1 else "serve_trace.json"
    flight_out = sys.argv[2] if len(sys.argv) > 2 else "serve_flight.json"
    ts_out = sys.argv[3] if len(sys.argv) > 3 else "serve_timeseries.json"

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import (
        FakeBackend,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.trace import (
        TRACER,
        mint_trace_id,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.server import (
        GenerationServer,
    )

    # -- phase 1: window batching, span tree, base families -------------------
    server = GenerationServer(
        FakeBackend(),
        host="127.0.0.1",
        port=0,
        quiet=True,
        batch_window_ms=20,
        scheduler="window",
    )
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        body = _post_generate(base, "hello", 8)
        assert body.get("done") and body.get("eval_count") == 8, body

        text = _scrape(base)
        required = (
            "llm_http_requests_total",
            "llm_http_request_seconds",
            "llm_sched_queue_wait_seconds",
            "llm_sched_batch_rows",
            "llm_request_ttft_seconds",
            "llm_request_completion_seconds",
        )
        missing = [f for f in required if f not in text]
        assert not missing, f"missing metric families: {missing}"

        spans = TRACER.spans()
        names = {s.name for s in spans}
        assert {"request", "queue"} <= names, names
        TRACER.export(trace_out, spans)
    finally:
        server.stop()

    # -- phase 2: continuous batching under staggered arrivals ----------------
    # A long row anchors the decode session (256 tokens at 200 tok/s ≈
    # 1.3 s of slices); two short requests arrive once it is live, must
    # JOIN it, retire EARLY — before the anchor, by the flight recorder's
    # order of row_retired events — and show up on the join/retire
    # counters.
    server2 = GenerationServer(
        FakeBackend(tokens_per_s=200.0, simulate_delay=True),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server2.start()
    try:
        base2 = f"http://127.0.0.1:{server2.port}"
        traces2 = {
            name: mint_trace_id() for name in ("anchor", "join-a", "join-b")
        }
        done2 = set()

        def client(name, num_predict):
            body = _post_generate(
                base2, name, num_predict, trace=traces2[name]
            )
            assert body.get("done"), body
            done2.add(name)

        anchor2 = threading.Thread(target=client, args=("anchor", 256))
        anchor2.start()
        _wait_live(base2)
        _run_threads(
            [
                threading.Thread(target=client, args=(name, 8))
                for name in ("join-a", "join-b")
            ]
        )
        anchor2.join(timeout=30)
        assert done2 == {"anchor", "join-a", "join-b"}, done2
        # early retirement: the joined short rows retired BEFORE the
        # anchor's long decode drained
        order2 = _retire_order(base2, set(traces2.values()))
        assert order2[traces2["join-a"]] < order2[traces2["anchor"]], order2
        assert order2[traces2["join-b"]] < order2[traces2["anchor"]], order2

        text2 = _scrape(base2)
        joined = _metric_value(text2, "llm_sched_rows_joined_total")
        retired = _metric_value(text2, "llm_sched_rows_retired_total")
        assert joined >= 2, f"expected >= 2 mid-flight joins, saw {joined}"
        assert retired >= 3, f"expected >= 3 retirements, saw {retired}"
        assert "llm_sched_inflight_rows" in text2
    finally:
        server2.stop()

    # -- phase 3: chunked join-prefill of a long-prompt joiner -----------------
    # The anchor decodes 256 tokens (~0.64 s of slices at 400 tok/s); a
    # ~300-token-prompt request arrives once it is live and must join in
    # MULTIPLE 64-token prefill chunks, each interleaved between decode
    # slices. Counters are process-global and monotonic, so phase-3
    # assertions are on DELTAS over the pre-phase scrape.
    chunks_before = _metric_value(text2, "llm_sched_join_chunks_total")
    joined_before = _metric_value(text2, "llm_sched_rows_joined_total")
    server3 = GenerationServer(
        FakeBackend(tokens_per_s=400.0, simulate_delay=True),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
        prefill_chunk_tokens=64,
    )
    server3.start()
    try:
        base3 = f"http://127.0.0.1:{server3.port}"
        bodies = {}

        def client3(name, prompt, num_predict):
            bodies[name] = _post_generate(base3, prompt, num_predict)

        anchor3 = threading.Thread(
            target=client3, args=("anchor", "anchor", 256)
        )
        anchor3.start()
        _wait_live(base3)
        client3("long-join", "j" * 300, 8)
        anchor3.join(timeout=30)
        assert set(bodies) == {"anchor", "long-join"}, bodies
        assert all(b.get("done") for b in bodies.values()), bodies
        sched3 = (bodies["long-join"].get("x_extras") or {}).get("sched", {})

        text3 = _scrape(base3)
        join_chunks = (
            _metric_value(text3, "llm_sched_join_chunks_total") - chunks_before
        )
        joined3 = (
            _metric_value(text3, "llm_sched_rows_joined_total") - joined_before
        )
        # 301 prompt tokens at a 64-token chunk budget = 5 chunks
        assert joined3 >= 1, f"expected a mid-flight join, saw {joined3}"
        assert join_chunks >= 3, (
            f"expected a multi-chunk join prefill, saw {join_chunks} chunks"
        )
        assert "llm_sched_join_prefill_seconds" in text3
        assert "llm_sched_decode_stall_seconds" in text3
        # TTFT attribution across chunks rides the wire per request
        assert sched3.get("joined") is True, sched3
        assert sched3.get("join_chunks", 0) >= 3, sched3
        assert sched3.get("ttft_s", 0) > 0, sched3
    finally:
        server3.stop()

    # -- phase 4: debug introspection + flight recorder ------------------------
    # Drive the continuous scheduler once more; scrape /debug/state
    # MID-FLIGHT (a live session must show in-flight rows) and
    # /debug/flight after, asserting the event log is ordered and its
    # trace ids link the joined ticket's admitted → retired story.
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.flight import (
        FLIGHT,
    )

    server4 = GenerationServer(
        FakeBackend(tokens_per_s=200.0, simulate_delay=True),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server4.start()
    try:
        base4 = f"http://127.0.0.1:{server4.port}"
        anchor4 = threading.Thread(
            target=lambda: _post_generate(base4, "dbg-anchor", 128)
        )
        anchor4.start()
        # the snapshot taken once the anchor's row is live is mid-flight
        # by construction (the anchor's ~0.64 s session is running)
        mid_state = _wait_live(base4)
        _post_generate(base4, "dbg-join", 8)
        anchor4.join(timeout=30)
        assert not anchor4.is_alive(), "the phase-4 anchor never returned"

        # live snapshot: scheduler mode, a running session with rows,
        # and the flight summary rode along
        assert mid_state.get("scheduler_mode") == "continuous", mid_state
        sched_state = mid_state.get("scheduler") or {}
        assert sched_state.get("mode") == "continuous", sched_state
        session_state = sched_state.get("session") or {}
        assert session_state.get("active", 0) >= 1, sched_state
        assert mid_state.get("flight", {}).get("events_total", 0) > 0

        flight = _get_json(base4, "/debug/flight?n=500")
        events = flight["events"]
        assert events == sorted(events, key=lambda e: e["seq"]), (
            "flight events not seq-ordered"
        )
        by_type = {}
        for e in events:
            by_type.setdefault(e["type"], []).append(e)
        for needed in ("request_admitted", "slice", "row_retired"):
            assert by_type.get(needed), f"no {needed} events in {flight}"

        # trace linkage: the joined ticket's admitted and retired events
        # carry ONE trace id, and its admission precedes its retirement
        joined_admits = [
            e for e in by_type["request_admitted"] if e.get("joined")
        ]
        assert joined_admits, by_type["request_admitted"]
        ja = joined_admits[-1]
        retire = [
            e
            for e in by_type["row_retired"]
            if e.get("trace") == ja.get("trace")
        ]
        assert ja.get("trace") is not None and retire, (ja, by_type)
        assert ja["seq"] < retire[0]["seq"], (ja, retire)
        # slice events belong to the anchor's trace and bracket the join
        anchor_slices = [
            e for e in by_type["slice"] if e.get("trace") is not None
        ]
        assert anchor_slices, by_type["slice"]

        # the flight dump artifact: last events + live state, the same
        # shape the scheduler writes on a batch/session failure
        dump_path = FLIGHT.crash_dump(
            "smoke: exported flight dump artifact",
            state=_get_json(base4, "/debug/state"),
            path=flight_out,
        )
        assert dump_path, "flight dump failed to write"
    finally:
        server4.stop()

    # -- phase 5: streaming delivery + mid-stream client disconnect ------------
    # A 600-token request streams over SSE; the client hangs up after a
    # handful of delta events. The scheduler must notice within a slice,
    # retire the row (reason="cancelled"), and leave the session clean.
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
        GenerationRequest,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import (
        RemoteHTTPBackend,
    )

    server5 = GenerationServer(
        FakeBackend(tokens_per_s=300.0, simulate_delay=True),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server5.start()
    try:
        base5 = f"http://127.0.0.1:{server5.port}"
        cancelled_before = 0
        try:
            cancelled_before = _metric_value(
                _scrape(base5), "llm_sched_rows_retired_total"
            )
        except AssertionError:
            pass
        client5 = RemoteHTTPBackend(base5)
        stream = client5.generate_stream(
            GenerationRequest("smoke:1b", "s" * 40, max_new_tokens=600)
        )
        delivered = 0
        for chunk in stream:
            delivered += len(chunk.tokens)
            if delivered >= 8:
                break
        stream.close()  # the disconnect under test

        # the retirement lands within a slice or two; poll briefly
        deadline = time.monotonic() + 10.0
        cancelled_seen = 0.0
        while time.monotonic() < deadline:
            text5 = _scrape(base5)
            cancelled_lines = [
                ln
                for ln in text5.splitlines()
                if ln.startswith("llm_sched_rows_retired_total")
                and 'reason="cancelled"' in ln
            ]
            if cancelled_lines:
                cancelled_seen = float(cancelled_lines[0].rsplit(" ", 1)[1])
                if cancelled_seen >= 1:
                    break
            time.sleep(0.05)
        assert cancelled_seen >= 1, (
            f"no cancelled retirement on /metrics "
            f"(before={cancelled_before}): {text5[:2000]}"
        )
        # streaming egress counters are live
        assert _metric_value(text5, "llm_stream_requests_total") >= 1
        assert _metric_value(text5, "llm_stream_chunks_total") >= 1
        assert _metric_value(text5, "llm_stream_cancelled_total") >= 1

        # the cancellation flight event fired, linked to a trace
        flight5 = _get_json(
            base5, "/debug/flight?n=500&type=row_retired"
        )
        cancelled_events = [
            e for e in flight5["events"] if e.get("reason") == "cancelled"
        ]
        assert cancelled_events, flight5["events"][-10:]

        # the session recycled the row: /debug/state shows no in-flight
        # rows left behind (slots free for the next joiner)
        state5 = _get_json(base5, "/debug/state")
        sched5 = state5.get("scheduler") or {}
        inflight5 = sched5.get("inflight") or []
        assert not inflight5, sched5
        session5 = sched5.get("session")
        if session5:  # session may have drained and closed entirely
            assert session5.get("active", 0) == 0, session5
            assert session5.get("free_slots") == session5.get("b_bucket"), (
                session5
            )
    finally:
        server5.stop()

    # -- phase 6: shared-prefix paging through the continuous scheduler --------
    # Two staggered requests share a system-prompt prefix; the joiner's
    # admission must register a prefix HIT (tokens counter + flight
    # event linked to its trace), and the shared-page gauge must rise
    # while the sharers are live and return to ZERO once both retired.
    server6 = GenerationServer(
        FakeBackend(tokens_per_s=200.0, simulate_delay=True, prefix_share=True),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server6.start()
    try:
        base6 = f"http://127.0.0.1:{server6.port}"
        try:
            hits_before = _metric_value(
                _scrape(base6), "llm_prefix_hit_tokens_total"
            )
        except AssertionError:
            hits_before = 0.0
        sys_prefix = "you are a helpful assistant; answer briefly. "
        mid6 = {"shared_peak": 0.0}
        posts6 = [
            threading.Thread(
                target=_post_generate, args=(base6, sys_prefix + "anchor", 128)
            ),
            threading.Thread(
                target=_post_generate, args=(base6, sys_prefix + "join me", 48)
            ),
        ]

        def probe6():
            # poll the shared-page gauge across the whole flight: it
            # rises when the joiner commits (the exact moment races the
            # decode slices, so a single snapshot would be flaky)
            deadline6 = time.monotonic() + 10.0
            while (
                any(t.is_alive() for t in posts6)
                and time.monotonic() < deadline6
            ):
                try:
                    mid6["shared_peak"] = max(
                        mid6["shared_peak"],
                        _metric_value(
                            _scrape(base6), "llm_prefix_shared_pages"
                        ),
                    )
                except AssertionError:
                    pass  # gauge not touched yet
                time.sleep(0.02)

        posts6[0].start()
        _wait_live(base6)
        _run_threads([posts6[1], threading.Thread(target=probe6)])
        posts6[0].join(timeout=30)
        assert not posts6[0].is_alive(), "the phase-6 anchor never returned"

        text6 = _scrape(base6)
        hit_tokens = (
            _metric_value(text6, "llm_prefix_hit_tokens_total") - hits_before
        )
        assert hit_tokens > 0, f"no prefix hit tokens: {text6[:1500]}"
        shared_mid = mid6["shared_peak"]
        assert shared_mid > 0, "shared-page gauge never rose mid-flight"
        shared_after = _metric_value(text6, "llm_prefix_shared_pages")
        assert shared_after == 0, (
            f"shared-page gauge stuck at {shared_after} after retirement"
        )

        flight6 = _get_json(base6, "/debug/flight?n=500&type=prefix_hit")
        prefix_hits = flight6["events"]
        assert prefix_hits, "no prefix_hit flight event"
        # trace linkage: the hit belongs to the JOINED ticket's story
        admits6 = _get_json(
            base6, "/debug/flight?n=500&type=request_admitted"
        )["events"]
        joined_traces = {
            e.get("trace") for e in admits6 if e.get("joined")
        }
        assert any(
            e.get("trace") in joined_traces for e in prefix_hits
        ), (prefix_hits, admits6)
    finally:
        server6.stop()

    # -- phase 7: sharded continuous serving on a 2-shard CPU mesh ------------
    # The fake-free path: a REAL TP engine (tiny model, paged KV pool)
    # behind the continuous scheduler. The point is end-to-end SPMD
    # cleanliness — HTTP → scheduler → sharded stepped session → tokens —
    # plus the mesh-aware debug surface.
    import dataclasses as _dc

    import torch as _torch

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
        get_model_config,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.tp import (
        TensorParallelEngine,
    )

    tiny = _dc.replace(
        get_model_config("qwen2:1.5b").tiny(),
        n_heads=8, n_kv_heads=8, d_ff=128, d_model=64, d_head=16,
    )
    tp_backend = TensorParallelEngine(
        mesh=build_mesh(MeshSpec.tp_only(), devices=[_torch.device("cpu")] * 2),
        registry={tiny.name: tiny},
        dtype=_torch.float32,
        paged_kv=True,
    )
    server7 = GenerationServer(
        tp_backend,
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server7.start()
    try:
        base7 = f"http://127.0.0.1:{server7.port}"
        pre7 = _scrape(base7)
        sessions_before = _metric_value(pre7, "llm_sched_batches_total")
        retired_before = _metric_value(pre7, "llm_sched_rows_retired_total")
        # idle probe: the mesh is visible even with no live session
        idle_state = _get_json(base7, "/debug/state")
        assert idle_state["mesh"]["devices"] == 2, idle_state.get("mesh")
        assert idle_state["mesh"]["axes"] == {"tp": 2}
        assert (
            idle_state["scheduler"]["backend_mesh"]["devices"] == 2
        ), idle_state["scheduler"].get("backend_mesh")

        mid7 = {}

        def probe7():
            # poll /debug/state while the anchor decodes: the live
            # session must report the mesh and the pool's per-device
            # occupancy (bytes from the carry's committed shardings)
            deadline7 = time.monotonic() + 60.0
            while time.monotonic() < deadline7 and "per_device" not in mid7:
                try:
                    st = _get_json(base7, "/debug/state")
                    sess_st = (st.get("scheduler") or {}).get("session")
                    if sess_st and sess_st.get("mesh"):
                        mid7["session_mesh"] = sess_st["mesh"]
                        if (sess_st.get("pool") or {}).get("per_device"):
                            mid7["per_device"] = sess_st["pool"]["per_device"]
                except Exception:
                    pass
                time.sleep(0.05)

        # phase-7 posts use the tiny model's name, not the fake's
        def _post7(prompt, n):
            req = urllib.request.Request(
                f"{base7}/api/generate",
                data=json.dumps(
                    {
                        "model": tiny.name,
                        "prompt": prompt,
                        "options": {"num_predict": n},
                    }
                ).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())

        anchor7 = threading.Thread(target=_post7, args=("sharded anchor", 96))
        anchor7.start()
        _wait_live(base7, timeout_s=120.0)
        _run_threads(
            [
                threading.Thread(
                    target=_post7, args=("mid-flight joiner", 32)
                ),
                threading.Thread(target=probe7),
            ],
            timeout_s=180.0,
        )
        anchor7.join(timeout=180)
        assert not anchor7.is_alive(), "the sharded anchor never returned"

        text7 = _scrape(base7)
        sessions7 = (
            _metric_value(text7, "llm_sched_batches_total") - sessions_before
        )
        retired7 = (
            _metric_value(text7, "llm_sched_rows_retired_total")
            - retired_before
        )
        assert sessions7 >= 1, "no continuous session opened on the mesh"
        assert retired7 >= 2, f"expected 2 sharded rows retired, got {retired7}"
        assert mid7.get("session_mesh", {}).get("devices") == 2, (
            f"live session never reported the mesh: {mid7}"
        )
        per_device = mid7.get("per_device") or {}
        assert per_device.get("bytes", 0) > 0, (
            f"no per-device pool occupancy reported: {mid7}"
        )
        assert per_device.get("occupancy", 0) > 0
    finally:
        server7.stop()

    # -- phase 8: batched speculative decoding -----------------------
    # FakeBackend speaks the spec protocol with configurable synthetic
    # acceptance: drive the continuous fake server, assert the llm_spec_*
    # counters moved, the spec fields surface in /debug/state's live
    # session rows, and — on a second server with acceptance 0 and a
    # floor — the auto-fallback fires (llm_spec_fallback_total + the
    # spec_fallback flight event).
    server8 = GenerationServer(
        FakeBackend(
            tokens_per_s=400.0, simulate_delay=True,
            spec_k=4, spec_acceptance=0.75,
        ),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server8.start()
    try:
        base8 = f"http://127.0.0.1:{server8.port}"
        pre8 = _scrape(base8)

        def delta8(text_now, name):
            try:
                before = _metric_value(pre8, name)
            except AssertionError:
                before = 0.0
            return _metric_value(text_now, name) - before

        mid8 = {}

        def probe8():
            deadline8 = time.monotonic() + 30.0
            while time.monotonic() < deadline8 and "row" not in mid8:
                try:
                    st = _get_json(base8, "/debug/state")
                    sess_st = (st.get("scheduler") or {}).get("session")
                    rows = (sess_st or {}).get("rows") or []
                    specced = [
                        r for r in rows if r.get("spec_rounds", 0) > 0
                    ]
                    if specced and (sess_st or {}).get("spec"):
                        mid8["row"] = specced[0]
                        mid8["spec"] = sess_st["spec"]
                except Exception:
                    pass
                time.sleep(0.01)

        t_probe8 = threading.Thread(target=probe8)
        t_probe8.start()
        # spec advancement is 1 + 3 accepted per round: a 512-token row
        # spans many slices, so the probe catches it live
        body8 = _post_generate(base8, "speculative row", 512)
        t_probe8.join(timeout=40)
        assert body8.get("done"), body8
        text8 = _scrape(base8)
        rounds8 = delta8(text8, "llm_spec_rounds_total")
        accepted8 = delta8(text8, "llm_spec_tokens_accepted_total")
        drafted8 = delta8(text8, "llm_spec_tokens_drafted_total")
        assert rounds8 >= 1, f"no spec rounds recorded: {rounds8}"
        assert drafted8 >= 4 * rounds8, (rounds8, drafted8)
        assert accepted8 == 3 * rounds8, (rounds8, accepted8)
        assert "llm_spec_acceptance_rate" in text8
        # the native page-resident verify is the only verify
        # mode left — its migration counter must move with the rounds
        native8 = delta8(text8, "llm_spec_verify_native_total")
        assert native8 >= rounds8, (
            f"native verify counter lagged rounds: {native8} < {rounds8}"
        )
        assert mid8.get("row", {}).get("spec_rounds", 0) > 0, (
            f"live session rows never showed spec fields: {mid8}"
        )
        assert mid8["spec"]["active"] and mid8["spec"]["k"] == 4, mid8
        assert mid8["spec"].get("verify_mode") == "native", mid8
        assert mid8.get("row", {}).get("verify_mode") == "native", mid8
    finally:
        server8.stop()

    # acceptance 0 under a floor: the session must FALL BACK to plain
    # decode — counter + flight event + result extras agree
    server8b = GenerationServer(
        FakeBackend(spec_k=4, spec_acceptance=0.0),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
        spec_accept_floor=0.25,
    )
    server8b.start()
    try:
        base8b = f"http://127.0.0.1:{server8b.port}"
        body8b = _post_generate(base8b, "hopeless draft", 64)
        assert body8b.get("done"), body8b
        text8b = _scrape(base8b)
        fallbacks8 = _metric_value(text8b, "llm_spec_fallback_total")
        assert fallbacks8 >= 1, "auto-fallback never fired at acceptance 0"
        flight8 = _get_json(base8b, "/debug/flight?type=spec_fallback")
        assert flight8["events"], "no spec_fallback flight event"
        assert flight8["events"][-1]["floor"] == 0.25
    finally:
        server8b.stop()

    # -- phase 9: SLO tiers + mid-flight preemption -----------------
    # A 2-row fake session saturated by two long low-tier requests; a
    # high-tier arrival preempts the YOUNGEST low row (swap policy),
    # decodes, retires — and the victim resumes and completes. The
    # asserts cover the whole observability surface: flight events,
    # counters, per-tier /debug/state queues, swap accounting to zero.
    server9 = GenerationServer(
        FakeBackend(tokens_per_s=150.0, simulate_delay=True, max_rows=2),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server9.start()
    try:
        base9 = f"http://127.0.0.1:{server9.port}"
        pre9 = _scrape(base9)

        def delta9(text_now, name):
            try:
                before = _metric_value(pre9, name)
            except AssertionError:
                before = 0.0
            return _metric_value(text_now, name) - before

        results9 = {}

        def client9(name, prompt, num_predict, priority):
            results9[name] = _post_generate(
                base9, prompt, num_predict, priority=priority
            )

        mid9 = {}

        def probe9():
            deadline9 = time.monotonic() + 30.0
            while time.monotonic() < deadline9 and "parked" not in mid9:
                try:
                    st = _get_json(base9, "/debug/state")
                    sch = st.get("scheduler") or {}
                    parked = sch.get("parked") or []
                    swap = (sch.get("session") or {}).get("swap") or {}
                    if parked and swap.get("host_bytes", 0) > 0:
                        mid9["parked"] = parked
                        mid9["swap"] = swap
                        mid9["queue_tiers"] = sch.get("queue_tiers")
                except Exception:
                    pass
                time.sleep(0.003)

        # each arrival waits for the rows before it to be live: the old
        # low row, then the young one, fill both rows before the high
        # tier arrives and must preempt
        lows9 = [
            threading.Thread(
                target=client9, args=("low_old", "low tier old", 160, "low")
            ),
            threading.Thread(
                target=client9,
                args=("low_young", "low tier young", 160, "low"),
            ),
        ]
        for rows9, t in enumerate(lows9, start=1):
            t.start()
            _wait_live(base9, rows=rows9)
        _run_threads(
            [
                threading.Thread(
                    target=client9, args=("high", "high tier", 48, "high")
                ),
                threading.Thread(target=probe9),
            ],
            timeout_s=40.0,
        )
        for t in lows9:
            t.join(timeout=40)
            assert not t.is_alive(), "a low-tier row never returned"
        for name in ("low_old", "low_young", "high"):
            body9 = results9.get(name)
            assert body9 and body9.get("done"), (name, body9)
        # the victim completed its FULL stream after resume
        assert results9["low_young"]["eval_count"] == 160, results9
        victim_sched = results9["low_young"]["x_extras"]["sched"]
        assert victim_sched.get("preempted") == 1, victim_sched
        assert victim_sched.get("resumed") is True, victim_sched
        assert "preempted" not in results9["high"]["x_extras"]["sched"]

        text9 = _scrape(base9)
        assert delta9(text9, "llm_sched_preempted_total") >= 1
        assert delta9(text9, "llm_sched_resumed_total") >= 1
        swap_out9 = delta9(text9, "llm_swap_bytes_total")
        assert swap_out9 > 0, "swap byte counters never moved"
        # host-residency gauges returned exactly to idle
        assert _metric_value(text9, "llm_swap_host_bytes") == 0.0
        assert _metric_value(text9, "llm_swap_host_rows") == 0.0

        # flight story: preempted (trace-linked to BOTH tickets) then
        # resumed for the same victim trace
        pre_ev = _get_json(base9, "/debug/flight?type=preempted")["events"]
        res_ev = _get_json(base9, "/debug/flight?type=resumed")["events"]
        assert pre_ev and res_ev, (pre_ev, res_ev)
        assert pre_ev[-1]["policy"] == "swap"
        assert pre_ev[-1].get("trace") and pre_ev[-1].get("by")
        assert pre_ev[-1]["by_tier"] > pre_ev[-1]["tier"]
        assert res_ev[-1]["trace"] == pre_ev[-1]["trace"]

        # the mid-flight probe saw the parked victim, its host-resident
        # bytes, and the per-tier queue surface
        assert mid9.get("parked"), f"probe never saw a parked victim: {mid9}"
        assert mid9["parked"][0]["policy"] == "swap"
        assert mid9["swap"]["host_rows"] == 1
        assert mid9["swap"]["host_bytes"] > 0
        assert isinstance(mid9.get("queue_tiers"), dict)
    finally:
        server9.stop()

    # -- phase 10: replica-fleet routing ----------------------------
    # A 2-replica fake fleet behind the front-door router: dispatch
    # counters split across replicas; one replica is KILLED mid-trace
    # (its engine dies — new sessions raise) while a long accepted
    # stream is still in flight on it — that stream completes (zero
    # accepted tickets lost), the next ticket routed there is retried
    # ONCE onto the survivor, the replica_down flight event fires and
    # the healthy gauge drops; finally the survivor drains cleanly
    # (replica_drained event, then 503 with nobody left).
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
        GenerationRequest,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import (
        RemoteHTTPBackend,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.router import (
        LocalReplica,
        Router,
        RouterServer,
    )

    backend10_a = FakeBackend(tokens_per_s=200.0, simulate_delay=True)
    backend10_b = FakeBackend(tokens_per_s=200.0, simulate_delay=True)
    router10 = Router(
        [
            LocalReplica("r0", backend10_a),
            LocalReplica("r1", backend10_b),
        ],
        policy="round-robin",
        probe_interval_s=30.0,  # the smoke probes explicitly
    )
    server10 = RouterServer(router10, host="127.0.0.1", port=0, quiet=True)
    server10.start()
    try:
        base10 = f"http://127.0.0.1:{server10.port}"
        pre10 = _scrape(base10)

        def replica_dispatches(text_now):
            out = {}
            for line in text_now.splitlines():
                m = re.match(
                    r'^llm_router_dispatch_total\{replica="([^"]+)",'
                    r'policy="[^"]+"\} ([0-9.e+-]+)$',
                    line,
                )
                if m:
                    out[m.group(1)] = out.get(m.group(1), 0.0) + float(
                        m.group(2)
                    )
            return out

        # four short tickets: round-robin splits them 2/2
        for i in range(4):
            body10 = _post_generate(base10, f"fleet {i}", 8)
            assert body10.get("done"), body10
            assert body10["x_extras"]["router"]["replica"] in ("r0", "r1")
        split10 = replica_dispatches(_scrape(base10))
        assert split10.get("r0", 0) >= 2 and split10.get("r1", 0) >= 2, (
            f"dispatches did not split across replicas: {split10}"
        )

        # a long ACCEPTED stream lands on r0 (cursor parity after 4)...
        client10 = RemoteHTTPBackend(base10)
        stream_done = {}
        streaming10 = threading.Event()

        def long_stream():
            chunks = []
            for chunk in client10.generate_stream(
                GenerationRequest(
                    "smoke:1b",
                    "long accepted stream",
                    max_new_tokens=160,
                )
            ):
                chunks.append(chunk)
                if chunk.tokens:
                    streaming10.set()
            stream_done["final"] = chunks[-1].result
            stream_done["tokens"] = sum(
                len(c.tokens) for c in chunks if not c.done
            )

        t10 = threading.Thread(target=long_stream)
        t10.start()
        # the stream is live mid-trace (its first tokens arrived)...
        assert streaming10.wait(timeout=10.0), "the long stream never started"
        backend10_a.fail_decode_open = True  # ...when r0's engine DIES
        # two more tickets: round-robin sends one to the dead replica —
        # it must be retried ONCE onto the survivor and complete
        retried_before10 = 0
        try:
            retried_before10 = _metric_value(
                pre10, "llm_router_retries_total"
            )
        except AssertionError:
            pass
        for i in range(2):
            body10 = _post_generate(base10, f"after kill {i}", 8)
            assert body10.get("done"), body10
            assert body10["x_extras"]["router"]["replica"] == "r1", body10
        t10.join(timeout=40)
        final10 = stream_done.get("final")
        assert final10 is not None, "accepted stream lost after kill"
        assert final10.generated_tokens == 160, final10.generated_tokens
        assert stream_done["tokens"] == 160, stream_done
        assert final10.extras["router"]["replica"] == "r0", final10.extras

        text10 = _scrape(base10)
        retries10 = (
            _metric_value(text10, "llm_router_retries_total")
            - retried_before10
        )
        assert retries10 >= 1, "the kill never produced a retry"
        # healthy gauge dropped for r0 and the flight event fired
        gauge10 = {}
        for line in text10.splitlines():
            m = re.match(
                r'^llm_router_replica_healthy\{replica="([^"]+)"\} '
                r"([0-9.e+-]+)$",
                line,
            )
            if m:
                gauge10[m.group(1)] = float(m.group(2))
        assert gauge10.get("r0") == 0.0 and gauge10.get("r1") == 1.0, gauge10
        down10 = _get_json(base10, "/debug/flight?type=replica_down")[
            "events"
        ]
        assert any(e.get("replica") == "r0" for e in down10), down10
        state10 = _get_json(base10, "/debug/state")
        by_name10 = {r["name"]: r for r in state10["replicas"]}
        assert by_name10["r0"]["healthy"] is False
        assert by_name10["r1"]["healthy"] is True

        # drain the survivor: in-flight work finished, detach is clean
        assert router10.drain("r1", timeout_s=30.0), "drain timed out"
        drained10 = _get_json(base10, "/debug/flight?type=replica_drained")[
            "events"
        ]
        assert any(e.get("replica") == "r1" for e in drained10), drained10
        assert [r["name"] for r in _get_json(base10, "/debug/state")["replicas"]] == [
            "r0"
        ]
        # nobody healthy is left: the front door sheds with 503
        try:
            _post_generate(base10, "nobody home", 4)
            raise AssertionError("dispatch with no healthy replica succeeded")
        except urllib.error.HTTPError as exc:
            assert exc.code == 503, exc.code
    finally:
        server10.stop()

    # -- phase 11: fleet-wide observability -------------------------
    # The serve-fleet shape: two fake continuous servers reached over
    # the wire as RemoteReplicas behind the router. One mid-trace kill,
    # one preemption — then the trace, timeline, federation and
    # wasted-Joules asserts described in the module docstring.
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.metrics import (
        REGISTRY,
        merge_expositions,
        parse_exposition,
        sample_value,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.trace import (
        TraceContext,
        mint_trace_id,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.router import (
        RemoteReplica,
    )

    def wasted_retry_joules():
        fam = REGISTRY.snapshot().get(
            "llm_request_wasted_joules_total", {}
        )
        return float(fam.get("cause=retry", 0.0))

    backend11_a = FakeBackend(tokens_per_s=200.0, simulate_delay=True)
    backend11_b = FakeBackend(
        tokens_per_s=150.0, simulate_delay=True, max_rows=2
    )
    server11_a = GenerationServer(
        backend11_a, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous",
    )
    server11_b = GenerationServer(
        backend11_b, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous",
    )
    server11_a.start()
    server11_b.start()
    base11_a = f"http://127.0.0.1:{server11_a.port}"
    base11_b = f"http://127.0.0.1:{server11_b.port}"
    router11 = Router(
        [
            RemoteReplica("r0", base11_a),
            RemoteReplica("r1", base11_b),
        ],
        policy="round-robin",
        probe_interval_s=30.0,
    )
    server11 = RouterServer(router11, host="127.0.0.1", port=0, quiet=True)
    server11.start()
    try:
        base11 = f"http://127.0.0.1:{server11.port}"
        wasted_before = wasted_retry_joules()

        # two low-tier long rows saturate B's 2-row session (sent
        # DIRECTLY to B — background load, caller-traced so the victim
        # story is timeline-queryable too)
        victim_traces = [mint_trace_id(), mint_trace_id()]
        low_results = {}

        def low_client(i):
            body = json.loads(
                urllib.request.urlopen(
                    urllib.request.Request(
                        f"{base11_b}/api/generate",
                        data=json.dumps(
                            {
                                "model": "smoke:1b",
                                "prompt": f"low tier {i}",
                                "options": {"num_predict": 160},
                                "x_priority": "low",
                                "x_trace": {"id": victim_traces[i]},
                            }
                        ).encode(),
                        headers={"Content-Type": "application/json"},
                    ),
                    timeout=60,
                ).read()
            )
            low_results[i] = body

        # the second low row arrives once the first is live, and the
        # high tier once both fill B's session
        threads11 = [
            threading.Thread(target=low_client, args=(i,)) for i in (0, 1)
        ]
        for rows11, t in enumerate(threads11, start=1):
            t.start()
            _wait_live(base11_b, rows=rows11)

        backend11_a.fail_decode_open = True  # r0 dies mid-trace

        # the traced high-tier STREAM through the router: round-robin
        # picks dead r0 first -> retried once onto r1 -> preempts the
        # youngest low row there
        from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (  # noqa: E501
            GenerationRequest as _GenReq,
        )

        tid11 = mint_trace_id()
        client11 = RemoteHTTPBackend(base11)
        chunks11 = list(
            client11.generate_stream(
                _GenReq(
                    "smoke:1b",
                    "retried traced high-tier stream",
                    max_new_tokens=48,
                    priority=2,
                    trace=TraceContext(trace_id=tid11),
                )
            )
        )
        final11 = chunks11[-1].result
        assert final11 is not None and final11.generated_tokens == 48
        router11_extras = final11.extras["router"]
        assert router11_extras["replica"] == "r1", router11_extras
        assert router11_extras["retried"] == "dead", router11_extras
        assert router11_extras["trace"] == tid11

        # wasted-Joules moved for cause=retry, and the same figure rode
        # the wire on the retried ticket
        wasted_wire = final11.extras["energy"]["wasted_J"]["retry"]
        assert wasted_wire > 0, final11.extras
        wasted_delta = wasted_retry_joules() - wasted_before
        assert wasted_delta > 0, "llm_request_wasted_joules_total{retry} flat"

        for t in threads11:
            t.join(timeout=60)
        assert low_results[0].get("done") and low_results[1].get("done")
        # the victim completed its full stream after preempt+resume
        victim_sched = low_results[1]["x_extras"]["sched"]
        assert victim_sched.get("preempted") == 1, victim_sched
        assert low_results[1]["eval_count"] == 160

        # both dispatch attempts share ONE trace id, in order
        disp11 = _get_json(
            base11, f"/debug/flight?trace={tid11}&type=dispatched"
        )["events"]
        assert [(e["attempt"], e["replica"]) for e in disp11] == [
            (1, "r0"),
            (2, "r1"),
        ], disp11
        assert {e["trace_id"] for e in disp11} == {tid11}

        # the timeline reconstructs the retried request across hops in
        # order: dispatched -> retry dispatched -> admitted (queue wait
        # attached) -> stream chunks -> retired
        tl11 = _get_json(base11, f"/debug/timeline?trace={tid11}")
        assert tl11["attempts"] == 2
        types11 = [e["type"] for e in tl11["events"]]
        d0 = types11.index("dispatched")
        d1 = types11.index("dispatched", d0 + 1)
        i_adm = types11.index("request_admitted")
        i_ret = types11.index("row_retired")
        assert d0 < d1 < i_adm < i_ret, types11
        assert "stream_chunk" in types11
        assert i_adm < types11.index("stream_chunk") < i_ret, types11
        assert "queue_wait_s" in tl11["events"][i_adm]
        # every hop is attributed; the retried attempt's replica events
        # surface under r1 (or, ring-shared in-process, as "local")
        assert {e["hop"] for e in tl11["events"]} >= {"router"}

        # the VICTIM's trace shows preempted -> resumed in order
        vic11 = _get_json(
            base11_b, f"/debug/flight?trace={victim_traces[1]}&n=500"
        )["events"]
        vtypes = [e["type"] for e in vic11]
        assert "preempted" in vtypes and "resumed" in vtypes, vtypes
        assert vtypes.index("preempted") < vtypes.index("resumed")

        # federation: fleet counters equal the SUM of the individual
        # replica scrapes (replicas quiesced; merged by the same
        # function the golden test pins)
        scrape_a = _scrape(base11_a)
        scrape_b = _scrape(base11_b)
        expected11 = merge_expositions([("r0", scrape_a), ("r1", scrape_b)])
        expected_req = sample_value(
            parse_exposition(expected11), "llm_fleet_sched_requests_total"
        )
        fleet_req = sample_value(
            parse_exposition(_scrape(base11)),
            "llm_fleet_sched_requests_total",
        )
        assert expected_req is not None and fleet_req == expected_req, (
            fleet_req,
            expected_req,
        )
    finally:
        server11.stop()
        server11_a.stop()
        server11_b.stop()

    # -- phase 12: persistent cross-session prefix store -----------
    # Two SEQUENTIAL fake-server sessions: the first publishes a long
    # system prompt and fully drains (its session closes); the second
    # session's JOINER hits the backend-owned store — the hit counter
    # moves and the shared-page gauge rises even though the publishing
    # session is gone. Then a tightened HBM budget forces a SPILL on
    # the next publications, and a later prefixed request RESTORES the
    # spilled entry — spill/restore flight events trace-linked.
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.radix_store import (  # noqa: E501
        STORE_HITS_C,
        STORE_RESTORES_C,
        STORE_SPILLS_C,
    )

    backend12 = FakeBackend(
        tokens_per_s=200.0, simulate_delay=True, prefix_share=True
    )
    server12 = GenerationServer(
        backend12, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous",
    )
    server12.start()
    try:
        base12 = f"http://127.0.0.1:{server12.port}"
        sys12 = "cross-session system prompt: " + "p" * 100 + " | "
        hits0_12 = STORE_HITS_C.labels().value
        # SESSION 1: publish, run to completion, session closes
        _post_generate(base12, sys12 + "first question", 24)
        deadline12 = time.monotonic() + 5.0
        while time.monotonic() < deadline12:
            if _get_json(base12, "/healthz").get("inflight_rows", 1) == 0:
                break
            time.sleep(0.02)
        assert STORE_HITS_C.labels().value == hits0_12  # no self-hit
        state12 = _get_json(base12, "/debug/state")
        assert state12.get("prefix_store", {}).get("nodes", 0) >= 1, state12
        # SESSION 2: anchor + staggered joiner; the JOINER's prompt hits
        # the store cross-session (shared-page gauge rises mid-flight)
        mid12 = {"shared_peak": 0.0}
        posts12 = [
            threading.Thread(
                target=_post_generate,
                args=(base12, "an unrelated second-session anchor", 64),
            ),
            threading.Thread(
                target=_post_generate,
                args=(base12, sys12 + "second question", 32),
            ),
        ]

        def probe12():
            end = time.monotonic() + 10.0
            while (
                any(t.is_alive() for t in posts12)
                and time.monotonic() < end
            ):
                try:
                    mid12["shared_peak"] = max(
                        mid12["shared_peak"],
                        _metric_value(
                            _scrape(base12), "llm_prefix_shared_pages"
                        ),
                    )
                except AssertionError:
                    pass
                time.sleep(0.02)

        posts12[0].start()
        _wait_live(base12)
        _run_threads([posts12[1], threading.Thread(target=probe12)])
        posts12[0].join(timeout=30)
        assert not posts12[0].is_alive(), "the phase-12 anchor never returned"
        hits12 = STORE_HITS_C.labels().value - hits0_12
        assert hits12 >= 1, "second session never hit the store"
        assert mid12["shared_peak"] > 0, "shared-page gauge never rose"
        text12 = _scrape(base12)
        assert _metric_value(text12, "llm_prefix_store_nodes") >= 1
        # hit event trace-linked to the JOINED ticket
        hit_events12 = _get_json(
            base12, "/debug/flight?n=500&type=prefix_hit"
        )["events"]
        admits12 = _get_json(
            base12, "/debug/flight?n=500&type=request_admitted"
        )["events"]
        joined12 = {e.get("trace") for e in admits12 if e.get("joined")}
        assert any(e.get("trace") in joined12 for e in hit_events12), (
            hit_events12,
            admits12,
        )
        # BUDGET PRESSURE: tighten the HBM budget, publish fresh
        # prefixes — the LRU-cold entries spill to host
        spills0_12 = STORE_SPILLS_C.labels().value
        backend12.prefix_store.hbm_bytes = 4 * 1024  # ~4 fake pages
        _post_generate(base12, "fresh prefix A " + "a" * 120, 8)
        _post_generate(base12, "fresh prefix B " + "b" * 120, 8)
        assert STORE_SPILLS_C.labels().value > spills0_12, "no spill"
        text12b = _scrape(base12)
        assert _metric_value(text12b, "llm_prefix_store_host_bytes") > 0
        spill_events12 = _get_json(
            base12, "/debug/flight?n=500&type=prefix_spill"
        )["events"]
        assert spill_events12 and spill_events12[-1].get("trace") is not None
        # RESTORE: a later request re-using the ORIGINAL system prompt
        # hits its (now spilled) entry and swaps it back in
        restores0_12 = STORE_RESTORES_C.labels().value
        _post_generate(base12, sys12 + "third question", 8)
        restores12 = STORE_RESTORES_C.labels().value - restores0_12
        assert restores12 >= 1, "spilled entry was not restored on hit"
        restore_events12 = _get_json(
            base12, "/debug/flight?n=500&type=prefix_restore"
        )["events"]
        assert restore_events12, "no prefix_restore flight event"
        assert restore_events12[-1].get("trace") is not None
        assert (
            _metric_value(_scrape(base12), "llm_prefix_store_restores_total")
            >= 1
        )
    finally:
        server12.stop()

    # -- phase 13: multi-model fleet serving ------------------------
    # TWO fake models behind ONE server in fleet mode (--model-policy):
    # a long big-model decode anchors its lane while two small-model
    # requests admit, step and retire CONCURRENTLY on theirs — both
    # complete strictly before the big one (no cross-model head-of-line
    # blocking) and the window-batch incompatibility fallback counter
    # stays flat on the mixed trace. Then a model:"auto" request runs
    # the small-first cascade: the small answer is length-cut, the
    # request ESCALATES to the big model, the abandoned tokens charge
    # llm_request_wasted_joules_total{cause="escalation"} with the same
    # figure riding x_extras.energy, and the model_escalated flight
    # event fires. Finally a FORCED eviction of the big model's weights
    # shows up on /api/ps and as a model_evicted flight event.
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.energy import (
        WASTED_J,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.scheduler import (
        _BATCH_FALLBACK_C,
    )

    backend13 = FakeBackend(
        tokens_per_s=250.0,
        simulate_delay=True,
        model_bytes={"small:1b": 1024, "big:7b": 8192},
        model_joules={"small:1b": 0.1, "big:7b": 0.9},
    )
    server13 = GenerationServer(
        backend13,
        host="127.0.0.1",
        port=0,
        quiet=True,
        models=["small:1b", "big:7b"],
        model_policy="small-first",
        escalate_max_tokens=16,
    )
    server13.start()
    try:
        base13 = f"http://127.0.0.1:{server13.port}"
        fallback0_13 = _BATCH_FALLBACK_C.labels().value
        traces13 = {
            name: mint_trace_id()
            for name in ("big-anchor", "small-a", "small-b")
        }
        done13 = set()

        def client13(name, model, num_predict):
            body = _post_generate(
                base13, name, num_predict, model=model, trace=traces13[name]
            )
            assert body.get("done"), body
            done13.add(name)

        # the small requests arrive once the big row is live in its lane
        big13 = threading.Thread(
            target=client13, args=("big-anchor", "big:7b", 512)
        )
        big13.start()
        _wait_live(base13, lane="big:7b")
        _run_threads(
            [
                threading.Thread(
                    target=client13, args=(name, "small:1b", 8)
                )
                for name in ("small-a", "small-b")
            ]
        )
        big13.join(timeout=30)
        assert done13 == {"big-anchor", "small-a", "small-b"}, done13
        # concurrent retirement interleaving across models: the small
        # lane's rows retired while the big lane was still decoding
        order13 = _retire_order(base13, set(traces13.values()))
        for name in ("small-a", "small-b"):
            assert (
                order13[traces13[name]] < order13[traces13["big-anchor"]]
            ), order13
        # mixed-model traffic never trips the incompatibility fallback
        assert _BATCH_FALLBACK_C.labels().value == fallback0_13
        # auto → small-first cascade → escalation with the wasted charge
        wasted0_13 = WASTED_J.labels(cause="escalation").value
        auto13 = _post_generate(
            base13, "an open-ended question", 32, model="auto"
        )
        assert auto13.get("model") == "big:7b", auto13
        fleet13 = auto13.get("x_extras", {}).get("fleet", {})
        assert fleet13.get("escalated") is True, auto13
        assert fleet13.get("escalated_from") == "small:1b", auto13
        wire_wasted13 = (
            auto13["x_extras"]["energy"]["wasted_J"]["escalation"]
        )
        wasted_delta13 = (
            WASTED_J.labels(cause="escalation").value - wasted0_13
        )
        assert wasted_delta13 > 0, "escalation never charged the ledger"
        assert abs(wire_wasted13 - wasted_delta13) < 1e-6, (
            wire_wasted13,
            wasted_delta13,
        )
        escalated_events13 = _get_json(
            base13, "/debug/flight?n=500&type=model_escalated"
        )["events"]
        assert escalated_events13, "no model_escalated flight event"
        text13 = _scrape(base13)
        assert _metric_value(text13, "llm_model_escalations_total") >= 1
        assert _metric_value(text13, "llm_model_fleet_lanes") == 2
        # /api/ps reflects a FORCED weight eviction
        ps13 = _get_json(base13, "/api/ps")
        names13 = {m["name"] for m in ps13["models"]}
        assert {"small:1b", "big:7b"} <= names13, ps13
        assert backend13.evict_model("big:7b") is True
        ps13b = _get_json(base13, "/api/ps")
        names13b = {m["name"] for m in ps13b["models"]}
        assert "big:7b" not in names13b, ps13b
        assert "small:1b" in names13b, ps13b
        evicted13 = _get_json(
            base13, "/debug/flight?n=500&type=model_evicted"
        )["events"]
        assert evicted13 and evicted13[-1].get("model") == "big:7b"
    finally:
        server13.stop()

    # -- phase 14: sampled speculation + draft sources --------------
    # Cross-source spec server: a GREEDY row at healthy acceptance moves
    # the source-labelled spec counters; a SAMPLED row (temperature >
    # 0) at synthetic acceptance 0 fully rejects every round — the
    # per-source fallback fires under the floor AND the rejected draft
    # tokens are billed to the wasted-energy ledger at the draft
    # model's J/token, the wire figure agreeing with the counter delta.
    def _labeled_value(text_now, name, label_frag):
        total, seen = 0.0, False
        for line in text_now.splitlines():
            if line.startswith(name + "{") and label_frag in line:
                total += float(line.rsplit(" ", 1)[1])
                seen = True
        return total if seen else None

    def _post14(base, prompt, num_predict, temperature=None):
        options = {"num_predict": num_predict}
        if temperature is not None:
            options["temperature"] = temperature
        req = urllib.request.Request(
            f"{base}/api/generate",
            data=json.dumps(
                {"model": "smoke:1b", "prompt": prompt, "options": options}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    backend14 = FakeBackend(
        tokens_per_s=400.0,
        simulate_delay=True,
        spec_k=4,
        spec_acceptance=0.75,
        spec_sampled_acceptance=0.0,
        spec_source="cross",
        spec_draft="small:1b",
        model_joules={"smoke:1b": 0.5, "small:1b": 0.1},
    )
    server14 = GenerationServer(
        backend14,
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
        spec_accept_floor=0.25,
    )
    server14.start()
    try:
        base14 = f"http://127.0.0.1:{server14.port}"
        pre14 = _scrape(base14)

        def delta14(text_now, name, frag):
            before = _labeled_value(pre14, name, frag) or 0.0
            now = _labeled_value(text_now, name, frag)
            assert now is not None, f"{name}{{{frag}}} absent from /metrics"
            return now - before

        wasted_draft0 = WASTED_J.labels(cause="draft").value
        # greedy row: healthy cross-source speculation, no billing
        body14g = _post14(base14, "greedy cross row", 64)
        assert body14g.get("done"), body14g
        spec14g = body14g["x_extras"]["spec"]
        assert spec14g["source"] == "cross", spec14g
        assert spec14g["draft_model"] == "small:1b", spec14g
        assert spec14g["rejected"] == 0 and not spec14g["fallback"], spec14g
        assert "draft_wasted_J" not in spec14g, spec14g
        assert WASTED_J.labels(cause="draft").value == wasted_draft0

        # sampled row: synthetic sampled-acceptance 0 — every round
        # fully rejects, the floor flips the session to plain decode,
        # and the rejected draft tokens charge the ledger
        body14s = _post14(base14, "hopeless sampled row", 64, temperature=0.8)
        assert body14s.get("done"), body14s
        spec14s = body14s["x_extras"]["spec"]
        assert spec14s["source"] == "cross", spec14s
        assert spec14s["rejected"] >= 1, spec14s
        assert spec14s["fallback"] is True, spec14s
        wire_draft14 = spec14s.get("draft_wasted_J", 0.0)
        assert wire_draft14 > 0, spec14s
        wasted_draft14 = WASTED_J.labels(cause="draft").value - wasted_draft0
        assert abs(wasted_draft14 - wire_draft14) < 1e-6, (
            wasted_draft14,
            wire_draft14,
        )
        # rejected tokens priced at the DRAFT model's J/token (0.1).
        # Under the adaptive draft length the hopeless row
        # shrinks k 4 → 2 → 1 before falling back, so rounds draft at
        # DIFFERENT k values — the invariant is on tokens, not rounds:
        # at acceptance 0 every drafted token is rejected and billed.
        assert abs(
            wire_draft14
            - 0.1 * (spec14s["drafted"] - spec14s["accepted"])
        ) < 1e-6, spec14s

        text14 = _scrape(base14)
        frag14 = 'source="cross"'
        rounds14 = delta14(text14, "llm_spec_rounds_total", frag14)
        rejected14 = delta14(
            text14, "llm_spec_tokens_rejected_total", frag14
        )
        fallbacks14 = delta14(text14, "llm_spec_fallback_total", frag14)
        assert rounds14 >= 1 and rejected14 >= 4, (rounds14, rejected14)
        assert fallbacks14 >= 1, "cross-source fallback never fired"
        assert _labeled_value(
            text14, "llm_request_wasted_joules_total", 'cause="draft"'
        ), "draft waste missing from /metrics"
        fb_events14 = [
            e
            for e in _get_json(base14, "/debug/flight?type=spec_fallback")[
                "events"
            ]
            if e.get("source") == "cross"
        ]
        assert fb_events14, "no cross-source spec_fallback flight event"
        assert fb_events14[-1]["floor"] == 0.25, fb_events14[-1]
    finally:
        server14.stop()

    # ngram source: zero extra weights — the label moves and the wire
    # carries no draft model
    server14b = GenerationServer(
        FakeBackend(spec_k=4, spec_acceptance=0.5, spec_source="ngram"),
        host="127.0.0.1",
        port=0,
        quiet=True,
        scheduler="continuous",
    )
    server14b.start()
    try:
        base14b = f"http://127.0.0.1:{server14b.port}"
        body14b = _post14(base14b, "ngram row", 32)
        assert body14b.get("done"), body14b
        spec14b = body14b["x_extras"]["spec"]
        assert spec14b["source"] == "ngram", spec14b
        assert spec14b["draft_model"] is None, spec14b
        text14b = _scrape(base14b)
        assert _labeled_value(
            text14b, "llm_spec_rounds_total", 'source="ngram"'
        ), "ngram-labelled spec rounds never moved"
    finally:
        server14b.stop()

    # -- phase 15: windowed telemetry + SLO burn-rate alerting ------
    # A 2-replica local fake fleet behind the front-door router with an
    # SLO contract and COMPRESSED burn windows (fast 1 s / slow 4 s at
    # 6x): the /debug/timeseries window math is checked against
    # hand-computed counter deltas from two /metrics scrapes; a mixed
    # workload (half the completions blow the threshold) FIRES the
    # burn-rate alert within one fast window; the router's
    # llm_slo_attainment gauge must equal — bit for bit — attainment
    # recomputed from the per-replica /debug/timeseries bucket deltas;
    # idling past the slow window RESOLVES the alert on the same
    # episode trace id; the ring dump is written as a CI artifact.
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.metrics import (
        bucket_fraction_below,
    )

    backend15_a = FakeBackend(tokens_per_s=400.0, simulate_delay=True)
    backend15_b = FakeBackend(tokens_per_s=400.0, simulate_delay=True)
    router15 = Router(
        [
            LocalReplica("s0", backend15_a),
            LocalReplica("s1", backend15_b),
        ],
        policy="round-robin",
        probe_interval_s=30.0,
    )
    server15 = RouterServer(
        router15,
        host="127.0.0.1",
        port=0,
        quiet=True,
        slo="ttft_p99_ms<=60000,completion_p95_s<=0.05",
        slo_pairs=((1.0, 4.0, 6.0),),
        ts_interval_s=0.1,
    )
    server15.start()
    try:
        base15 = f"http://127.0.0.1:{server15.port}"
        s0_reqs = _metric_value(_scrape(base15), "llm_sched_requests_total")

        # mixed workload: 4-token completions (~10 ms) attain the 50 ms
        # contract, 48-token ones (~120 ms) blow it
        for i, budget in enumerate((4, 48, 4, 48)):
            body15 = _post_generate(base15, f"slo row {i}", budget)
            assert body15.get("done"), body15
        s1_reqs = _metric_value(_scrape(base15), "llm_sched_requests_total")
        expected_delta = s1_reqs - s0_reqs
        assert expected_delta >= 4, (s0_reqs, s1_reqs)

        # window math vs the hand-computed scrape delta: the fleet ring's
        # rollup of the federated counter must converge on exactly the
        # S1 - S0 figure (the 30 s window spans the whole phase, so the
        # baseline snapshot predates S0)
        rollup_delta = None
        for _ in range(100):
            ts15 = _get_json(
                base15,
                "/debug/timeseries"
                "?family=llm_fleet_sched_requests_total&window=30",
            )
            rollup = ts15.get("rollup")
            if rollup is not None:
                rollup_delta = sum(
                    c["delta"] for c in rollup["children"].values()
                )
                if rollup_delta >= expected_delta:
                    break
            time.sleep(0.05)
        assert rollup_delta == expected_delta, (rollup_delta, expected_delta)
        assert ts15["ring_scope"] == "fleet", ts15["ring_scope"]
        assert ts15["ring"]["samples"] >= 2, ts15["ring"]

        # the breach fires within one fast window (the poll budget is
        # ~2.5 s; the fast window is 1 s): completion_p95_s burns at
        # >= 10x budget while the lenient ttft objective stays quiet
        firing15 = None
        for _ in range(50):
            alerts = _get_json(base15, "/debug/flight?type=slo_alert")[
                "events"
            ]
            fired = [e for e in alerts if e.get("state") == "firing"]
            if fired:
                firing15 = fired[-1]
                break
            time.sleep(0.05)
        assert firing15 is not None, "SLO breach never fired"
        assert firing15["objective"] == "completion_p95_s", firing15
        assert firing15["trace_id"] == "slo-completion_p95_s-1", firing15
        assert firing15["burn_short"] > 6.0, firing15

        # fleet attainment == per-replica recompute, BYTE-consistent:
        # the gauge the router published vs bucket_fraction_below over
        # the per-replica rings' summed bucket deltas (one "local"
        # source here — in-process replicas share the registry). The
        # gauge is set at the router's sampler tick, so a read may come
        # before the tick that saw the last completion: read both again
        # until they agree, for at most ~3 s (30 ticks).
        def attainment_gauge15():
            for line in _scrape(base15).splitlines():
                if line.startswith(
                    'llm_slo_attainment{objective="completion_p95_s"} '
                ):
                    return float(line.rsplit(" ", 1)[1])
            return None

        def recompute15():
            per15 = _get_json(
                base15,
                "/debug/timeseries"
                "?replica=local&family=llm_request_completion_seconds"
                "&window=4",
            )
            assert per15["ring_scope"] == "local", per15["ring_scope"]
            bounds15 = tuple(per15["rollup"]["bounds"])
            summed15 = [0] * (len(bounds15) + 1)
            for child in per15["rollup"]["children"].values():
                for i, d in enumerate(child["bucket_deltas"]):
                    summed15[i] += d
            return bucket_fraction_below(bounds15, summed15, 0.05)

        for _ in range(60):
            gauge15, recomputed15 = attainment_gauge15(), recompute15()
            if gauge15 is not None and gauge15 == recomputed15:
                break
            time.sleep(0.05)
        assert gauge15 is not None, "llm_slo_attainment absent"
        assert gauge15 == recomputed15, (gauge15, recomputed15)
        assert gauge15 < 0.99, gauge15

        # /debug/state carries the fleet snapshot + per-replica columns
        state15 = _get_json(base15, "/debug/state")
        assert state15["slo"]["engine"] == "router", state15["slo"]
        assert (
            state15["slo_attainment_by_replica"]["local"][
                "completion_p95_s"
            ]
            is not None
        ), state15["slo_attainment_by_replica"]
        for entry in state15["replicas"]:
            assert "slo_attainment" in entry, entry

        # recovery: idle past the slow window — the alert RESOLVES on
        # the SAME episode trace id (re-arm)
        resolved15 = None
        for _ in range(200):
            alerts = _get_json(base15, "/debug/flight?type=slo_alert")[
                "events"
            ]
            done15 = [e for e in alerts if e.get("state") == "resolved"]
            if done15:
                resolved15 = done15[-1]
                break
            time.sleep(0.1)
        assert resolved15 is not None, "SLO alert never resolved"
        assert resolved15["trace_id"] == firing15["trace_id"], resolved15

        # the ring dump is the CI artifact: every retained snapshot,
        # enough to recompute any window offline
        dump15 = server15.ts_ring.dump()
        assert dump15["snapshots"], dump15["ring"]
        with open(ts_out, "w") as fh:
            json.dump(dump15, fh)
    finally:
        server15.stop()

    # -- phase 16: disaggregated prefill/decode fleet ---------------
    # A real role fleet over HTTP: one fake prefill GenerationServer +
    # one fake decode GenerationServer as RemoteReplicas behind the
    # front-door router. A traced long-prompt ticket PRIMES on the
    # prefill side, ships through POST /api/migrate and completes its
    # FULL stream from the decode side — one uninterrupted client
    # stream. Asserts: /healthz self-reported roles adopted by the
    # router's probes; row_migrated flight events trace-linked on BOTH
    # replicas' /debug/flight rings with the right src/dst; the
    # llm_migrate_bytes_total out/in counters move symmetrically; and
    # the wasted cause=migration Joules on the wire
    # (x_extras.energy.wasted_J.migration) agree with the ledger's
    # counter delta.
    def wasted_migration_joules():
        fam = REGISTRY.snapshot().get(
            "llm_request_wasted_joules_total", {}
        )
        return float(fam.get("cause=migration", 0.0))

    def migrate_counters():
        snap = REGISTRY.snapshot()
        rows = snap.get("llm_migrate_rows_total", {})
        nbytes = snap.get("llm_migrate_bytes_total", {})
        return (
            float(rows.get("reason=disagg", 0.0)),
            float(nbytes.get("direction=out", 0.0)),
            float(nbytes.get("direction=in", 0.0)),
        )

    backend16_p = FakeBackend(tokens_per_s=400.0, simulate_delay=True)
    backend16_d = FakeBackend(tokens_per_s=400.0, simulate_delay=True)
    server16_p = GenerationServer(
        backend16_p, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous", role="prefill",
    )
    server16_d = GenerationServer(
        backend16_d, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous", role="decode",
    )
    server16_p.start()
    server16_d.start()
    base16_p = f"http://127.0.0.1:{server16_p.port}"
    base16_d = f"http://127.0.0.1:{server16_d.port}"
    router16 = Router(
        [
            RemoteReplica("pf", base16_p),
            RemoteReplica("dc", base16_d),
        ],
        probe_interval_s=30.0,
    )
    server16 = RouterServer(router16, host="127.0.0.1", port=0, quiet=True)
    server16.start()
    try:
        base16 = f"http://127.0.0.1:{server16.port}"
        # each replica declares its role on /healthz; one probe sweep
        # classifies the membership
        hz16 = _get_json(base16_p, "/healthz")
        assert hz16.get("role") == "prefill", hz16
        assert _get_json(base16_d, "/healthz").get("role") == "decode"
        router16.probe_now()
        roles16 = _get_json(base16, "/healthz")["replica_roles"]
        assert roles16 == {"prefill": 1, "decode": 1}, roles16

        rows_0, out_0, in_0 = migrate_counters()
        wasted_0 = wasted_migration_joules()

        tid16 = mint_trace_id()
        client16 = RemoteHTTPBackend(base16)
        long_prompt16 = "the disaggregated long prompt " * 24
        chunks16 = list(
            client16.generate_stream(
                _GenReq(
                    "smoke:1b",
                    long_prompt16,
                    max_new_tokens=64,
                    trace=TraceContext(trace_id=tid16),
                )
            )
        )
        final16 = chunks16[-1].result
        assert final16 is not None, "disagg stream lost"
        streamed16 = sum(len(c.tokens) for c in chunks16 if not c.done)
        assert final16.generated_tokens == 64, final16.generated_tokens
        assert streamed16 == 64, streamed16
        sched16 = final16.extras["sched"]
        route16 = final16.extras["router"]
        assert sched16.get("migrated") is True, sched16
        assert route16["replica"] == "dc", route16
        assert route16["role"] == "decode", route16

        rows_1, out_1, in_1 = migrate_counters()
        assert rows_1 - rows_0 >= 1, (rows_0, rows_1)
        moved16 = out_1 - out_0
        assert moved16 > 0 and moved16 == in_1 - in_0, (
            "migrate byte counters not symmetric",
            out_0, out_1, in_0, in_1,
        )

        # wire-vs-ledger: the transfer Joules the client saw must agree
        # with what the wasted-energy ledger charged this phase (the
        # ledger counter quantizes at 1e-6 J; the wire stamp at 1e-9)
        wire_j16 = final16.extras["energy"]["wasted_J"]["migration"]
        ledger_j16 = wasted_migration_joules() - wasted_0
        assert abs(wire_j16 - ledger_j16) < 1e-6, (wire_j16, ledger_j16)

        # trace-linked row_migrated events visible on BOTH replicas'
        # flight rings: export (out) on the prefill side, seat (in) on
        # the decode side, each carrying the caller's trace id
        ev16_p = _get_json(
            base16_p, f"/debug/flight?type=row_migrated&trace={tid16}"
        )["events"]
        ev16_d = _get_json(
            base16_d, f"/debug/flight?type=row_migrated&trace={tid16}"
        )["events"]
        dirs16_p = {e.get("direction") for e in ev16_p}
        dirs16_d = {e.get("direction") for e in ev16_d}
        assert "out" in dirs16_p, ev16_p
        assert "in" in dirs16_d, ev16_d
        seat16 = [e for e in ev16_d if e.get("direction") == "in"]
        assert any(e.get("reason") == "disagg" for e in seat16), seat16
        transfer16 = [
            e
            for e in _get_json(
                base16, f"/debug/flight?type=row_migrated&trace={tid16}"
            )["events"]
            if e.get("direction") == "transfer"
        ]
        assert any(
            e.get("src") == "pf" and e.get("dst") == "dc"
            for e in transfer16
        ), transfer16
    finally:
        server16.stop()
        server16_p.stop()
        server16_d.stop()

    # -- phase 17: prefix-affinity routing + fleet admission --------
    # A 3-replica local fleet behind the front door under
    # --route-policy affinity: two prefix-sharing fakes plus one
    # single-row replica that is FULL the whole phase (its only slot
    # is occupied by a long off-router stream). Asserts: the first
    # sharer seats the shared prefix on "afa" (affinity=fallback — all
    # stores cold), a probe federates the radix digest, and the SECOND
    # sharer routes back to the warm replica AGAINST the queue signal
    # (afa is pinned busier) with llm_router_affinity_hits_total
    # moving and a trace-linked affinity_route flight event; the full
    # replica's probed max_admission_rows reads 0 and it receives ZERO
    # dispatches while llm_router_retries_total{reason="refused"}
    # stays flat (capacity consulted BEFORE dispatch, not bounced);
    # once the occupant drains, a fresh probe shows the headroom
    # recover — the gate is live capacity, never a blacklist.
    def refused_retries(text_now):
        for line in text_now.splitlines():
            m = re.match(
                r'^llm_router_retries_total\{reason="refused"\} '
                r"([0-9.e+-]+)$",
                line,
            )
            if m:
                return float(m.group(1))
        return 0.0

    SHARED17 = "affinity smoke shared system prompt: " + "y" * 64
    backend17_a = FakeBackend(
        prefix_share=True, tokens_per_s=400.0, simulate_delay=True
    )
    backend17_b = FakeBackend(
        prefix_share=True, tokens_per_s=400.0, simulate_delay=True
    )
    backend17_f = FakeBackend(
        max_rows=1, tokens_per_s=200.0, simulate_delay=True
    )
    replica17_a = LocalReplica("afa", backend17_a)
    replica17_b = LocalReplica("afb", backend17_b)
    replica17_f = LocalReplica("full", backend17_f)
    router17 = Router(
        [replica17_a, replica17_b, replica17_f],
        policy="affinity",
        probe_interval_s=30.0,  # the smoke probes explicitly
    )
    server17 = RouterServer(router17, host="127.0.0.1", port=0, quiet=True)
    server17.start()
    occupant17 = threading.Thread()
    try:
        base17 = f"http://127.0.0.1:{server17.port}"
        # warm every replica for the model OFF-router first so the
        # model-placement preference never narrows the candidate set —
        # this phase isolates the affinity + admission signals
        for rep17 in (replica17_a, replica17_b, replica17_f):
            rep17.generate(
                _GenReq("smoke:1b", f"warm {rep17.name}", max_new_tokens=2)
            )
        # occupy the full replica's ONLY row with a long direct stream
        occ_done17 = {}

        def occupy_full():
            chunks = list(
                replica17_f.stream(
                    _GenReq(
                        "smoke:1b",
                        "occupant holding the only row",
                        max_new_tokens=640,
                    )
                )
            )
            occ_done17["tokens"] = sum(
                len(c.tokens) for c in chunks if not c.done
            )

        occupant17 = threading.Thread(target=occupy_full)
        occupant17.start()
        # probe until the occupied replica self-reports ZERO headroom
        deadline17 = time.monotonic() + 10.0
        while True:
            router17.probe_now()
            if (replica17_f.last_stats or {}).get(
                "max_admission_rows"
            ) == 0:
                break
            assert time.monotonic() < deadline17, (
                "full replica never reported zero admission headroom: "
                f"{replica17_f.last_stats}"
            )
            time.sleep(0.05)

        pre17 = _scrape(base17)
        dispatch_pre17 = replica_dispatches(pre17)
        refused_pre17 = refused_retries(pre17)
        hits_pre17 = 0.0
        try:
            hits_pre17 = _metric_value(
                pre17, "llm_router_affinity_hits_total"
            )
        except AssertionError:
            pass

        client17 = RemoteHTTPBackend(base17)
        # first sharer: every store is cold on SHARED17 → the affinity
        # policy falls back to least-queue, whose (load, name) tie-break
        # seats it on afa — which publishes the prefix
        first17 = client17.generate(
            _GenReq("smoke:1b", SHARED17 + " first tail", max_new_tokens=8)
        )
        route17_1 = first17.extras["router"]
        assert route17_1["replica"] == "afa", route17_1
        assert route17_1["affinity"] == "fallback", route17_1
        router17.probe_now()  # federate the published digest
        assert (
            (replica17_a.last_stats or {})
            .get("prefix_digest", {})
            .get("entries")
        ), replica17_a.last_stats
        # the occupant is still holding the full replica's slot
        assert (replica17_f.last_stats or {}).get(
            "max_admission_rows"
        ) == 0, replica17_f.last_stats

        # second sharer AGAINST the queue signal: afa is pinned busier,
        # so least-queue alone would pick afb — the estimator's
        # longest-match claim must override it, trace-linked
        tid17 = mint_trace_id()
        replica17_a.outstanding += 1
        try:
            second17 = client17.generate(
                _GenReq(
                    "smoke:1b",
                    SHARED17 + " second tail",
                    max_new_tokens=8,
                    trace=TraceContext(trace_id=tid17),
                )
            )
        finally:
            replica17_a.outstanding -= 1
        route17_2 = second17.extras["router"]
        assert route17_2["replica"] == "afa", route17_2
        aff17 = route17_2["affinity"]
        assert isinstance(aff17, dict) and aff17["est_tokens"] >= 16, (
            route17_2
        )

        # non-sharing fillers spread across the healthy pair — never
        # onto the full replica, and never via a bounced refusal
        for i in range(4):
            body17 = _post_generate(base17, f"affinity filler {i}", 4)
            assert body17.get("done"), body17
            assert body17["x_extras"]["router"]["replica"] in (
                "afa",
                "afb",
            ), body17["x_extras"]["router"]

        text17 = _scrape(base17)
        dispatch17 = replica_dispatches(text17)
        full_disp17 = dispatch17.get("full", 0.0) - dispatch_pre17.get(
            "full", 0.0
        )
        assert full_disp17 == 0, (
            f"full replica was dispatched to: {dispatch17}"
        )
        refused17 = refused_retries(text17) - refused_pre17
        assert refused17 == 0, (
            f"admission gate let a refusal through: {refused17}"
        )
        hits17 = (
            _metric_value(text17, "llm_router_affinity_hits_total")
            - hits_pre17
        )
        assert hits17 >= 1, f"affinity hit counter never moved: {hits17}"
        # the affinity decision is on the flight ring, trace-linked
        ev17 = _get_json(
            base17, f"/debug/flight?type=affinity_route&trace={tid17}"
        )["events"]
        assert any(
            e.get("replica") == "afa"
            and (e.get("est_tokens") or 0) >= 16
            for e in ev17
        ), ev17

        # the occupant drains; a fresh probe must show the headroom
        # RECOVER — admission is live capacity, not a blacklist
        occupant17.join(timeout=40)
        assert occ_done17.get("tokens") == 640, occ_done17
        router17.probe_now()
        recovered17 = (replica17_f.last_stats or {}).get(
            "max_admission_rows"
        )
        assert recovered17 and recovered17 >= 1, replica17_f.last_stats
    finally:
        if occupant17.ident is not None:
            occupant17.join(timeout=40)
        server17.stop()

    # -- phase 18: tenant accounting + usage ledger -----------------
    # One fake continuous server with a crash-safe usage ledger: two
    # tenants' wire traffic (x_tenant) moves the llm_tenant_* counters;
    # GET /debug/tenants matches a BY-HAND sum of the wire results
    # (slice-level attribution: each result's energy_model.J); a
    # mid-stream hang-up lands as outcome=cancelled; the JSONL ledger
    # re-reads with strictly monotonic seqs and its per-tenant Joules
    # sum agrees with the table; the kill switch 404s the endpoint on
    # server AND router; and a 2-replica fleet behind the router
    # federates llm_fleet_tenant_* equal to merging the replica scrapes
    # by hand (the same merge_expositions the golden test pins).
    import tempfile

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs import (
        metrics as obs_metrics,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs import (
        tenants as obs_tenants,
    )

    def labelled_value(text_now, family, want):
        total = 0.0
        for line in text_now.splitlines():
            m = re.match(
                rf"^{re.escape(family)}\{{([^}}]*)\}} ([0-9.e+-]+)$", line
            )
            if not m:
                continue
            labels = {}
            for part in m.group(1).split(","):
                k, _, v = part.partition("=")
                labels[k.strip()] = v.strip().strip('"')
            if all(labels.get(k) == v for k, v in want.items()):
                total += float(m.group(2))
        return total

    ledger_dir18 = tempfile.mkdtemp(prefix="usage_ledger_smoke_")
    backend18 = FakeBackend(
        tokens_per_s=400.0, simulate_delay=True, joules_per_token=0.25
    )
    server18 = GenerationServer(
        backend18, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous", usage_ledger_dir=ledger_dir18,
    )
    server18.start()
    try:
        base18 = f"http://127.0.0.1:{server18.port}"
        client18 = RemoteHTTPBackend(base18)
        # by-hand client-side sums the server's table must reproduce
        hand18 = {}
        for tenant18, n_pred, count in (("acme", 8, 2), ("beta", 4, 1)):
            for k in range(count):
                res18 = client18.generate(
                    _GenReq(
                        "smoke:1b",
                        f"tenant {tenant18} req {k}",
                        max_new_tokens=n_pred,
                        tenant=tenant18,
                    )
                )
                em18 = (res18.extras or {}).get("energy_model") or {}
                # the continuous path stamped SLICE-window attribution
                assert em18.get("window") == "slice", res18.extras
                acct = hand18.setdefault(
                    tenant18, {"ok": 0, "tokens_out": 0, "joules": 0.0}
                )
                acct["ok"] += 1
                acct["tokens_out"] += res18.generated_tokens
                acct["joules"] += em18["J"]
        # a beta client hangs up mid-stream -> outcome=cancelled
        stream18 = client18.generate_stream(
            _GenReq(
                "smoke:1b",
                "tenant cancel stream",
                max_new_tokens=400,
                tenant="beta",
            )
        )
        seen18 = 0
        for chunk in stream18:
            if not getattr(chunk, "done", False) and chunk.tokens:
                seen18 += len(chunk.tokens)
                if seen18 >= 4:
                    break
        stream18.close()
        # wait for the server to retire + account the cancelled row
        deadline18 = time.monotonic() + 10.0
        while True:
            tenants18 = _get_json(base18, "/debug/tenants")
            beta18 = tenants18["tenants"].get("beta", {})
            if beta18.get("requests", {}).get("cancelled"):
                break
            assert time.monotonic() < deadline18, tenants18
            time.sleep(0.05)

        # /debug/tenants reproduces the by-hand sums exactly (fake
        # identity: J == joules_per_token * generated_tokens per row)
        for tenant18, acct in hand18.items():
            table18 = tenants18["tenants"][tenant18]
            assert table18["requests"]["ok"] == acct["ok"], tenants18
            if tenant18 == "acme":
                assert table18["tokens_out"] == acct["tokens_out"], tenants18
                assert abs(table18["joules"] - acct["joules"]) < 1e-6, (
                    table18,
                    acct,
                )
        assert tenants18["ledger"]["dir"] == ledger_dir18, tenants18
        assert tenants18["role"] == "mixed", tenants18

        # the metric families moved with the same figures
        text18 = _scrape(base18)
        assert labelled_value(
            text18, "llm_tenant_requests_total",
            {"tenant": "acme", "outcome": "ok"},
        ) == hand18["acme"]["ok"], "llm_tenant_requests_total{acme} wrong"
        assert labelled_value(
            text18, "llm_tenant_tokens_total",
            {"tenant": "acme", "direction": "out"},
        ) == hand18["acme"]["tokens_out"]
        assert (
            abs(
                labelled_value(
                    text18, "llm_tenant_joules_total", {"tenant": "acme"}
                )
                - hand18["acme"]["joules"]
            )
            < 1e-6
        )
        assert labelled_value(
            text18, "llm_tenant_requests_total",
            {"tenant": "beta", "outcome": "cancelled"},
        ) >= 1

        # kill switch: the endpoint 404s and accounting goes inert
        obs_metrics.disable()
        try:
            try:
                _get_json(base18, "/debug/tenants")
                raise AssertionError(
                    "/debug/tenants served under the kill switch"
                )
            except urllib.error.HTTPError as exc:
                assert exc.code == 404, exc.code
        finally:
            obs_metrics.enable()
    finally:
        server18.stop()

    # stopping the server flushed + closed the ledger and wrote the
    # final aggregate snapshot; both artifacts must be re-readable and
    # AGREE with the table the endpoint served
    records18 = obs_tenants.read_ledger(ledger_dir18)
    assert records18, "usage ledger empty"
    seqs18 = [r["seq"] for r in records18]
    assert seqs18 == sorted(seqs18) and len(set(seqs18)) == len(seqs18), (
        seqs18
    )
    acme_ledger_J = sum(
        r["joules"] for r in records18 if r["tenant"] == "acme"
    )
    assert abs(acme_ledger_J - hand18["acme"]["joules"]) < 1e-6, (
        acme_ledger_J,
        hand18["acme"],
    )
    with open(
        os.path.join(ledger_dir18, "usage_snapshot.json"), encoding="utf-8"
    ) as fh18:
        snap18 = json.load(fh18)
    assert snap18["seq"] == seqs18[-1], snap18
    assert "acme" in snap18["tenants"], snap18

    # 2-replica fleet federation: llm_fleet_tenant_* on the router's
    # scrape equals merging the two replica scrapes by hand
    backend18_a = FakeBackend(tokens_per_s=400.0, joules_per_token=0.2)
    backend18_b = FakeBackend(tokens_per_s=400.0, joules_per_token=0.2)
    server18_a = GenerationServer(
        backend18_a, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous",
    )
    server18_b = GenerationServer(
        backend18_b, host="127.0.0.1", port=0, quiet=True,
        scheduler="continuous",
    )
    server18_a.start()
    server18_b.start()
    base18_a = f"http://127.0.0.1:{server18_a.port}"
    base18_b = f"http://127.0.0.1:{server18_b.port}"
    router18 = Router(
        [
            RemoteReplica("t0", base18_a),
            RemoteReplica("t1", base18_b),
        ],
        policy="round-robin",
        probe_interval_s=30.0,
    )
    rserver18 = RouterServer(router18, host="127.0.0.1", port=0, quiet=True)
    rserver18.start()
    try:
        rbase18 = f"http://127.0.0.1:{rserver18.port}"
        rclient18 = RemoteHTTPBackend(rbase18)
        for k in range(4):  # round-robin spreads fleetco over both
            rclient18.generate(
                _GenReq(
                    "smoke:1b",
                    f"fleet tenant req {k}",
                    max_new_tokens=4,
                    tenant="fleetco",
                )
            )
        expected18 = merge_expositions(
            [("t0", _scrape(base18_a)), ("t1", _scrape(base18_b))]
        )
        want_fleet_J = labelled_value(
            expected18, "llm_fleet_tenant_joules_total",
            {"tenant": "fleetco"},
        )
        got_fleet_J = labelled_value(
            _scrape(rbase18), "llm_fleet_tenant_joules_total",
            {"tenant": "fleetco"},
        )
        assert want_fleet_J > 0, "merged fleet tenant joules empty"
        assert abs(got_fleet_J - want_fleet_J) < 1e-6, (
            got_fleet_J,
            want_fleet_J,
        )
        # the router's own tenant view: fleet rollup sums the replicas
        rtenants18 = _get_json(rbase18, "/debug/tenants")
        assert (
            rtenants18["fleet"]["fleetco"]["requests"]["ok"] >= 4
        ), rtenants18
        # ...and 404s under the kill switch, same as a replica
        obs_metrics.disable()
        try:
            try:
                _get_json(rbase18, "/debug/tenants")
                raise AssertionError(
                    "router /debug/tenants served under the kill switch"
                )
            except urllib.error.HTTPError as exc:
                assert exc.code == 404, exc.code
        finally:
            obs_metrics.enable()
    finally:
        rserver18.stop()
        server18_a.stop()
        server18_b.stop()

    print(
        json.dumps(
            {
                "smoke": "serve-metrics",
                "status": "ok",
                "metric_families": len(
                    [l for l in text.splitlines() if l.startswith("# TYPE")]
                ),
                "spans": len(spans),
                "trace": trace_out,
                "continuous": {
                    "rows_joined": joined,
                    "rows_retired": retired,
                },
                "chunked_join": {
                    "rows_joined": joined3,
                    "join_chunks": join_chunks,
                },
                "flight": {
                    "events": len(events),
                    "dump": flight_out,
                    "summary": flight["summary"],
                },
                "streaming_cancellation": {
                    "delivered_before_disconnect": delivered,
                    "rows_cancelled": cancelled_seen,
                },
                "shared_prefix": {
                    "hit_tokens": hit_tokens,
                    "shared_pages_mid_flight": shared_mid,
                    "prefix_hit_events": len(prefix_hits),
                },
                "tp_continuous": {
                    "mesh": idle_state["mesh"],
                    "sessions_opened": sessions7,
                    "rows_retired": retired7,
                    "per_device_pool": mid7.get("per_device"),
                },
                "speculative": {
                    "rounds": rounds8,
                    "accepted": accepted8,
                    "drafted": drafted8,
                    "fallbacks_at_zero_acceptance": fallbacks8,
                },
                "preemption": {
                    "swap_bytes": swap_out9,
                    "parked_mid_flight": len(mid9.get("parked", [])),
                    "victim_completed_tokens": results9["low_young"][
                        "eval_count"
                    ],
                },
                "router_fleet": {
                    "dispatch_split": split10,
                    "retries_after_kill": retries10,
                    "accepted_stream_tokens_after_kill": stream_done[
                        "tokens"
                    ],
                    "replica_down_events": len(down10),
                    "drained": True,
                },
                "fleet_obs": {
                    "retried_trace": tid11,
                    "dispatch_attempts": len(disp11),
                    "timeline_events": len(tl11["events"]),
                    "wasted_retry_joules": round(wasted_delta, 6),
                    "fleet_requests_total": fleet_req,
                },
                "prefix_store": {
                    "cross_session_hits": int(hits12),
                    "shared_pages_mid_flight": mid12["shared_peak"],
                    "spill_events": len(spill_events12),
                    "restore_events": len(restore_events12),
                },
                "model_fleet": {
                    "small_retired_before_big": True,
                    "escalation_wasted_joules": round(wasted_delta13, 6),
                    "escalated_events": len(escalated_events13),
                    "ps_after_eviction": sorted(names13b),
                },
                "spec_sampled": {
                    "cross_rounds": rounds14,
                    "cross_rejected_tokens": rejected14,
                    "cross_fallbacks": fallbacks14,
                    "draft_wasted_joules": round(wasted_draft14, 6),
                    "wire_agrees": True,
                },
                "slo": {
                    "window_delta_matches_scrape": True,
                    "fired": firing15["trace_id"],
                    "resolved": resolved15["trace_id"],
                    "attainment": gauge15,
                    "replica_recompute_agrees": True,
                    "timeseries_dump": ts_out,
                },
                "pd_disagg": {
                    "roles": roles16,
                    "migrated_trace": tid16,
                    "streamed_tokens_from_decode": streamed16,
                    "migrate_bytes_moved": moved16,
                    "bytes_symmetric": True,
                    "wasted_migration_joules": round(wire_j16, 9),
                    "wire_ledger_agrees": True,
                },
                "affinity_admission": {
                    "affinity_trace": tid17,
                    "affinity_hits": hits17,
                    "est_tokens": aff17["est_tokens"],
                    "full_replica_dispatches": full_disp17,
                    "refused_retries": refused17,
                    "occupant_tokens": occ_done17.get("tokens"),
                    "headroom_recovered": recovered17,
                },
                "tenant_accounting": {
                    "acme_joules": round(hand18["acme"]["joules"], 6),
                    "table_agrees_by_hand": True,
                    "beta_cancelled": beta18["requests"]["cancelled"],
                    "ledger_records": len(records18),
                    "ledger_seq_monotonic": True,
                    "fleet_tenant_joules": round(got_fleet_J, 6),
                    "fleet_equals_merged_scrapes": True,
                    "kill_switch_404": True,
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
