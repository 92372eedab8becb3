"""Live row migration between the port's servers, through its replica
router.

The JAX package pins its migration paths through its ``Router``
(``tests/test_migrate.py``'s seven ``Router`` / ``LocalReplica`` cases,
loaded on the port in ``tests/test_torch_migrate.py``, all over its fake
backend). Here the same paths run over real sockets: in-process
``GenerationServer``s on 127.0.0.1 with the continuous scheduler, each
reached by the port's ``Router`` through a ``RemoteReplica`` (and, where
a case says so, in-process ``LocalReplica``s):

- a request to a fleet of a ``role="prefill"`` and a ``role="decode"``
  server is primed on the first and streams from the second the tokens
  one server gives, greedy and sampled, marked ``migrated``, with the
  byte counters symmetric and the transfer charged to the ledger once
  (2× the bundle's bytes: the router charges each seat it attempts, the
  seating server nothing);
- a receiver that fails to seat leaves the bundle to seat back on the
  source;
- ``drain(migrate=True)`` mid-stream moves the row to the other server,
  and the client's stream continues from its cursor;
- a speculating server's prime decays to a local stream.

Over ``FakeBackend`` and over ``TorchEngine(device="cpu")`` (a tiny
qwen2 at f32 on the paged pool, where a seated row needs an open
session: each receiving server serves a long anchor stream meanwhile, as
the JAX package's engine needs too; its solo ``generate`` is the
reference). A receiver with no open session refuses the seat: the
direct client sees the migration fail and the same bundle seats there
once a session is open, while the router falls back and serves the
request on the prefill server with its solo tokens."""

import contextlib
import threading
import time

import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import obs
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.energy import SWAP_J_PER_BYTE, WASTED_J
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.metrics import MIGRATE_BYTES_C, MIGRATE_ROWS_C
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve import router as router_mod
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import (
    RemoteHTTPBackend,
    RemoteServerError,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.router import (
    LocalReplica,
    RemoteReplica,
    Router,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.server import GenerationServer
from test_torch_runner import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def telemetry_on():
    was = obs.enabled()
    obs.enable()
    yield
    (obs.enable if was else obs.disable)()


@contextlib.contextmanager
def _servers(*backends_roles, models=None):
    srvs = [
        GenerationServer(
            backend, host="127.0.0.1", port=0, scheduler="continuous", role=role,
            max_batch=4, models=models, quiet=True,
        )
        for backend, role in backends_roles
    ]
    for srv in srvs:
        srv.start()
    try:
        yield [RemoteHTTPBackend(f"http://127.0.0.1:{srv.port}") for srv in srvs]
    finally:
        for srv in srvs:
            srv.stop()


def _collect(chunks):
    toks, final = [], None
    for ch in chunks:
        if ch.done:
            final = ch.result
        else:
            toks.extend(ch.tokens)
    return toks, final


@contextlib.contextmanager
def _fleet(*backends_roles, models=None, names=None):
    """``Router`` over one ``RemoteReplica`` a server (probed once, never
    again on its own); yields (router, clients)."""
    with _servers(*backends_roles, models=models) as clients:
        names = names or [f"r{i}" for i in range(len(clients))]
        router = Router(
            [RemoteReplica(n, c.base_url) for n, c in zip(names, clients)], probe_interval_s=999
        )
        try:
            yield router, clients
        finally:
            router.stop()


def _one_server_tokens(backend, request):
    with _servers((backend, "mixed")) as (client,):
        return _collect(client.generate_stream(request))[0]


def _bytes(direction):
    return MIGRATE_BYTES_C.labels(direction=direction).value


def _migrate_failed():
    return router_mod._RETRIES_C.labels(reason="migrate_failed").value


KNOBS = {"greedy": {}, "sampled": {"temperature": 0.8, "top_p": 0.9}}


# -- over the fake backend -----------------------------------------------------


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_primed_row_streams_from_the_decode_server_with_one_servers_tokens(knobs):
    req = GenerationRequest("m", "disagg parity probe", 40, seed=11, **KNOBS[knobs])
    expect = _one_server_tokens(FakeBackend(), req)
    out0, in0 = _bytes("out"), _bytes("in")
    rows0 = MIGRATE_ROWS_C.labels(reason="disagg").value
    j0 = WASTED_J.labels(cause="migration").value
    with _fleet((FakeBackend(), "prefill"), (FakeBackend(), "decode"), names=["p", "d"]) as (router, _):
        toks, final = _collect(router.dispatch_stream(req))
    joules = WASTED_J.labels(cause="migration").value - j0
    assert toks == expect and final.tokens == expect
    assert final.extras["sched"]["migrated"] is True
    assert final.extras["router"]["replica"] == "d"
    moved_out, moved_in = _bytes("out") - out0, _bytes("in") - in0
    assert moved_out == moved_in > 0
    # charged once, by the router: 2x the bundle's bytes
    assert joules == pytest.approx(2.0 * moved_out * SWAP_J_PER_BYTE)
    assert final.extras["energy"]["wasted_J"]["migration"] == pytest.approx(joules)
    assert MIGRATE_ROWS_C.labels(reason="disagg").value == rows0 + 1


def test_failed_receiver_leaves_the_bundle_to_seat_on_the_source():
    req = GenerationRequest("m", "fallback probe", 24, seed=5)
    expect = _one_server_tokens(FakeBackend(), req)
    dead = FakeBackend()
    dead.fail_decode_open = True
    failed0 = _migrate_failed()
    with _fleet((FakeBackend(), "prefill"), (dead, "decode"), names=["p", "d"]) as (router, _):
        toks, final = _collect(router.dispatch_stream(req))
    assert toks == expect and final.extras["sched"]["migrated"] is True
    assert final.extras["router"]["replica"] == "p"
    assert _migrate_failed() == failed0 + 1


def _stream_in_thread(client, request):
    """Consume ``client.generate_stream(request)`` (a ``Router``:
    ``dispatch_stream``) on a thread: returns (tokens list, [final
    result], thread)."""
    toks, final = [], [None]
    chunks = client.dispatch_stream if isinstance(client, Router) else client.generate_stream

    def consume():
        for ch in chunks(request):
            if ch.done:
                final[0] = ch.result
            else:
                toks.extend(ch.tokens)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    return toks, final, t


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert cond(), "timed out"


def test_evacuation_mid_stream_continues_from_the_cursor_elsewhere():
    req = GenerationRequest("m", "drain evacuation probe", 60, seed=9)
    expect = _one_server_tokens(FakeBackend(), req)
    slow = dict(tokens_per_s=200.0, simulate_delay=True)
    with _fleet((FakeBackend(**slow), "mixed"), (FakeBackend(**slow), "mixed"), names=["a", "b"]) as (router, _):
        toks, final, t = _stream_in_thread(router, req)
        _wait_for(lambda: len(toks) >= 10)
        cut = len(toks)
        assert router.drain("a", timeout_s=20.0, migrate=True)
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert 10 <= cut < len(expect)
    assert toks == expect and final[0].tokens == expect
    assert final[0].extras["sched"]["migrated"] is True
    assert final[0].extras["router"]["replica"] == "b"


def test_speculating_prime_decays_to_a_local_stream():
    req = GenerationRequest("m", "spec prime decay", 24, seed=2)
    expect = _one_server_tokens(FakeBackend(spec_k=2), req)
    rows0 = MIGRATE_ROWS_C.labels(reason="disagg").value
    out0 = _bytes("out")
    with _fleet((FakeBackend(spec_k=2), "prefill"), (FakeBackend(spec_k=2), "decode")) as (router, _):
        toks, final = _collect(router.dispatch_stream(req))
    assert toks == expect and final.extras["router"]["replica"] == "r0"
    assert "migrate" not in final.extras and "migrated" not in final.extras.get("sched", {})
    assert MIGRATE_ROWS_C.labels(reason="disagg").value == rows0 and _bytes("out") == out0


# -- over TorchEngine on the CPU -----------------------------------------------

REGISTRY = {"tiny": get_model_config("qwen2:1.5b").tiny(max_seq_len=1024)}


def _engine():
    return TorchEngine(registry=dict(REGISTRY), dtype=torch.float32, device="cpu", paged_kv=True)


@pytest.fixture(scope="module")
def solo():
    return _engine()


def _anchor(prompt):
    # long enough to keep the receiving server's session open while the
    # migrants arrive (a real engine seats a bundle into an open session)
    return GenerationRequest("tiny", prompt, 900, stop_at_eos=False, seed=1)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_real_primed_row_streams_its_solo_tokens_from_the_decode_server(solo, knobs):
    req = GenerationRequest("tiny", "the migrating prompt", 24, stop_at_eos=False, seed=13, **KNOBS[knobs])
    expect = solo.generate(req).tokens
    with _fleet((_engine(), "prefill"), (_engine(), "decode"), models=["tiny"], names=["p", "d"]) as (
        router, (p, d)
    ):
        anchor_toks, anchor_final, t = _stream_in_thread(d, _anchor("decode server anchor"))
        _wait_for(lambda: anchor_toks)
        toks, primed = _collect(p.generate_stream(req, prime=True))
        assert toks == [] and primed.extras["generated"] == 1
        bundle = primed.extras["migrate"]
        assert bundle["kind"] == "real" and bundle["rng"]["dtype"] == "uint8"
        toks, final = _collect(router.dispatch_stream(req))
        assert anchor_final[0] is None, "the anchor ended before the seat"
        t.join(timeout=120.0)
    assert toks == expect
    assert final.extras["sched"]["migrated"] is True and final.extras["router"]["replica"] == "d"


def test_real_evacuation_continues_each_row_from_its_cursor(solo):
    reqs = [
        GenerationRequest("tiny", "first evacuee", 400, stop_at_eos=False, seed=3),
        GenerationRequest("tiny", "second evacuee", 300, stop_at_eos=False, seed=4, temperature=0.7),
    ]
    expect = [solo.generate(r).tokens for r in reqs]
    source = _engine()
    source.load_model("tiny")  # warm on both: the router's placement prefers warm replicas
    with _fleet((source, "mixed"), (_engine(), "mixed"), models=["tiny"], names=["a", "b"]) as (
        router, (_, b)
    ):
        anchor_toks, _, t_anchor = _stream_in_thread(b, _anchor("receiving server anchor"))
        _wait_for(lambda: anchor_toks)
        router.probe_now()  # b's anchor is in flight: least-queue sends both rows to a
        streams = [_stream_in_thread(router, r) for r in reqs]
        _wait_for(lambda: all(s[0] for s in streams))
        cuts = [len(s[0]) for s in streams]
        assert router.drain("a", timeout_s=30.0, migrate=True)
        for (toks, final, t), want, cut in zip(streams, expect, cuts):
            t.join(timeout=120.0)
            assert 1 <= cut < len(want)
            assert toks == want
            assert final[0].extras["sched"]["migrated"] is True
            assert final[0].extras["router"]["replica"] == "b"
        t_anchor.join(timeout=120.0)


def test_real_idle_receiver_fails_the_migration_until_a_session_opens(solo):
    """A real engine anchors a session on its first request: a decode
    server with no live row cannot seat a bundle, and the client sees
    the migration fail. The bundle is untouched: it seats there once an
    anchor has opened a session, and streams the solo tokens."""
    req = GenerationRequest("tiny", "the migrating prompt", 24, stop_at_eos=False, seed=13)
    expect = solo.generate(req).tokens
    with _servers((_engine(), "prefill"), (_engine(), "decode"), models=["tiny"]) as (p, d):
        bundle = _collect(p.generate_stream(req, prime=True))[1].extras["migrate"]
        with pytest.raises(RemoteServerError, match="needs at least one request"):
            _collect(d.migrate_stream(bundle))
        anchor_toks, _, t = _stream_in_thread(d, _anchor("decode server anchor"))
        _wait_for(lambda: anchor_toks)
        toks, final = _collect(d.migrate_stream(bundle))
        t.join(timeout=120.0)
    assert toks == expect and final.extras["sched"]["migrated"] is True


@pytest.mark.parametrize("kind", ["local", "remote"])
def test_real_idle_receiver_through_the_router_falls_back(solo, kind):
    """The routed twin: a decode replica with no open session refuses the
    seat (``SEAT_REFUSED``, a refusal and not a death: the replica stays
    healthy), the router counts ``migrate_failed`` and falls back, and
    the prefill replica serves the request with its solo tokens."""
    req = GenerationRequest("tiny", "the migrating prompt", 24, stop_at_eos=False, seed=13)
    expect = solo.generate(req).tokens
    failed0 = _migrate_failed()
    if kind == "local":
        fleet = contextlib.nullcontext(
            (Router([LocalReplica("p", _engine(), role="prefill"), LocalReplica("d", _engine(), role="decode")],
                    probe_interval_s=999), None)
        )
    else:
        fleet = _fleet((_engine(), "prefill"), (_engine(), "decode"), models=["tiny"], names=["p", "d"])
    with fleet as (router, _):
        try:
            toks, final = _collect(router.dispatch_stream(req))
            healthy = {r.name: r.healthy for r in router.replicas()}
        finally:
            router.stop()
    assert toks == expect and final.tokens == expect
    assert final.extras["router"]["replica"] == "p"
    assert _migrate_failed() >= failed0 + 1
    assert healthy == {"p": True, "d": True}


def test_routed_disagg_transfer_charges_migration_once(solo):
    """A routed disagg transfer between two in-process replicas of the
    real engine is charged exactly once: ``llm_migrate_rows_total
    {reason="disagg"}`` +1 and ``cause="migration"`` +2× the bundle's
    bytes (out and in), the same figure on the ticket's
    ``x_extras.energy``; the seating scheduler charges nothing."""
    req = GenerationRequest("tiny", "the migrating prompt", 24, stop_at_eos=False, seed=13)
    expect = solo.generate(req).tokens
    p = LocalReplica("p", _engine(), role="prefill", max_batch=4)
    d = LocalReplica("d", _engine(), role="decode", max_batch=4)
    router = Router([p, d], probe_interval_s=999)
    try:
        anchor = d.scheduler.submit_stream(_anchor("decode replica anchor"))
        _wait_for(lambda: d.scheduler.health_state().get("inflight_rows"))
        rows0 = MIGRATE_ROWS_C.labels(reason="disagg").value
        j0, in0 = WASTED_J.labels(cause="migration").value, _bytes("in")
        toks, final = _collect(router.dispatch_stream(req))
        joules = WASTED_J.labels(cause="migration").value - j0
        moved = _bytes("in") - in0
        anchor.cancel(cause="disconnect")
    finally:
        router.stop()
    assert toks == expect and final.extras["router"]["replica"] == "d"
    assert MIGRATE_ROWS_C.labels(reason="disagg").value == rows0 + 1
    assert moved > 0 and joules == pytest.approx(2.0 * moved * SWAP_J_PER_BYTE)
    assert final.extras["energy"]["wasted_J"]["migration"] == pytest.approx(joules)
