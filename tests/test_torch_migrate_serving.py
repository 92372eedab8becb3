"""Live row migration between two of the port's servers, checked by hand.

The JAX package pins its migration paths through its replica router
(``tests/test_migrate.py``'s seven ``Router`` / ``LocalReplica`` cases),
which waits for ROADMAP item 15. Their assertions are checked here
without a router: two in-process ``GenerationServer``s on 127.0.0.1 with
the continuous scheduler, the port's client carrying the bundles
between them as a router would (the seating server charges the
transfer to the ledger, ``serve/migrate.py::charge_transfer``):

- a row primed on a ``role="prefill"`` server (``x_prime``) and shipped
  to a ``role="decode"`` server's ``/api/migrate`` streams the tokens one
  server gives, greedy and sampled, marked ``migrated``, with the byte
  counters symmetric and 2× the bundle's bytes charged;
- a receiver that fails to seat leaves the bundle to seat back on the
  source;
- ``/admin/evacuate`` mid-stream ends the stream with a bundle, and the
  row continues on the other server from the client's cursor;
- a speculating server's prime decays to a local stream.

Over ``FakeBackend`` and over ``TorchEngine(device="cpu")`` (a tiny
qwen2 at f32 on the paged pool, where a seated row needs an open
session: each receiving server serves a long anchor stream meanwhile, as
the JAX package's engine needs too; its solo ``generate`` is the
reference). A receiver with no open session fails the migration, and
the same bundle seats there once a session is open."""

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
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import (
    RemoteHTTPBackend,
    RemoteServerError,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.migrate import bundle_nbytes
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


def _one_server_tokens(backend, request):
    with _servers((backend, "mixed")) as (client,):
        return _collect(client.generate_stream(request))[0]


def _bytes(direction):
    return MIGRATE_BYTES_C.labels(direction=direction).value


KNOBS = {"greedy": {}, "sampled": {"temperature": 0.8, "top_p": 0.9}}


# -- over the fake backend -----------------------------------------------------


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_primed_row_streams_from_the_decode_server_with_one_servers_tokens(knobs):
    req = GenerationRequest("m", "disagg parity probe", 40, seed=11, **KNOBS[knobs])
    expect = _one_server_tokens(FakeBackend(), req)
    out0, in0 = _bytes("out"), _bytes("in")
    rows0 = MIGRATE_ROWS_C.labels(reason="disagg").value
    j0 = WASTED_J.labels(cause="migration").value
    with _servers((FakeBackend(), "prefill"), (FakeBackend(), "decode")) as (p, d):
        toks, primed = _collect(p.generate_stream(req, prime=True))
        assert toks == [] and "migrate" in primed.extras
        bundle = primed.extras["migrate"]
        toks, final = _collect(d.migrate_stream(bundle))
    joules = WASTED_J.labels(cause="migration").value - j0
    assert toks == expect and final.tokens == expect
    assert final.extras["sched"]["migrated"] is True
    moved_out, moved_in = _bytes("out") - out0, _bytes("in") - in0
    assert moved_out == moved_in == bundle_nbytes(bundle) > 0
    assert joules == pytest.approx(2.0 * moved_out * SWAP_J_PER_BYTE)
    assert MIGRATE_ROWS_C.labels(reason="disagg").value == rows0 + 1


def test_failed_receiver_leaves_the_bundle_to_seat_on_the_source():
    req = GenerationRequest("m", "fallback probe", 24, seed=5)
    expect = _one_server_tokens(FakeBackend(), req)
    dead = FakeBackend()
    dead.fail_decode_open = True
    with _servers((FakeBackend(), "prefill"), (dead, "decode")) as (p, d):
        bundle = _collect(p.generate_stream(req, prime=True))[1].extras["migrate"]
        with pytest.raises(RemoteServerError):
            _collect(d.migrate_stream(bundle))
        toks, final = _collect(p.migrate_stream(bundle))
    assert toks == expect and final.extras["sched"]["migrated"] is True


def _stream_in_thread(client, request):
    """Consume ``client.generate_stream(request)`` on a thread: returns
    (tokens list, [final result], thread)."""
    toks, final = [], [None]

    def consume():
        for ch in client.generate_stream(request):
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
    with _servers((FakeBackend(**slow), "mixed"), (FakeBackend(**slow), "mixed")) as (a, b):
        toks, final, t = _stream_in_thread(a, req)
        _wait_for(lambda: len(toks) >= 10)
        assert a.evacuate(timeout_s=20.0) == 1
        t.join(timeout=30.0)
        assert not t.is_alive() and final[0].extras["evacuated"] is True
        rest, seated = _collect(b.migrate_stream(final[0].extras["migrate"]))
    assert 10 <= len(toks) < len(expect)
    assert toks + rest == expect
    assert seated.extras["sched"]["migrated"] is True


def test_speculating_prime_decays_to_a_local_stream():
    req = GenerationRequest("m", "spec prime decay", 24, seed=2)
    expect = _one_server_tokens(FakeBackend(spec_k=2), req)
    rows0 = MIGRATE_ROWS_C.labels(reason="disagg").value
    out0 = _bytes("out")
    with _servers((FakeBackend(spec_k=2), "prefill")) as (p,):
        toks, final = _collect(p.generate_stream(req, prime=True))
    assert toks == expect
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
    with _servers((_engine(), "prefill"), (_engine(), "decode"), models=["tiny"]) as (p, d):
        anchor_toks, anchor_final, t = _stream_in_thread(d, _anchor("decode server anchor"))
        _wait_for(lambda: anchor_toks)
        toks, primed = _collect(p.generate_stream(req, prime=True))
        assert toks == [] and primed.extras["generated"] == 1
        bundle = primed.extras["migrate"]
        assert bundle["kind"] == "real" and bundle["rng"]["dtype"] == "uint8"
        toks, final = _collect(d.migrate_stream(bundle))
        assert anchor_final[0] is None, "the anchor ended before the seat"
        t.join(timeout=120.0)
    assert toks == expect
    assert final.extras["sched"]["migrated"] is True


def test_real_evacuation_continues_each_row_from_its_cursor(solo):
    reqs = [
        GenerationRequest("tiny", "first evacuee", 400, stop_at_eos=False, seed=3),
        GenerationRequest("tiny", "second evacuee", 300, stop_at_eos=False, seed=4, temperature=0.7),
    ]
    expect = [solo.generate(r).tokens for r in reqs]
    with _servers((_engine(), "mixed"), (_engine(), "mixed"), models=["tiny"]) as (a, b):
        anchor_toks, _, t_anchor = _stream_in_thread(b, _anchor("receiving server anchor"))
        _wait_for(lambda: anchor_toks)
        streams = [_stream_in_thread(a, r) for r in reqs]
        _wait_for(lambda: all(s[0] for s in streams))
        assert a.evacuate(timeout_s=30.0) == 2
        for (toks, final, t), want in zip(streams, expect):
            t.join(timeout=30.0)
            assert final[0].extras["evacuated"] is True
            rest, seated = _collect(b.migrate_stream(final[0].extras["migrate"]))
            assert 1 <= len(toks) < len(want)
            assert toks + rest == want
            assert seated.extras["sched"]["migrated"] is True
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
