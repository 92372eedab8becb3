"""The port's serving half of the stepped session, its incremental
``generate_stream``, the energy wiring of sessions and batches, the page
pool's swap, and ``serve`` from the command line.

The session cases hold ``TorchEngine(device="cpu", paged_kv=True)``
against ``JaxEngine(paged_kv=True)`` (its stacked mode, with the Pallas
kernels in interpret mode) on the same bridged tiny weights at f32: one
schedule of opens, one-shot and chunked joins (a joiner seated in a slot
that a retired row held, another in a cancelled row's), a cancel, stream
deltas, and a greedy and a sampled row preempted with ``swap`` and
resumed, on the bf16 and the int8 pool. Greedy rows' tokens must equal
the JAX session's and each request's solo ``generate``, exactly; the
sampled row's must equal the port's own solo ``generate`` (the two
frameworks' random streams differ). The refusals are pinned on both
sides, and a speculating session's own: it takes no joiner that may not
speculate and preempts nothing by recompute on the pool. From the
command line, ``serve`` batches without ``--paged-kv`` (the JAX
package's defaults) and with ``--preempt-policy recompute``, speculates
without ``--paged-kv`` and takes ``--spec-accept-floor``, and refuses
with exit 2 the JAX package's engines, a mesh without ``torch-tp`` and
bad values of the replica router's and the multi-model fleet's options
(which ``tests/test_torch_cli.py`` shows taken).
"""

import collections
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine import jax_engine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops.pallas_attention import (
    pallas_decode_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import obs
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.paged_kv import PagePool
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs import energy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner import cli
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import RemoteHTTPBackend
from test_torch_runner import PORT, TESTS
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

POOLS = {"bf16-pool": {}, "int8-pool": dict(kv_quantize="int8")}
MAX_SEQ = 512


def _tiny(config_fn):
    return config_fn("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def np_params():
    params = init_params(_tiny(get_model_config), jax.random.PRNGKey(5), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _port_engine(np_params, **kw):
    eng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", paged_kv=True, **kw)
    eng.install_model("tiny", _tiny(port_config), params_from_numpy(np_params, "cpu", torch.float32))
    return eng


def _jax_engine(np_params, **kw):
    eng = JaxEngine(
        registry={}, dtype=jnp.float32, paged_kv=True,
        decode_attention=pallas_decode_attention, **kw,
    )
    eng.install_model("tiny", _tiny(get_model_config), jax.tree.map(jnp.asarray, np_params))
    assert eng._paged_decode_attention() is not None  # its stacked mode
    return eng


# (prompt, max_new_tokens, knobs); every prompt is unique, results key on it
ROWS = {
    "A": ("the anchor row runs longest", 30, {}),
    "B": ("second row", 8, dict(seed=2)),
    "C": ("the third row is sampled", 28, dict(seed=3, temperature=0.8)),
    "X": ("a row cancelled mid-flight", 24, dict(seed=8)),
    "J1": ("a one-shot joiner " * 3, 12, dict(seed=5)),
    "J2": ("a chunked joiner " * 6, 12, dict(seed=6)),
    "J3": ("joins a preempted row's slot", 8, dict(seed=7)),
}
GREEDY = ("A", "B", "X", "J1", "J2", "J3")


def _schedule(eng, make):
    """One session schedule, the same on both engines: returns
    ({row: result}, {row: streamed tokens}, chunks of J2's join)."""
    req = {k: make("tiny", p, n, stop_at_eos=False, **kw) for k, (p, n, kw) in ROWS.items()}
    name = {id(r): k for k, r in req.items()}
    sess = eng.decode_open([req[k] for k in ("A", "B", "C", "X")], reserve_rows=4)
    sess.stream_tokens = True
    results, streamed = {}, collections.defaultdict(list)

    def pump(n=4):
        for res in sess.step(n):
            results[name[id(res.request)]] = res
        for r, toks, _ in sess.stream_deltas():
            streamed[name[id(r)]].extend(toks)

    pump()
    pump()
    assert "B" in results  # its slot is free again: J1 joins there
    assert sess.can_join(req["J1"])
    sess.join(req["J1"])
    pump()
    assert sess.cancel(req["X"])
    assert not sess.cancel(req["X"])
    pj = sess.join_begin(req["J2"], chunk_tokens=32)  # into the cancelled row's slot
    chunks = pj.total_chunks
    while not sess.join_step(pj):
        pump(2)  # the rows in flight decode between the chunks
    sess.join_commit(pj)
    pump()
    parked = [sess.preempt(req["A"], policy="swap"), sess.preempt(req["C"], policy="swap")]
    assert all(pr is not None and pr.host_bytes > 0 for pr in parked)
    sess.join(req["J3"])
    pump()
    for pr in parked:
        while not sess.can_resume(pr):
            pump()
        pending = sess.resume_begin(pr)
        assert sess.join_step(pending)
        sess.join_commit(pending)
    while sess.active:
        pump()
    pump()  # the last retirements' stream tails
    sess.close()
    return results, streamed, chunks


@pytest.mark.parametrize("pool", list(POOLS))
def test_session_joins_cancel_stream_and_swap_equal_jax_and_solo(np_params, pool, monkeypatch):
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    port = _port_engine(np_params, **POOLS[pool])
    got, streamed, chunks = _schedule(port, GenerationRequest)
    want, _, jax_chunks = _schedule(_jax_engine(np_params, **POOLS[pool]), JaxRequest)
    assert chunks == jax_chunks >= 3
    assert set(got) == set(ROWS) - {"X"} == set(want)
    for k, (prompt, n, kw) in ROWS.items():
        if k == "X":
            continue
        solo = port.generate(GenerationRequest("tiny", prompt, n, stop_at_eos=False, **kw))
        assert got[k].tokens == solo.tokens, (pool, k)
        assert streamed[k] == got[k].tokens, (pool, k)
        if k in GREEDY:
            assert got[k].tokens == want[k].tokens, (pool, k)
            assert got[k].text == want[k].text


def test_admission_refusals_equal_jax(np_params, monkeypatch):
    """``can_join`` refuses another model, another ``top_k``, a request
    past ``max_seq_len`` and a budget past the side caches' ``g_bucket``
    on both engines, and a stacked session preempts nothing with
    ``recompute``."""
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    for eng, make in ((_port_engine(np_params), GenerationRequest),
                      (_jax_engine(np_params), JaxRequest)):
        anchor = make("tiny", "anchor", 16, stop_at_eos=False)
        sess = eng.decode_open([anchor], reserve_rows=4)
        assert sess.g_bucket == 16
        assert sess.can_join(make("tiny", "fits", 16))
        assert not sess.can_join(make("other", "fits", 16))
        assert not sess.can_join(make("tiny", "fits", 16, top_k=5))
        assert not sess.can_join(make("tiny", "y" * (MAX_SEQ - 10), 16))
        assert not sess.can_join(make("tiny", "fits", 18))  # 17 steps > g_bucket 16
        assert sess.preempt(anchor, policy="recompute") is None
        assert sess.active == 1
        sess.close()


def test_a_speculating_session_takes_no_joiners_and_preempts_nothing(np_params):
    """What a speculating session over the pool still refuses: a joiner
    that may not speculate (a repeat penalty, a temperature above
    ``spec_temperature_max``) and a ``recompute`` preemption (the pool's
    policy is swap). An eligible joiner joins, and a row preempted by swap
    resumes; every row keeps its solo tokens."""
    eng = _port_engine(np_params, speculative={"tiny": ("ngram", 3)}, spec_temperature_max=1.0)
    anchor = GenerationRequest("tiny", "abc abc abc abc", 24, stop_at_eos=False)
    sess = eng.decode_open([anchor], reserve_rows=4)
    assert sess.spec is not None
    assert sess.free_slots == 3
    for refused in (GenerationRequest("tiny", "a joiner", 8, repeat_penalty=1.2),
                    GenerationRequest("tiny", "a joiner", 8, temperature=1.5, seed=3)):
        assert not sess.can_join(refused)
        with pytest.raises(RuntimeError, match="cannot join"):
            sess.join_begin(refused)
    assert sess.preempt(anchor, policy="recompute") is None
    joiner = GenerationRequest("tiny", "a joiner", 8, stop_at_eos=False)
    assert sess.can_join(joiner)
    sess.join(joiner)
    results = list(sess.step(2))
    pr = sess.preempt(anchor, policy="swap")
    assert pr is not None and sess.can_resume(pr)
    sess.join_commit(sess.resume_begin(pr))
    while sess.active:
        results.extend(sess.step())
    by_prompt = {r.request.prompt: r.tokens for r in results}
    assert by_prompt[anchor.prompt] == eng.generate(anchor).tokens
    assert by_prompt[joiner.prompt] == eng.generate(joiner).tokens
    sess.close()


def test_a_failed_swap_leaves_the_row_decoding_as_before(np_params, monkeypatch):
    """A preempt whose swap-out (the host copy of its pages) raises
    changes nothing: the row keeps its slot, its table row and its pages,
    and still gives its solo tokens."""
    eng = _port_engine(np_params)
    anchor = GenerationRequest("tiny", "anchor row", 12, stop_at_eos=False)
    victim = GenerationRequest("tiny", "victim row", 12, stop_at_eos=False)
    sess = eng.decode_open([anchor, victim], reserve_rows=4)
    results = list(sess.step(3))
    table = sess.carry["table"].clone()
    free = sess.pool.free_pages

    def fail(pages):
        raise RuntimeError("host copy failed")

    monkeypatch.setattr(sess.pool, "copy_out", fail)
    with pytest.raises(RuntimeError, match="host copy failed"):
        sess.preempt(victim)
    assert sess.active == 2
    assert torch.equal(sess.carry["table"], table)
    assert sess.pool.free_pages == free
    while sess.active:
        results.extend(sess.step())
    by_prompt = {r.request.prompt: r.tokens for r in results}
    assert by_prompt["victim row"] == eng.generate(victim).tokens
    assert by_prompt["anchor row"] == eng.generate(anchor).tokens
    sess.close()


def test_the_scheduler_takes_recompute():
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.scheduler import (
        ContinuousScheduler,
    )

    assert ContinuousScheduler(FakeBackend(), preempt_policy="recompute").preempt_policy == "recompute"


def test_the_scheduler_still_refuses_an_unknown_policy():
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.scheduler import (
        ContinuousScheduler,
    )

    with pytest.raises(ValueError, match="'off', 'swap' or 'recompute'"):
        ContinuousScheduler(FakeBackend(), preempt_policy="maybe")


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_pool_swap_round_trips_pages_exactly(quantized):
    pool = PagePool.create(n_layers=2, n_pages=8, n_kv_heads=2, d_head=16, page_size=128,
                           dtype=torch.float32, quantized=quantized)
    gen = torch.Generator().manual_seed(0)
    for leaf in (pool.k, pool.v):
        for t in (leaf.values() if quantized else (leaf,)):
            t.copy_((torch.randn(t.shape, generator=gen) * 50).to(t.dtype))
    pages = pool.alloc(3)
    before = [{k: v[:, pages].clone() for k, v in (x.items() if quantized else [("t", x)])}
              for x in (pool.k, pool.v)]
    blob = pool.swap_out(pages)
    assert pool.free_pages == 8 and blob.nbytes > 0
    back = pool.swap_in(blob)
    after = [{k: v[:, back] for k, v in (x.items() if quantized else [("t", x)])}
             for x in (pool.k, pool.v)]
    for b, a in zip(before, after):
        for key in b:
            assert torch.equal(b[key], a[key])
    with pytest.raises(ValueError, match="free"):
        pool.swap_out([7])


# -- generate_stream ------------------------------------------------------------


STREAM_CASES = {
    "greedy": dict(),
    "sampled": dict(temperature=0.9, seed=4, top_p=0.9),
    "penalised": dict(repeat_penalty=1.3),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_generate_stream_yields_generate_tokens(np_params, case):
    eng = _port_engine(np_params)
    req = GenerationRequest("tiny", "stream me", 40, stop_at_eos=False, **STREAM_CASES[case])
    chunks = list(eng.generate_stream(req, chunk_tokens=16))
    assert chunks[-1].done and not any(c.done for c in chunks[:-1])
    want = eng.generate(req)
    # the prefill token, then one chunk per 16 decode steps (an EOS ends the last)
    assert len(chunks) - 1 == 1 + -(-(len(want.tokens) - 1) // 16)
    assert chunks[-1].result.tokens == want.tokens
    assert [t for c in chunks[:-1] for t in c.tokens] == want.tokens
    assert "energy_model" in chunks[-1].result.extras


def test_generate_stream_equals_the_jax_engines(np_params):
    port = _port_engine(np_params)
    jeng = _jax_engine(np_params)
    got = list(port.generate_stream(GenerationRequest("tiny", "parity", 24, stop_at_eos=False)))
    want = list(jeng.generate_stream(JaxRequest("tiny", "parity", 24, stop_at_eos=False)))
    assert got[-1].result.tokens == want[-1].result.tokens
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_generate_stream_cuts_at_a_stop_string(np_params):
    eng = _port_engine(np_params)
    free = eng.generate(GenerationRequest("tiny", "stop me", 30, stop_at_eos=False))
    stop = free.text[10:13]
    req = GenerationRequest("tiny", "stop me", 30, stop_at_eos=False, stop=[stop])
    chunks = list(eng.generate_stream(req, chunk_tokens=16))
    want = eng.generate(req)
    assert chunks[-1].result.text == want.text == free.text[: free.text.find(stop)]
    assert "".join(c.text for c in chunks[:-1]) == want.text
    assert [t for c in chunks[:-1] for t in c.tokens] == free.tokens[: len(
        [t for c in chunks[:-1] for t in c.tokens])]


# -- energy ---------------------------------------------------------------------


@pytest.fixture
def obs_on():
    was = obs.enabled()
    obs.enable()
    yield
    if not was:
        obs.disable()


def test_slice_joules_split_over_rows_sum_to_the_slice_window(np_params, obs_on, monkeypatch):
    eng = _port_engine(np_params)
    windows = []
    real = eng._slice_energy

    def record(*a):
        est = real(*a)
        windows.append(est)
        return est

    monkeypatch.setattr(eng, "_slice_energy", record)
    reqs = [GenerationRequest("tiny", f"row {i}", 8 + 4 * i, stop_at_eos=False) for i in range(3)]
    sess = eng.decode_open(reqs, reserve_rows=4)
    results = []
    while sess.active:
        results.extend(sess.step(4))
    sess.close()
    billed = sum(r.extras["energy_model"]["J"] for r in results)
    assert windows and billed == pytest.approx(sum(w["J"] for w in windows), abs=1e-6)
    assert all(r.extras["energy_model"]["window"] == "slice" for r in results)
    assert eng.last_joules_per_token == pytest.approx(results[-1].extras["energy_model"]["J_per_token"])


def test_batch_joules_split_over_rows_sum_to_batch_window_stats(np_params, obs_on):
    eng = _port_engine(np_params)
    reqs = [GenerationRequest("tiny", f"row {i}", 6 + 5 * i, stop_at_eos=False) for i in range(3)]
    results = eng.generate_batch(reqs)
    assert all(r.extras["energy_model"]["window"] == "shared" for r in results)
    stats = energy.batch_window_stats(
        eng._models["tiny"].cfg, results, duration_s=results[0].decode_s
    )
    want = energy.estimate_from_stats(stats)["J"]
    got = sum(r.extras["energy_model"]["J"] for r in results)
    assert got == pytest.approx(want, abs=1e-4 * len(results))


# -- serve from the command line --------------------------------------------------


def test_serve_fake_backend_answers_generate_and_a_stream_then_stops_on_sigterm():
    proc = subprocess.Popen(
        [sys.executable, "-m", PORT, "serve", "--backend", "fake", "--host", "127.0.0.1",
         "--port", "0", "--scheduler", "continuous"],
        cwd=str(TESTS.parent), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"},
    )
    try:
        line = ""
        deadline = time.monotonic() + 60
        while "listening on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "server exited before listening"
        port = int(re.search(r"listening on :(\d+)", line).group(1))
        client = RemoteHTTPBackend(f"http://127.0.0.1:{port}")
        req = GenerationRequest("m", "over the wire", 12, seed=3)
        result = client.generate(req)
        chunks = list(client.generate_stream(req))
        assert chunks[-1].done and chunks[-1].result.tokens == result.tokens
        assert [t for c in chunks[:-1] for t in c.tokens] == result.tokens
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    assert "generation server stopped" in out


REFUSED = {
    "--backend jax": ("the JAX package's engine", ["--backend", "jax"]),
    "--backend jax-tp": ("--backend torch-tp", ["--backend", "jax-tp"]),
    "--tp": ("shape the mesh of --backend torch-tp", ["--backend", "fake", "--tp", "2"]),
    "--dp": ("shape the mesh of --backend torch-tp", ["--backend", "fake", "--dp", "2"]),
    "--replicas": ("--replicas expects a number >= 1", ["--backend", "fake", "--replicas", "0"]),
    "--model-policy": (
        "--model-policy expects one of small-first|cheapest-joules",
        ["--backend", "fake", "--model-policy", "biggest-first"],
    ),
    "--roles": ("--roles expects a comma list", ["--backend", "fake", "--roles", "prefill,bogus"]),
}


@pytest.mark.parametrize("option", list(REFUSED))
def test_serve_refuses_what_is_not_ported_with_exit_2(option, capsys):
    message, args = REFUSED[option]
    assert cli.main(["serve", "--port", "0", *args]) == 2
    assert message in capsys.readouterr().out


# Options that ROADMAP item 12 once refused, now taken: what reaches the
# torch engine (a recorder here) and the server's role.
PREFIX_AND_ROLE_TAKEN = {
    "--prefix-share": (["--prefix-share"], {"prefix_share": True}, "mixed"),
    "--prefix-index-entries": (
        ["--prefix-share", "--prefix-index-entries", "8"],
        {"prefix_share": True, "prefix_index_entries": 8}, "mixed",
    ),
    "--prefix-store-hbm-bytes": (
        ["--prefix-store-hbm-bytes", "1000000"], {"prefix_store_hbm_bytes": 1000000}, "mixed",
    ),
    "--prefix-store-host-bytes": (
        ["--prefix-share", "--prefix-store-host-bytes", "2000"],
        {"prefix_share": True, "prefix_store_host_bytes": 2000}, "mixed",
    ),
    "--role prefill": (["--role", "prefill"], {}, "prefill"),
    "--role decode": (["--role", "decode"], {}, "decode"),
}


@pytest.mark.parametrize("option", list(PREFIX_AND_ROLE_TAKEN))
def test_serve_takes_the_prefix_store_and_role_options(option, monkeypatch):
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend

    args, engine_kw, role = PREFIX_AND_ROLE_TAKEN[option]
    built, served = [], []
    monkeypatch.setattr(torch_engine, "TorchEngine", lambda **kw: built.append(kw) or FakeBackend())
    monkeypatch.setattr(cli, "_serve_until_signalled", served.append)
    assert cli.main(["serve", "--port", "0", "--paged-kv", "--scheduler", "continuous", *args]) == 0
    (kw,) = built
    assert {key: kw.get(key) for key in engine_kw} == engine_kw
    assert served[0].role == role


def test_serve_fake_backend_owns_a_prefix_store_with_its_budgets(monkeypatch):
    served = []
    monkeypatch.setattr(cli, "_serve_until_signalled", served.append)
    args = ["--prefix-share", "--prefix-store-hbm-bytes", "4096", "--prefix-store-host-bytes", "8192"]
    assert cli.main(["serve", "--backend", "fake", "--port", "0", "--scheduler", "continuous", *args]) == 0
    store = served[0].backend.prefix_store
    assert (store.hbm_bytes, store.host_bytes) == (4096, 8192)


def test_serve_without_a_card_exits_2_and_says_so(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["serve", "--port", "0", "--paged-kv", "--scheduler", "continuous"]) == 2
    assert "none is available" in capsys.readouterr().out


# The JAX package's serving defaults: no --paged-kv (the contiguous
# session and contiguous generate_batch), recompute preemption.
BATCHED_WITHOUT_PAGES = {
    "continuous": (["--scheduler", "continuous"], "continuous", "swap"),
    "window": (["--window-ms", "20"], "window", "swap"),
    "continuous recompute": (
        ["--scheduler", "continuous", "--preempt-policy", "recompute"], "continuous", "recompute"
    ),
}


@pytest.mark.parametrize("option", list(BATCHED_WITHOUT_PAGES))
def test_serve_starts_batched_without_paged_kv(option, monkeypatch):
    args, kind, policy = BATCHED_WITHOUT_PAGES[option]
    served = []
    monkeypatch.setattr(cli, "_serve_until_signalled", served.append)
    assert cli.main(["serve", "--backend", "fake", "--port", "0", *args]) == 0
    (server,) = served
    sched = server._scheduler
    assert type(sched).__name__ == {"continuous": "ContinuousScheduler",
                                    "window": "BatchScheduler"}[kind]
    if kind == "continuous":
        assert sched.preempt_policy == policy


# Options that ROADMAP item 13 once refused, now taken: the engine's
# keyword arguments and the scheduler's floor, for each.
SPECULATION_TAKEN = {
    "--spec-accept-floor": (
        ["--paged-kv", "--speculative", "ngram:4", "--spec-accept-floor", "0.3"],
        {"paged_kv": True, "spec_accept_floor": 0.3}, 0.3,
    ),
    "--speculative without --paged-kv": (
        ["--speculative", "ngram:4"], {"paged_kv": False}, None,
    ),
}


@pytest.mark.parametrize("option", list(SPECULATION_TAKEN))
def test_serve_takes_the_speculation_options(option, monkeypatch):
    """``serve --backend torch`` builds its engine with the option (the
    engine here a recorder standing in for the card's) and the continuous
    scheduler forwards the floor to every session it opens."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.fake import FakeBackend

    args, engine_kw, floor = SPECULATION_TAKEN[option]
    built, served = [], []
    monkeypatch.setattr(torch_engine, "TorchEngine", lambda **kw: built.append(kw) or FakeBackend())
    monkeypatch.setattr(cli, "_serve_until_signalled", served.append)
    assert cli.main(["serve", "--port", "0", "--scheduler", "continuous", *args]) == 0
    (kw,) = built
    assert kw["speculative"] == {"default": ("ngram", 4)}
    assert {key: kw.get(key, False) for key in engine_kw} == engine_kw
    assert served[0]._scheduler.spec_accept_floor == floor


@pytest.mark.parametrize("option", ["continuous", "window"])
def test_serve_without_paged_kv_reaches_the_card_check(option, monkeypatch, capsys):
    """The torch backend no longer refuses batching without --paged-kv:
    it goes on to build the engine, which needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["serve", "--port", "0", *BATCHED_WITHOUT_PAGES[option][0]]) == 2
    assert "none is available" in capsys.readouterr().out
