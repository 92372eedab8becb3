"""The port's contiguous KV layouts and model residency on the CPU.

The JAX package's engine cases, loaded with the package name swapped
(see ``test_torch_runner.load_cases``) onto ``TorchEngine(device="cpu")``
at f32, whose ``generate_batch`` now decodes over one contiguous batch
cache by default:

- from ``tests/test_engine.py``: the ``generate_batch`` cases (greedy,
  sampled and mixed-knob rows equal to their solo ``generate``, input
  checks, fleets split at the memory-bounded width, the width estimate,
  mixed ``top_p`` rows, grouped prefill per prompt bucket, decode-window
  ids) and the residency cases (LRU eviction under an allocation budget,
  recency refreshed on use, a re-install dropping the old state).
  ``test_install_model_reinstall_evicts_stale_state`` is loaded without
  its reads of ``_prefill_cache`` (compiled prefill functions, which the
  port has not); its prefix-cache and ``_decode_cache`` assertions stay.
  The two grouped-prefill cases count prefill forwards
  (a ``forward`` of more than one token) where the JAX file counts calls
  of its compiled prefill functions. Left out of this range:
  ``test_max_batch_rows_paged_estimates_are_mode_aware`` (it drives the
  JAX engine's unstacked paged mode, which the port has not; the paged
  estimates are held against the JAX engine's in
  ``tests/test_torch_batch_engine.py``) and
  ``test_generate_batch_grouped_prefill_with_prefix_cache`` (loaded by
  ``tests/test_torch_prefix_cache.py``).
- from ``tests/test_kv_quantize.py``: an int8-KV contiguous batch equal
  to its rows' solo decodes, and installed weights never evicted.

Then the port's own: contiguous ``generate_batch`` and a contiguous
session (joins one-shot and chunked, a cancel, stream deltas, a swap and
a recompute preemption) hold greedy tokens equal to the JAX engine's on
bridged weights, with bf16 and int8 caches; the LRU guard defers a model
with a live session, and eviction drops every reference to the weights;
the budgets come from the env or the card."""

import collections
import gc
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.utils import memory as jax_memory
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.metrics import MODEL_EVICT_DEFERRED_C
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.utils import memory
from test_torch_runner import TESTS, load_cases

_SPY = re.search(r"def _spy_prefill_calls\(.*?\n\n\n", (TESTS / "test_engine.py").read_text(), re.S)
ENGINE_RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp\n", "import jax.numpy as jnp\nimport torch\n"),
    ("TorchEngine(registry=registry, dtype=jnp.float32)",
     'TorchEngine(registry=registry, dtype=torch.float32, device="cpu")'),
    ("TorchEngine(registry={}, dtype=jnp.float32, prefix_cache_size=2)",
     'TorchEngine(registry={}, dtype=torch.float32, device="cpu", prefix_cache_size=2)'),
    ('    assert eng._prefill_cache and eng._prefix_cache.get("m")\n',
     '    assert eng._prefix_cache.get("m")\n'),
    ('    assert not [k for k in eng._prefill_cache if "m" in k]\n', ""),
    ("jax.random.PRNGKey(0), jnp.float32)", "torch.Generator().manual_seed(0), torch.float32)"),
    ("jax.random.PRNGKey(1), jnp.float32)", "torch.Generator().manual_seed(1), torch.float32)"),
    (_SPY.group(0), '''def _spy_prefill_calls(monkeypatch, engine):
    """Count the prefill forwards (one per chunk/group): a forward of
    more than one token through the engine module's ``forward``."""
    import cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine as te

    calls = []
    orig = te.forward

    def spy(params, cfg, tokens, *args, **kwargs):
        if tokens.shape[1] > 1:
            calls.append(tuple(tokens.shape))
        return orig(params, cfg, tokens, *args, **kwargs)

    monkeypatch.setattr(te, "forward", spy)
    return calls


'''),
)
ENGINE_CASES = (
    "test_generate_batch_matches_single_greedy",
    "test_generate_batch_matches_single_sampled",
    "test_generate_batch_mixed_knobs",
    "test_generate_batch_validates_inputs",
    "test_generate_batch_chunks_oversized_fleets",
    "test_generate_batch_width_is_memory_bounded",
    "test_generate_batch_mixed_top_p_rows_stay_bit_identical",
    "test_install_model_reinstall_evicts_stale_state",
    "test_lru_weight_eviction_under_allocation_budget",
    "test_lru_recency_updated_on_use",
    "test_generate_batch_groups_same_bucket_prefills",
    "test_generate_batch_mixed_buckets_one_prefill_per_group",
    "test_batch_results_carry_explicit_decode_window_ids",
)
KV_RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp\n", "import jax.numpy as jnp\nimport torch\n"),
    ("TorchEngine(registry=dict(registry), dtype=jnp.float32)",
     'TorchEngine(registry=dict(registry), dtype=torch.float32, device="cpu")'),
    ('registry=dict(registry), dtype=jnp.float32, kv_quantize="int8"\n',
     'registry=dict(registry), dtype=torch.float32, device="cpu", kv_quantize="int8"\n'),
    ('TorchEngine(registry={"b": cfg_b}, dtype=jnp.float32)',
     'TorchEngine(registry={"b": cfg_b}, dtype=torch.float32, device="cpu")'),
    ("jax.random.PRNGKey(7), jnp.float32)", "torch.Generator().manual_seed(7), torch.float32)"),
)
KV_CASES = ("test_kv_quantize_batch_matches_single", "test_installed_models_never_evicted")


def _load():
    """Both files' cases into this module; each file's fixtures are its
    own (``engines`` is test_kv_quantize.py's, ``engine`` test_engine.py's)."""
    engine_ns, kv_ns = {}, {}
    cases = load_cases(engine_ns, "test_engine.py", renames=ENGINE_RENAMES, only=ENGINE_CASES)
    cases += load_cases(kv_ns, "test_kv_quantize.py", renames=KV_RENAMES, only=KV_CASES)
    clash = {n for n in engine_ns if not n.startswith("__")} & {n for n in kv_ns if not n.startswith("__")}
    for name, value in engine_ns.items():
        if not name.startswith("__"):
            globals()[name] = value
    for name, value in kv_ns.items():
        if not name.startswith("__") and name not in clash:
            globals()[name] = value
    return cases


CASES = _load()


def test_every_engine_case_is_loaded():
    assert sorted(CASES) == sorted(ENGINE_CASES + KV_CASES)


# -- the contiguous layouts against the JAX engine on bridged weights ---------
KV = {"bf16": {}, "int8": dict(kv_quantize="int8")}
MAX_SEQ = 512


def _tiny(config_fn):
    return config_fn("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def np_params():
    params = init_params(_tiny(get_model_config), jax.random.PRNGKey(11), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _port_engine(np_params, **kw):
    eng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    eng.install_model("tiny", _tiny(port_config), params_from_numpy(np_params, "cpu", torch.float32))
    return eng


def _jax_engine(np_params, **kw):
    eng = JaxEngine(registry={}, dtype=jnp.float32, **kw)
    eng.install_model("tiny", _tiny(get_model_config), jax.tree.map(jnp.asarray, np_params))
    return eng


BATCH = (
    ("a short row", 10, {}),
    ("a second, rather longer row of the batch", 14, {}),
    ("x" * 90, 9, {}),  # a longer prompt bucket: every row at the widest shape
    ("a sampled row", 12, dict(seed=4, temperature=0.9)),
)


@pytest.mark.parametrize("kv", list(KV))
def test_contiguous_batch_equals_jax_and_solo(np_params, kv):
    port, jx = _port_engine(np_params, **KV[kv]), _jax_engine(np_params, **KV[kv])
    got = port.generate_batch([GenerationRequest("tiny", p, n, **k) for p, n, k in BATCH])
    want = jx.generate_batch([JaxRequest("tiny", p, n, **k) for p, n, k in BATCH])
    for (prompt, n, knobs), g, w in zip(BATCH, got, want):
        assert g.tokens == port.generate(GenerationRequest("tiny", prompt, n, **knobs)).tokens
        if not knobs:  # the two frameworks' random streams differ
            assert g.tokens == w.tokens and g.text == w.text, (kv, prompt)
        assert g.extras["energy_model"]["window"] == "shared"


# (prompt, max_new_tokens, knobs); every prompt is unique, results key on it
ROWS = {
    "A": ("the anchor row runs longest, and its prompt needs the 128 bucket", 30, {}),
    "B": ("second row", 8, dict(seed=2)),
    "C": ("the third row is sampled", 28, dict(seed=3, temperature=0.8)),
    "X": ("a row cancelled mid-flight", 24, dict(seed=8)),
    "J1": ("a one-shot joiner " * 3, 12, dict(seed=5)),
    "J2": ("a chunked joiner " * 5, 24, dict(seed=6)),
    "J3": ("z" * 200, 8, dict(seed=7)),  # 256 + 16 positions: past the row cache
}
GREEDY = ("A", "B", "J1", "J2")


def _schedule(eng, make):
    """One contiguous session schedule, the same on both engines: returns
    ({row: result}, {row: streamed tokens}, chunks of J2's join)."""
    req = {k: make("tiny", p, n, stop_at_eos=False, **kw) for k, (p, n, kw) in ROWS.items()}
    name = {id(r): k for k, r in req.items()}
    sess = eng.decode_open([req[k] for k in ("A", "B", "C", "X")], reserve_rows=4)
    assert sess.cache_len == 128 + 32
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
    assert not sess.can_join(req["J3"])
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
    parked = [sess.preempt(req["A"], policy="swap"), sess.preempt(req["J2"], policy="recompute")]
    assert parked[0].host_bytes > 0 and parked[1].host_bytes == 0
    pump()
    for pr in parked:
        while not sess.can_resume(pr):
            pump()
        pending = sess.resume_begin(pr, 32)
        while not sess.join_step(pending):
            pump(2)
        sess.join_commit(pending)
    while sess.active:
        pump()
    pump()  # the last retirements' stream tails
    sess.close()
    return results, streamed, chunks


@pytest.mark.parametrize("kv", list(KV))
def test_contiguous_session_equals_jax_and_solo(np_params, kv):
    port = _port_engine(np_params, **KV[kv])
    got, streamed, chunks = _schedule(port, GenerationRequest)
    want, _, jax_chunks = _schedule(_jax_engine(np_params, **KV[kv]), JaxRequest)
    assert chunks == jax_chunks == 3
    assert set(got) == set(ROWS) - {"X", "J3"} == set(want)
    for k in got:
        prompt, n, kw = ROWS[k]
        solo = port.generate(GenerationRequest("tiny", prompt, n, stop_at_eos=False, **kw))
        assert got[k].tokens == solo.tokens, (kv, k)
        assert streamed[k] == got[k].tokens, (kv, k)
        if k in GREEDY:
            assert got[k].tokens == want[k].tokens, (kv, k)
            assert got[k].text == want[k].text


def test_a_contiguous_session_that_would_speculate_raises_naming_item_13(np_params):
    eng = _port_engine(np_params, speculative={"tiny": ("ngram", 3)})
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        eng.decode_open([GenerationRequest("tiny", "abc abc abc", 8)])
    assert eng.live_sessions("tiny") == 0  # a failed open leaks no pin


# -- model residency ------------------------------------------------------------
RESIDENCY = {
    "a": port_config("qwen2:1.5b").tiny(),
    "b": port_config("gemma:2b").tiny(),
    "c": port_config("phi3:3.8b").tiny(),
}


def _est(name):
    return memory.estimate_weight_bytes(RESIDENCY[name], None, 4)


def test_a_model_with_a_live_session_is_not_evicted(monkeypatch):
    monkeypatch.setattr(memory, "LOAD_TRANSIENT_HEADROOM_BYTES", 0)
    # any two fit, all three do not
    budget = max(_est("a") + _est("b"), _est("a") + _est("c"), _est("b") + _est("c"))
    monkeypatch.setenv("TPU_ALLOC_BUDGET_BYTES", str(budget))
    eng = TorchEngine(registry=dict(RESIDENCY), dtype=torch.float32, device="cpu")
    row = GenerationRequest("a", "a live row", 12, stop_at_eos=False)
    sess = eng.decode_open([row], reserve_rows=2)
    assert eng.live_sessions("a") == 1
    assert eng.models_debug_state()["loaded"]["a"]["live_sessions"] == 1
    eng.load_model("b")
    eng.load_model("c")  # a is the least recently used, but its session is live
    assert eng.loaded_models() == ["a", "c"]
    eng.load_model("b")  # and again: c goes
    assert eng.loaded_models() == ["a", "b"]
    results = []
    while sess.active:
        results.extend(sess.step())
    sess.close()
    assert eng.live_sessions("a") == 0
    eng.load_model("c")  # no session now: a, the least recently used, goes
    assert eng.loaded_models() == ["b", "c"]
    assert results[0].tokens == eng.generate(row).tokens  # a reloads as it was


def test_eviction_defers_when_only_live_models_remain(monkeypatch):
    monkeypatch.setattr(memory, "LOAD_TRANSIENT_HEADROOM_BYTES", 0)
    monkeypatch.setenv("TPU_ALLOC_BUDGET_BYTES", str(_est("a")))
    eng = TorchEngine(registry=dict(RESIDENCY), dtype=torch.float32, device="cpu")
    sess = eng.decode_open([GenerationRequest("a", "a live row", 6)])
    deferred = MODEL_EVICT_DEFERRED_C.labels().value
    eng.load_model("b")  # over the budget: the only victim has a live session
    assert eng.loaded_models() == ["a", "b"]
    assert MODEL_EVICT_DEFERRED_C.labels().value == deferred + 1
    sess.close()


def test_eviction_drops_every_reference_to_the_weights(monkeypatch):
    """Nothing the engine keeps after a model was used (step functions,
    warm markers, closed sessions, batch results) holds its weights: once
    evicted, a weight tensor and its per-layer view are freed."""
    monkeypatch.setattr(memory, "LOAD_TRANSIENT_HEADROOM_BYTES", 0)
    monkeypatch.setenv("TPU_ALLOC_BUDGET_BYTES", str(max(_est("a"), _est("b"))))
    eng = TorchEngine(registry=dict(RESIDENCY), dtype=torch.float32, device="cpu")
    req = GenerationRequest("a", "use every path", 6)
    eng.warmup(req)
    solo = eng.generate(req)
    batch = eng.generate_batch([req, GenerationRequest("a", "another row", 5)])
    sess = eng.decode_open([req])
    while sess.active:
        sess.step()
    sess.close()
    tf = eng._models["a"]
    refs = [weakref.ref(tf.params["wq"]), weakref.ref(tf.layers[0]["wq"]), weakref.ref(tf.params["embed"])]
    del tf
    eng.load_model("b")
    gc.collect()
    assert eng.loaded_models() == ["b"]
    assert [r() for r in refs] == [None, None, None]
    assert solo.tokens == batch[0].tokens == eng.generate(req).tokens  # a reloads as it was


def test_a_load_past_the_memory_budget_fails_fast(monkeypatch):
    monkeypatch.setenv("TPU_MEMORY_BUDGET_BYTES", str(_est("a") // 2))
    eng = TorchEngine(registry=dict(RESIDENCY), dtype=torch.float32, device="cpu")
    with pytest.raises(memory.ModelMemoryError, match="TPU_MEMORY_BUDGET_BYTES"):
        eng.load_model("a")
    assert eng.loaded_models() == []


def test_budgets_come_from_the_env_or_the_card_as_the_jax_packages_do(monkeypatch):
    for name in ("TPU_ALLOC_BUDGET_BYTES", "TPU_MEMORY_BUDGET_BYTES"):
        monkeypatch.delenv(name, raising=False)
    assert memory.device_allocation_budget("cpu") is None is memory.device_memory_budget("cpu")
    assert jax_memory.device_allocation_budget(jax.devices("cpu")[0]) is None
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1, 80 * 2**30))
    assert memory.device_allocation_budget("cuda:0") == 80 * 2**30
    assert memory.device_memory_budget("cuda:0") == memory.MemoryBudget(80 * 2**30)
    monkeypatch.setenv("TPU_ALLOC_BUDGET_BYTES", "1234")
    monkeypatch.setenv("TPU_MEMORY_BUDGET_BYTES", "5678")
    assert memory.device_allocation_budget("cuda:0") == 1234 == jax_memory.device_allocation_budget()
    assert memory.device_memory_budget("cpu").bytes == 5678 == jax_memory.device_memory_budget().bytes
    assert not memory.device_memory_budget("cpu").per_program
