"""The port's solo prompt-prefix KV cache on the CPU.

The JAX package's prefix-cache cases, loaded with the package name
swapped (``test_torch_runner.load_cases``) onto ``TorchEngine(device=
"cpu")`` at f32:

- from ``tests/test_engine.py``: exact and partial hits equal to a cold
  engine, the LRU entry cap, the byte cap across models and its LRU
  order, prefix entries evicted before a model load that would pass the
  allocation budget, a byte cap alone enabling the cache, the cache off by
  default, a partial hit near the cache's end shrinking instead of
  writing past it, a negative size refused, entries holding only the
  prompt's positions, and ``generate_batch`` with hit rows prefilling
  solo;
- from ``tests/test_kv_quantize.py``: the cache under ``kv_quantize=
  "int8"`` (it stores the bf16 prefill, quantized after the seed).

Then the port against the JAX engine on bridged weights: the same
request sequence gives the same greedy tokens, the same cache keys in the
same LRU order, the same cached K/V and the same evictions (entry and
byte caps), with bf16-layout and int8 decode caches; a hit prefills one
chunk where a cold prompt of the chunk size plus a tail prefills two;
an entry is a copy, never a view of a request's cache. Last, the serve
CLI: ``--prefix-cache`` reaches the engine, and so does ``--prefix-share``
(the shared prefix store, ``tests/test_torch_prefix.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine as jax_engine_mod
import cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine as te
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner import cli
from test_torch_runner import load_cases
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

TO_CPU = ("dtype=jnp.float32", 'dtype=torch.float32, device="cpu"')
ENGINE_RENAMES = (
    ("engine.jax_engine", "engine.torch_engine"),
    ("JaxEngine", "TorchEngine"),
    ("import jax.numpy as jnp\n", "import jax.numpy as jnp\nimport torch\n"),
    TO_CPU,
)
ENGINE_CASES = (
    "test_prefix_cache_exact_and_partial_hits",
    "test_prefix_cache_lru_eviction",
    "test_prefix_cache_byte_cap_evicts_lru",
    "test_prefix_kv_evicted_before_model_load_exceeds_budget",
    "test_prefix_cache_byte_cap_alone_enables_cache",
    "test_prefix_cache_disabled_by_default",
    "test_prefix_cache_partial_hit_near_cache_boundary",
    "test_prefix_cache_rejects_negative_size",
    "test_prefix_cache_entries_store_only_prompt_region",
    "test_generate_batch_grouped_prefill_with_prefix_cache",
)
KV_CASES = ("test_kv_quantize_composes_with_prefix_cache",)


def _load():
    engine_ns, kv_ns = {}, {}
    cases = load_cases(engine_ns, "test_engine.py", renames=ENGINE_RENAMES, only=ENGINE_CASES)
    cases += load_cases(kv_ns, "test_kv_quantize.py", renames=ENGINE_RENAMES, only=KV_CASES)
    clash = {n for n in engine_ns if not n.startswith("__")} & {n for n in kv_ns if not n.startswith("__")}
    for ns, skip in ((engine_ns, set()), (kv_ns, clash)):
        for name, value in ns.items():
            if not name.startswith("__") and name not in skip:
                globals()[name] = value
    return cases


CASES = _load()


def test_every_prefix_case_is_loaded():
    assert sorted(CASES) == sorted(ENGINE_CASES + KV_CASES)


# -- the port against the JAX engine on bridged weights ----------------------
MAX_SEQ = 512
KV = {"bf16": {}, "int8": dict(kv_quantize="int8")}


def _tiny(config_fn):
    return config_fn("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def np_params():
    params = init_params(_tiny(get_model_config), jax.random.PRNGKey(5), jnp.float32)
    return jax.tree.map(np.asarray, params)


def _pair(np_params, **kw):
    port = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    port.install_model("tiny", _tiny(port_config), params_from_numpy(np_params, "cpu", torch.float32))
    jx = JaxEngine(registry={}, dtype=jnp.float32, **kw)
    jx.install_model("tiny", _tiny(get_model_config), jax.tree.map(jnp.asarray, np_params))
    return port, jx


SYSTEM = "You are a careful assistant who answers briefly. "
# (prompt, max_new_tokens): a miss, an exact hit, two extensions of it,
# one of an extension, an unrelated prompt, and a re-ask of the first
SEQUENCE = (
    (SYSTEM + "First question?", 8),
    (SYSTEM + "First question?", 8),
    (SYSTEM + "First question? And a follow-up.", 10),
    (SYSTEM + "First question? And a follow-up. And one more, a longer one.", 6),
    (SYSTEM + "Second question?", 9),
    ("An unrelated prompt with no shared system text", 7),
    (SYSTEM + "First question?", 5),
)


def _entries(engine, model="tiny"):
    return list(engine._prefix_cache.get(model, {}))


def _assert_same_entries(port, jx):
    assert _entries(port) == _entries(jx)
    for key in _entries(port):
        pk, pv, plog, _ = port._prefix_cache["tiny"][key]
        jk, jv, jlog, _ = jx._prefix_cache["tiny"][key]
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("size", [3, 8])
def test_prefix_cache_equals_jax_tokens_entries_and_evictions(np_params, kv, size):
    port, jx = _pair(np_params, prefix_cache_size=size, **KV[kv])
    for prompt, n in SEQUENCE:
        got = port.generate(GenerationRequest("tiny", prompt, n, stop_at_eos=False))
        want = jx.generate(JaxRequest("tiny", prompt, n, stop_at_eos=False))
        assert got.tokens == want.tokens, (kv, size, prompt)
        _assert_same_entries(port, jx)
    assert port._prefix_bytes() == jx._prefix_bytes()
    assert len(_entries(port)) == min(size, 5)  # five distinct prompts


@pytest.mark.parametrize("kv", list(KV))
def test_prefix_byte_cap_evicts_as_jax_does(np_params, kv):
    port, jx = _pair(np_params, prefix_cache_size=8, **KV[kv])
    port.generate(GenerationRequest("tiny", SEQUENCE[0][0], 4))
    cap = int(2.2 * port._prefix_bytes())
    port, jx = _pair(np_params, prefix_cache_size=8, prefix_cache_bytes=cap, **KV[kv])
    for prompt, n in SEQUENCE:
        got = port.generate(GenerationRequest("tiny", prompt, n, stop_at_eos=False))
        want = jx.generate(JaxRequest("tiny", prompt, n, stop_at_eos=False))
        assert got.tokens == want.tokens, (kv, prompt)
        assert _entries(port) == _entries(jx), prompt
        assert port._prefix_bytes() <= cap
    assert port._prefix_bytes() == jx._prefix_bytes()


def test_a_hit_prefills_only_the_tail_chunk(np_params, monkeypatch):
    """The chip's two-turn shape at the CPU's size: turn 1 is exactly one
    prefill chunk, turn 2 that prompt plus a tail; cold, turn 2 runs two
    prefill forwards, with a hit one, at the chunk's offset, and the
    tokens are the cold engine's and the JAX engine's."""
    chunk = 64
    monkeypatch.setattr(te, "PREFILL_CHUNK", chunk)
    monkeypatch.setattr(jax_engine_mod, "PREFILL_CHUNK", chunk)
    turn1 = "t" * (chunk - 1)  # + BOS: exactly one chunk
    turn2 = turn1 + " and sixteen more"
    forwards = []
    orig = te.forward

    def spy(params, cfg, tokens, offset, *args, **kwargs):
        if tokens.shape[1] > 1:
            forwards.append((tokens.shape[1], int(offset)))
        return orig(params, cfg, tokens, offset, *args, **kwargs)

    monkeypatch.setattr(te, "forward", spy)
    for kv in KV:
        cold, jx = _pair(np_params, **KV[kv])
        warm, _ = _pair(np_params, prefix_cache_size=4, **KV[kv])
        req = GenerationRequest("tiny", turn2, 12, stop_at_eos=False)
        warm.generate(GenerationRequest("tiny", turn1, 6, stop_at_eos=False))
        forwards.clear()
        want = cold.generate(req)
        assert forwards == [(chunk, 0), (32, chunk)]
        forwards.clear()
        got = warm.generate(req)
        assert forwards == [(32, chunk)]
        assert warm._prefix_hits == 1
        assert got.tokens == want.tokens == jx.generate(JaxRequest("tiny", turn2, 12, stop_at_eos=False)).tokens


def test_an_entry_is_a_copy_of_the_prompt_region(np_params):
    port, _ = _pair(np_params, prefix_cache_size=2)
    captured = {}
    run_prefill = port._run_prefill

    def keep(model, ids, cache_len):
        out = run_prefill(model, ids, cache_len)
        captured["k"] = out[1]
        return out

    port._run_prefill = keep
    port.generate(GenerationRequest("tiny", "abcdef", 20, stop_at_eos=False))
    (k, v, _, _), = port._prefix_cache["tiny"].values()
    assert k.shape[3] == v.shape[3] == 7  # BOS + 6 bytes
    assert k._base is None and k.untyped_storage().data_ptr() != captured["k"].untyped_storage().data_ptr()
    assert port._prefix_bytes() == 2 * k.numel() * k.element_size() + 259 * 4
    assert port.prefix_cache_state() == {"entries": {"tiny": 1}, "bytes": port._prefix_bytes(), "hits": 0}
    assert port.models_debug_state()["prefix_cache"]["entries"] == {"tiny": 1}


def test_prefix_cache_goes_with_the_model(np_params):
    port, _ = _pair(np_params, prefix_cache_size=2)
    port.generate(GenerationRequest("tiny", "abc", 4))
    assert port._prefix_cache["tiny"]
    port._evict_weights("tiny")
    assert "tiny" not in port._prefix_cache
    port, _ = _pair(np_params, prefix_cache_size=2)
    port.generate(GenerationRequest("tiny", "abc", 4))
    port.unload_all()
    assert port._prefix_cache == {}


def test_prefix_share_builds_the_store_beside_the_cache():
    eng = TorchEngine(device="cpu", prefix_share=True, prefix_cache_size=2)
    assert eng.prefix_store is not None and eng._prefix_enabled


# -- the serve CLI -------------------------------------------------------------
def test_serve_prefix_share_reaches_the_engine(monkeypatch, capsys):
    seen = {}

    def fake_engine(**kwargs):
        seen.update(kwargs)
        raise RuntimeError("engine built")

    monkeypatch.setattr(te, "TorchEngine", fake_engine)
    assert cli.main(["serve", "--port", "0", "--prefix-share", "--prefix-cache", "3"]) == 2
    assert "engine built" in capsys.readouterr().out
    assert seen.get("prefix_share") is True and seen.get("prefix_cache_size") == 3


@pytest.mark.parametrize("args, size", [(["--prefix-cache", "6"], 6), (["--prefix-cache"], 4), ([], None)])
def test_serve_prefix_cache_reaches_the_engine(args, size, monkeypatch, capsys):
    seen = {}

    def fake_engine(**kwargs):
        seen.update(kwargs)
        raise RuntimeError("engine built")

    monkeypatch.setattr(te, "TorchEngine", fake_engine)
    assert cli.main(["serve", "--port", "0", *args]) == 2
    assert "engine built" in capsys.readouterr().out
    assert seen.get("prefix_cache_size") == size


def test_served_requests_hit_the_cache_and_debug_state_counts_them(np_params):
    """What ``chip_smoke.py``'s ``serve_cli_hf`` reads: three requests
    through the HTTP server, the second and third extending the first's
    prompt, leave two prefix hits in ``GET /debug/state``; each answer is
    a cold engine's."""
    import json
    import urllib.request

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch import obs
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import RemoteHTTPBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.server import GenerationServer

    warm, _ = _pair(np_params, prefix_cache_size=4)
    cold, _ = _pair(np_params)
    was = obs.enabled()
    obs.enable()
    srv = GenerationServer(warm, host="127.0.0.1", port=0, models=["tiny"], quiet=True)
    srv.start()
    try:
        client = RemoteHTTPBackend(f"http://127.0.0.1:{srv.port}")
        prompts = [SYSTEM, SYSTEM + "A question?", SYSTEM + "A question? And another."]
        for prompt in prompts:
            req = GenerationRequest("tiny", prompt, 6, stop_at_eos=False)
            assert client.generate(req).tokens == cold.generate(req).tokens
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/debug/state", timeout=10) as resp:
            state = json.loads(resp.read())
    finally:
        srv.stop()
        (obs.enable if was else obs.disable)()
    assert state["models"]["prefix_cache"]["hits"] == 2
    assert state["models"]["prefix_cache"]["entries"] == {"tiny": 3}
