"""TorchEngine against JaxEngine on the same (bridged) tiny qwen2 weights.

Greedy tokens must be identical for prompts over several buckets and a
chunked prompt, in five configurations of the JAX engine: its default
jnp path, its Pallas kernels (interpret mode on the CPU), int8 weights
with an int8 KV cache, and the two int4 weight layouts (the JAX engine's
decode matmuls through its Pallas int4 kernels in interpret mode; phi3 as
well as qwen2). The port runs on the CPU, where its kernel wrappers take
their plain versions.
"""

import dataclasses

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
    pallas_prefill_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)

# vocab 259 = the byte tokenizer's, so every generated id decodes to text
JAX_CFG = get_model_config("qwen2:1.5b").tiny(vocab_size=259)
PORT_CFG = port_config("qwen2:1.5b").tiny(vocab_size=259)
CHUNK = 32  # PREFILL_CHUNK shrunk so that a 70-token prompt prefills in 3 chunks
PROMPTS = [
    ("hi", 12),  # bucket 32
    ("the quick brown fox jumps over the lazy dog, twice!", 20),  # bucket 64
    ("a" * 10 + " energy of on-device inference " * 3, 20),  # bucket 128
    ("chunked prompt " * 5 + "end", 16),  # 3 chunks of 32 with the shrunk chunk
]
CONFIGS = {
    "jnp": (dict(), dict()),
    "pallas": (
        dict(decode_attention=pallas_decode_attention, prefill_attention=pallas_prefill_attention),
        dict(),
    ),
    "int8": (dict(quantize="int8", kv_quantize="int8"), dict(quantize="int8", kv_quantize="int8")),
    "int4": (dict(quantize="int4"), dict(quantize="int4")),
    "int4-i32": (dict(quantize="int4-i32"), dict(quantize="int4-i32")),
}


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(
        np.asarray, init_params(JAX_CFG, jax.random.PRNGKey(3), jnp.float32)
    )


def _engines(np_params, config):
    jax_kw, port_kw = CONFIGS[config]
    jeng = JaxEngine(registry={}, dtype=jnp.float32, **jax_kw)
    jeng.install_model("tiny", JAX_CFG, jax.tree.map(jnp.asarray, np_params))
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **port_kw)
    teng.install_model("tiny", PORT_CFG, params_from_numpy(np_params, "cpu", torch.float32))
    return jeng, teng


def _pair(jeng, teng, prompt, n, **kw):
    j = jeng.generate(JaxRequest("tiny", prompt, n, **kw))
    t = teng.generate(GenerationRequest("tiny", prompt, n, **kw))
    return j, t


@pytest.mark.parametrize("config", list(CONFIGS))
def test_greedy_tokens_equal_jax_engine(np_params, config, monkeypatch):
    monkeypatch.setattr(jax_engine, "PREFILL_CHUNK", CHUNK)
    monkeypatch.setattr(torch_engine, "PREFILL_CHUNK", CHUNK)
    assert len(torch_engine._prompt_chunks(len(PROMPTS[-1][0]) + 1)) == 3
    jeng, teng = _engines(np_params, config)
    for prompt, n in PROMPTS:
        j, t = _pair(jeng, teng, prompt, n, stop_at_eos=False)
        assert t.tokens == j.tokens, (config, prompt)
        assert (t.text, t.prompt_tokens, t.generated_tokens) == (
            j.text, j.prompt_tokens, j.generated_tokens,
        )
        assert t.prefill_s > 0 and t.decode_s > 0


def test_stop_strings_cut_like_jax_engine(np_params):
    jeng, teng = _engines(np_params, "jnp")
    prompt = "stop strings"
    full = teng.generate(GenerationRequest("tiny", prompt, 60, stop_at_eos=False))
    assert len(full.text) > 12
    # one stop string that hits mid-output, one that never does
    stop = (full.text[8:10], "\x00never\x00")
    j, t = _pair(jeng, teng, prompt, 60, stop=stop, stop_at_eos=False)
    assert (t.tokens, t.text) == (j.tokens, j.text)
    assert t.text == full.text[: full.text.find(stop[0])]


def test_sampled_generation_is_seeded_and_sampler_knobs_run(np_params):
    _, teng = _engines(np_params, "jnp")
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, repeat_penalty=1.1, seed=5)
    a = teng.generate(GenerationRequest("tiny", "sample me", 24, stop_at_eos=False, **kw))
    b = teng.generate(GenerationRequest("tiny", "sample me", 24, stop_at_eos=False, **kw))
    greedy = teng.generate(GenerationRequest("tiny", "sample me", 24, stop_at_eos=False))
    assert a.tokens == b.tokens and len(a.tokens) == 24
    assert a.tokens != greedy.tokens


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEngine()


@pytest.mark.parametrize(
    "option",
    [
        dict(prefix_cache_size=2),
        dict(prefix_cache_bytes=1 << 20),
        dict(hf_checkpoints={"tiny": "/nonexistent"}),
        dict(weight_cache_dir="weights"),
        # the adaptive draft length and fallback of a speculating session
        dict(speculative={"tiny": ("ngram", 3)}, spec_accept_floor=0.5),
        # the shared prefix store and its knobs
        dict(prefix_share=True),
        dict(prefix_share=True, prefix_index_entries=4),
        dict(prefix_share=True, prefix_store_hbm_bytes=1 << 20),
        dict(prefix_share=True, prefix_store_host_bytes=1 << 20),
        dict(prefix_share=True, prefix_store_scope="session"),
    ],
    ids=lambda o: "-".join(o) if "prefix_share" in o else next(iter(o)),
)
def test_ported_engine_options_are_taken(option, tmp_path):
    """The prefix cache, HF checkpoints, the weight cache, a positive
    ``spec_accept_floor`` and the shared prefix store build an engine (a
    checkpoint directory is read only when its model loads)."""
    if "weight_cache_dir" in option:
        option = dict(weight_cache_dir=str(tmp_path / "weights"))
    eng = TorchEngine(device="cpu", **option)
    assert eng._prefix_enabled == ("prefix_cache_size" in option or "prefix_cache_bytes" in option)
    assert eng.hf_checkpoints == option.get("hf_checkpoints", {})
    assert (eng._weight_cache is not None) == ("weight_cache_dir" in option)
    assert eng.spec_accept_floor == option.get("spec_accept_floor", 0.0)
    store = eng.prefix_store
    assert (store is not None) == ("prefix_share" in option)
    if store is not None:
        assert store.capacity == option.get("prefix_index_entries", 16)
        assert store.hbm_bytes == option.get("prefix_store_hbm_bytes")
        assert store.host_bytes == option.get("prefix_store_host_bytes")
        assert store.scope == option.get("prefix_store_scope", "engine")


@pytest.mark.parametrize("mode", ["int4", "int4-i32"])
def test_int4_greedy_tokens_equal_jax_engine_on_phi3(mode):
    """MHA with an untied head (int8 in every mode): solo ``generate``."""
    jcfg = get_model_config("phi3:3.8b").tiny(vocab_size=259)
    np_params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(6), jnp.float32))
    jeng = JaxEngine(registry={}, dtype=jnp.float32, quantize=mode)
    jeng.install_model("tiny", jcfg, jax.tree.map(jnp.asarray, np_params))
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", quantize=mode)
    teng.install_model(
        "tiny", port_config("phi3:3.8b").tiny(vocab_size=259),
        params_from_numpy(np_params, "cpu", torch.float32),
    )
    assert set(teng._models["tiny"].params["lm_head"]) == {"q", "s"}
    for prompt, n in PROMPTS[:3]:
        j, t = _pair(jeng, teng, prompt, n, stop_at_eos=False)
        assert t.tokens == j.tokens, (mode, prompt)


@pytest.mark.parametrize(
    "quantize",
    [None, "int4", {"qwen2:1.5b": "int8", "default": "int4"}, {"phi3:3.8b": "int4-i32"},
     {"qwen2:1.5b": None, "default": "int8"}],
    ids=["none", "int4", "dict-default", "dict-no-default", "dict-none"],
)
def test_quant_mode_resolves_per_model_like_jax(quantize):
    jeng = JaxEngine(registry={}, dtype=jnp.float32, quantize=quantize)
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", quantize=quantize)
    for model in ("qwen2:1.5b", "phi3:3.8b", "llama3.1:8b"):
        assert teng._quant_mode(model) == jeng._quant_mode(model)


def test_per_model_modes_quantize_each_model_and_bad_modes_raise():
    tiny = port_config("qwen2:1.5b").tiny()
    teng = TorchEngine(
        registry={"a": tiny, "b": tiny, "c": tiny}, dtype=torch.float32, device="cpu",
        quantize={"a": "int8", "b": None, "default": "int4-i32"},
    )
    kinds = {}
    for model in ("a", "b", "c"):
        teng.load_model(model)
        wq = teng._models[model].params["wq"]
        kinds[model] = sorted(wq) if isinstance(wq, dict) else "plain"
        assert set(teng._models[model].params["embed"]) == {"q", "s"} or model == "b"
    assert kinds == {"a": ["q", "s"], "b": "plain", "c": ["q32", "s"]}
    for bad in ("int2", {"a": "fp8"}):
        with pytest.raises(ValueError, match="unsupported quantize mode"):
            TorchEngine(device="cpu", quantize=bad)
        with pytest.raises(ValueError, match="unsupported quantize mode"):
            JaxEngine(registry={}, quantize=bad)


def test_request_contract_is_the_jax_packages():
    names = [f.name for f in dataclasses.fields(GenerationRequest)]
    assert names == [f.name for f in dataclasses.fields(JaxRequest)]
