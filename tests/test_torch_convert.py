"""HF checkpoints on the port, on the CPU: the conversion and the engine's
``hf_checkpoints`` route, held against the JAX package.

The cases of ``tests/test_convert.py`` and ``tests/test_tokenizer.py:84``
on the port: for each study family and mixtral (top-2 of 4 experts), an
HF model built from its config with ``transformers`` is written with
``save_pretrained`` (a ``model.safetensors``; sharded too, with its
index), and

- the port's ``load_hf_pretrained`` of the directory and its
  ``convert_hf_state_dict`` of the state dict both equal the JAX
  conversion (through ``params_from_numpy``) bit for bit at f32, and at
  bf16 equal the JAX bf16 conversion;
- the port's logits on the converted weights match HF's (the JAX file's
  tolerance);
- phi3's fused projections split to the unfused shapes, a missing key
  names the model and the key, every registry model maps to an HF config;
- ``TorchEngine(hf_checkpoints=...)`` serves the checkpoint with the JAX
  engine's greedy tokens; at int8 its leaves equal the same converted
  params quantized on the install path, bit for bit; with the
  checkpoint's tokenizer files it tokenizes with that tokenizer;
- ``serve --hf model=/dir`` reaches the engine."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine as te
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import convert as jax_convert
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    MODEL_REGISTRY as JAX_REGISTRY,
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import convert
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    MODEL_REGISTRY,
    get_model_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import quantize_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import (
    forward,
    logits_for,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.runner import cli

transformers = pytest.importorskip("transformers")

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16, d_ff=96,
            max_seq_len=128)
# (registry name, overrides): test_convert.py's families
FAMILIES = {
    "llama3.1": ("llama3.1:8b", {}),
    "mistral": ("mistral:7b", {}),
    "qwen2": ("qwen2:1.5b", {}),  # qkv bias, tied embeddings
    "gemma": ("gemma:2b", dict(n_kv_heads=1)),  # (1 + w) norm, embed scaling
    "phi3": ("phi3:3.8b", dict(n_kv_heads=4)),  # fused qkv_proj / gate_up_proj
    "mixtral": ("mixtral:8x7b", dict(n_experts=4)),  # MixtralForCausalLM
}


def tiny_cfgs(family):
    name, extra = FAMILIES[family]
    over = {**TINY, **extra}
    return (dataclasses.replace(get_model_config(name), **over),
            dataclasses.replace(jax_config(name), **over))


def hf_model_for(cfg, seed=0):
    torch.manual_seed(seed)
    model = transformers.AutoModelForCausalLM.from_config(
        convert.hf_config_for(cfg), attn_implementation="eager"
    )
    return model.eval()


def _assert_equal_trees(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], dict):
            _assert_equal_trees(got[name], want[name])
            continue
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def _jax_params(model, jcfg, dtype):
    return jax_convert.convert_hf_state_dict(model.state_dict(), jcfg, dtype=dtype)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_conversion_equals_jax_bit_for_bit(family, tmp_path):
    cfg, jcfg = tiny_cfgs(family)
    model = hf_model_for(cfg)
    model.save_pretrained(tmp_path)
    assert (tmp_path / "model.safetensors").exists()
    want = params_from_numpy({k: np.asarray(v) for k, v in _jax_params(model, jcfg, jnp.float32).items()})
    _assert_equal_trees(convert.load_hf_pretrained(tmp_path, cfg, dtype=torch.float32), want)
    _assert_equal_trees(convert.convert_hf_state_dict(model.state_dict(), cfg, dtype=torch.float32), want)
    assert ("lm_head" in want) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("family", ["qwen2", "phi3"])
def test_bf16_conversion_equals_jax(family, tmp_path):
    cfg, jcfg = tiny_cfgs(family)
    model = hf_model_for(cfg, seed=1)
    model.save_pretrained(tmp_path)
    want = params_from_numpy({k: np.asarray(v) for k, v in _jax_params(model, jcfg, jnp.bfloat16).items()},
                             dtype=torch.bfloat16)
    _assert_equal_trees(convert.load_hf_pretrained(tmp_path, cfg, dtype=torch.bfloat16), want)


def test_sharded_checkpoint_reads_through_its_index(tmp_path):
    cfg, jcfg = tiny_cfgs("mistral")
    model = hf_model_for(cfg, seed=2)
    model.save_pretrained(tmp_path, max_shard_size="40KB")
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) > 1
    want = params_from_numpy({k: np.asarray(v) for k, v in _jax_params(model, jcfg, jnp.float32).items()})
    _assert_equal_trees(convert.load_hf_pretrained(tmp_path, cfg, dtype=torch.float32), want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_hf(family):
    cfg, _ = tiny_cfgs(family)
    model = hf_model_for(cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, size=(2, 9)))
    with torch.no_grad():
        hf_logits = model(tokens).logits.numpy()
    params = convert.convert_hf_state_dict(model.state_dict(), cfg, dtype=torch.float32)
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, 16, cfg.d_head)
    hidden, _, _ = forward(params, cfg, tokens, 0, torch.zeros(shape), torch.zeros(shape))
    ours = logits_for(params, cfg, hidden).numpy()
    np.testing.assert_allclose(ours, hf_logits, atol=2e-3, rtol=2e-4)


def test_phi3_fused_split_matches_unfused_shapes():
    cfg, _ = tiny_cfgs("phi3")
    sd = hf_model_for(cfg).state_dict()
    assert "model.layers.0.self_attn.qkv_proj.weight" in sd
    params = convert.convert_hf_state_dict(sd, cfg)
    assert params["wq"].shape == params["wk"].shape == (2, 64, 64)
    assert params["w_gate"].shape == params["w_up"].shape == (2, 64, 96)
    assert params["wq"].dtype == torch.bfloat16


def test_missing_key_reports_model_and_key(tmp_path):
    cfg, _ = tiny_cfgs("llama3.1")
    with pytest.raises(KeyError, match="embed_tokens"):
        convert.convert_hf_state_dict({}, cfg)
    with pytest.raises(FileNotFoundError, match="safetensors"):
        convert.load_hf_pretrained(tmp_path, cfg)


def test_registry_configs_all_map_to_hf():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    for name, cfg in MODEL_REGISTRY.items():
        hf_cfg = convert.hf_config_for(cfg)
        assert hf_cfg.to_dict() == jax_convert.hf_config_for(JAX_REGISTRY[name]).to_dict()
        assert hf_cfg.hidden_size == cfg.d_model and hf_cfg.num_attention_heads == cfg.n_heads
        assert getattr(hf_cfg, "head_dim", cfg.d_head) == cfg.d_head
    assert convert.family_of(MODEL_REGISTRY["llama3.1:8b"]) == jax_convert.family_of(JAX_REGISTRY["llama3.1:8b"])


# -- the engine's hf_checkpoints route -------------------------------------------
@pytest.mark.parametrize("family", ["mistral", "qwen2"])
def test_engine_serves_the_checkpoint_with_the_jax_engines_tokens(family, tmp_path):
    cfg, jcfg = tiny_cfgs(family)
    model = hf_model_for(cfg, seed=3)
    model.save_pretrained(tmp_path)
    port = TorchEngine(registry={cfg.name: cfg}, dtype=torch.float32, device="cpu",
                       hf_checkpoints={cfg.name: str(tmp_path)})
    jx = JaxEngine(registry={jcfg.name: jcfg}, dtype=jnp.float32, hf_checkpoints={jcfg.name: str(tmp_path)})
    for prompt in ("hello", "a longer prompt for the checkpoint"):
        got = port.generate(GenerationRequest(cfg.name, prompt, 8, stop_at_eos=False))
        want = jx.generate(JaxRequest(jcfg.name, prompt, 8, stop_at_eos=False))
        assert got.tokens == want.tokens, prompt
    expected = convert.convert_hf_state_dict(model.state_dict(), cfg, dtype=torch.float32)
    assert torch.equal(port._models[cfg.name].params["embed"], expected["embed"])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_checkpoint_equals_the_install_path(mode, tmp_path):
    cfg, _ = tiny_cfgs("qwen2")
    model = hf_model_for(cfg, seed=4)
    model.save_pretrained(tmp_path)
    eng = TorchEngine(registry={cfg.name: cfg}, device="cpu", quantize=mode,
                      hf_checkpoints={cfg.name: str(tmp_path)})
    eng.load_model(cfg.name)
    installed = TorchEngine(registry={}, device="cpu", quantize=mode)
    installed.install_model(cfg.name, cfg, convert.convert_hf_state_dict(model.state_dict(), cfg))
    _assert_equal_trees(eng._models[cfg.name].params, installed._models[cfg.name].params)
    req = GenerationRequest(cfg.name, "checkpoint at " + mode, 8, stop_at_eos=False)
    assert eng.generate(req).tokens == installed.generate(req).tokens


VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "[UNK]": 3, "hello": 4, "world": 5, "energy": 6, "tpu": 7}


def test_engine_uses_checkpoint_tokenizer(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab=VOCAB, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
        "pad_token": "<pad>",
    }))
    cfg = dataclasses.replace(get_model_config("mistral:7b").tiny(), vocab_size=len(VOCAB))
    jcfg = dataclasses.replace(jax_config("mistral:7b").tiny(), vocab_size=len(VOCAB))
    hf_model_for(cfg, seed=5).save_pretrained(tmp_path)
    port = TorchEngine(registry={cfg.name: cfg}, dtype=torch.float32, device="cpu",
                       hf_checkpoints={cfg.name: str(tmp_path)})
    tok = port._tokenizer_for(cfg.name)
    assert type(tok).__name__ == "HFTokenizer"
    result = port.generate(GenerationRequest(cfg.name, "hello world energy", max_new_tokens=4))
    assert result.prompt_tokens == 4  # BOS + 3 known words
    assert all(0 <= t < len(VOCAB) for t in result.tokens)
    assert result.text == tok.decode(result.tokens)
    jx = JaxEngine(registry={jcfg.name: jcfg}, dtype=jnp.float32, hf_checkpoints={jcfg.name: str(tmp_path)})
    assert result.tokens == jx.generate(JaxRequest(jcfg.name, "hello world energy", max_new_tokens=4)).tokens


def test_a_checkpoint_without_tokenizer_files_tokenizes_bytes(tmp_path):
    cfg, _ = tiny_cfgs("qwen2")
    hf_model_for(cfg).save_pretrained(tmp_path)
    eng = TorchEngine(registry={cfg.name: cfg}, device="cpu", hf_checkpoints={cfg.name: str(tmp_path)})
    assert type(eng._tokenizer_for(cfg.name)).__name__ == "ByteTokenizer"


@pytest.mark.parametrize("args, want", [
    (["--hf", "m=/ckpt/m"], {"m": "/ckpt/m"}),
    (["--hf", "a=/x", "--hf", "b:7b=/y/z"], {"a": "/x", "b:7b": "/y/z"}),
])
def test_serve_hf_reaches_the_engine(args, want, monkeypatch, capsys):
    seen = {}

    def fake_engine(**kwargs):
        seen.update(kwargs)
        raise RuntimeError("engine built")

    monkeypatch.setattr(te, "TorchEngine", fake_engine)
    assert cli.main(["serve", "--port", "0", *args]) == 2
    assert "engine built" in capsys.readouterr().out
    assert seen["hf_checkpoints"] == want


def test_serve_hf_needs_model_equals_path(capsys):
    assert cli.main(["serve", "--port", "0", "--hf", "no-path"]) == 2
    assert "model=/path/to/dir" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["qwen2", "llama3.1"])
def test_chip_smokes_checkpoint_writer_round_trips(family, tmp_path):
    """``chip_smoke.py`` writes its full-width checkpoint from seeded
    params under HF's names (``hf_state_dict``, the inverse of the
    conversion): the port reads the params back bit for bit, and HF's own
    model takes every tensor by name (a tied model leaves out only
    ``lm_head.weight``)."""
    import chip_smoke
    from safetensors.torch import load_file

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.checkpoint import save_params
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import init_params

    cfg, _ = tiny_cfgs(family)
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    save_params(chip_smoke.hf_state_dict(params, cfg), tmp_path / "model.safetensors")
    _assert_equal_trees(convert.load_hf_pretrained(tmp_path, cfg, dtype=torch.bfloat16), params)
    model = hf_model_for(cfg)
    missing, unexpected = model.load_state_dict(load_file(str(tmp_path / "model.safetensors")), strict=False)
    assert not unexpected
    assert set(missing) == ({"lm_head.weight"} if cfg.tie_embeddings else set())
