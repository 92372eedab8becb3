"""The port's weight checkpoints and on-disk weight cache, on the CPU.

The cases of ``tests/test_aux.py:25-172`` on the port
(``engine/checkpoint.py``, the safetensors layout written and read by the
port's own code): a params round trip restores every leaf with its dtype
and bits (f32, bf16, int8 ``{"q", "s"}``, int4 ``{"q4", "s"}`` and
int4-i32 ``{"q32", "s"}`` leaves), ``like=`` restores to a tree's dtypes,
the weight cache builds once, an engine serves the cached weights (at
int8 too, with the tokens of the first build), and the cache is keyed by
config, dtype, quant mode and checkpoint source. The files interchange
with the ``safetensors`` package both ways where it imports. The JAX
package's engine on the same bridged weights gives the same tokens as the
port restored from its cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine as te
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import (
    get_model_config as jax_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import (
    init_params as jax_init_params,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.checkpoint import (
    SafetensorsFile,
    WeightCache,
    load_params,
    save_params,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import quantize_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import init_params


def _params(dtype=torch.float32, mode=None, seed=3):
    cfg = get_model_config("qwen2:1.5b").tiny()
    params = init_params(cfg, torch.Generator().manual_seed(seed), dtype)
    return quantize_params(params, mode=mode) if mode else params


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        if isinstance(leaf, dict):
            _assert_same(got[name], leaf)
        else:
            assert got[name].dtype == leaf.dtype and got[name].shape == leaf.shape, name
            assert torch.equal(got[name].view(torch.uint8) if leaf.dtype == torch.bfloat16 else got[name],
                               leaf.view(torch.uint8) if leaf.dtype == torch.bfloat16 else leaf), name


@pytest.mark.parametrize("dtype, mode", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, "int8"),
    (torch.bfloat16, "int4"), (torch.bfloat16, "int4-i32"),
])
def test_params_checkpoint_round_trip(tmp_path, dtype, mode):
    params = _params(dtype, mode)
    path = save_params(params, tmp_path / "ckpt.safetensors")
    _assert_same(load_params(path), params)


def test_load_params_like_restores_dtypes(tmp_path):
    params = _params(torch.float32)
    path = save_params(params, tmp_path / "ckpt.safetensors")
    like = {k: v.to(torch.bfloat16) for k, v in params.items()}
    restored = load_params(path, like=like)
    assert all(restored[k].dtype == torch.bfloat16 for k in params)
    assert torch.equal(restored["wq"], params["wq"].to(torch.bfloat16))


def test_weight_cache_initialises_once(tmp_path):
    calls = []

    def init_fn():
        calls.append(1)
        return _params()

    cache = WeightCache(tmp_path)
    p1 = cache.get_or_init("qwen2:1.5b", 0, init_fn)
    p2 = cache.get_or_init("qwen2:1.5b", 0, init_fn)
    assert len(calls) == 1  # the second call restored from disk
    _assert_same(p2, p1)
    assert cache.path_for("qwen2:1.5b", 0).name == "qwen2_1.5b-seed0.safetensors"
    assert cache.path_for("a/b:c", 1, "f00").name == "a_b_c-seed1-f00.safetensors"


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_uses_weight_cache(tmp_path, quantize, monkeypatch):
    registry = {"t": get_model_config("qwen2:1.5b").tiny()}
    req = GenerationRequest("t", "cached weights", 8, stop_at_eos=False)
    eng1 = TorchEngine(registry=registry, dtype=torch.float32, device="cpu", quantize=quantize,
                       weight_cache_dir=str(tmp_path))
    r1 = eng1.generate(req)
    assert len(list(tmp_path.glob("*.safetensors"))) == 1
    monkeypatch.setattr(te, "init_params", lambda *a, **k: pytest.fail("the cache missed"))
    eng2 = TorchEngine(registry=registry, dtype=torch.float32, device="cpu", quantize=quantize,
                       weight_cache_dir=str(tmp_path))
    r2 = eng2.generate(req)
    assert r1.tokens == r2.tokens  # identical weights from the cache
    _assert_same(eng2._models["t"].params, eng1._models["t"].params)


def test_weight_cache_keyed_by_config_dtype_and_mode(tmp_path):
    tiny = get_model_config("qwen2:1.5b").tiny()
    smaller = get_model_config("qwen2:1.5b").tiny(vocab_size=256)
    TorchEngine(registry={"m": tiny}, dtype=torch.float32, device="cpu",
                weight_cache_dir=str(tmp_path)).load_model("m")
    e2 = TorchEngine(registry={"m": smaller}, dtype=torch.float32, device="cpu",
                     weight_cache_dir=str(tmp_path))
    e2.load_model("m")  # another config: a fresh init, not the cached one
    assert e2._models["m"].params["embed"].shape[0] == 256
    e3 = TorchEngine(registry={"m": tiny}, dtype=torch.bfloat16, device="cpu", weight_cache_dir=str(tmp_path))
    e3.load_model("m")
    assert e3._models["m"].params["wq"].dtype == torch.bfloat16
    e4 = TorchEngine(registry={"m": tiny}, dtype=torch.float32, device="cpu", quantize="int8",
                     weight_cache_dir=str(tmp_path))
    e4.load_model("m")
    assert set(e4._models["m"].params["wq"]) == {"q", "s"}
    assert len(list(tmp_path.glob("*.safetensors"))) == 4


def test_weight_cache_keys_a_checkpoint_by_its_contents(tmp_path):
    transformers = pytest.importorskip("transformers")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.convert import hf_config_for

    cfg = get_model_config("qwen2:1.5b").tiny()
    ckpt = tmp_path / "ckpt"
    torch.manual_seed(0)
    transformers.AutoModelForCausalLM.from_config(hf_config_for(cfg)).save_pretrained(ckpt)
    cache = tmp_path / "cache"

    def load():
        eng = TorchEngine(registry={"m": cfg}, dtype=torch.float32, device="cpu",
                          hf_checkpoints={"m": str(ckpt)}, weight_cache_dir=str(cache))
        eng.load_model("m")
        return eng._models["m"].params

    first = load()
    assert len(list(cache.glob("*.safetensors"))) == 1
    _assert_same(load(), first)
    assert len(list(cache.glob("*.safetensors"))) == 1  # a hit
    torch.manual_seed(1)
    transformers.AutoModelForCausalLM.from_config(hf_config_for(cfg)).save_pretrained(ckpt)
    again = load()  # new contents at the same path: a miss
    assert len(list(cache.glob("*.safetensors"))) == 2
    assert not torch.equal(again["wq"], first["wq"])


def test_cached_weights_give_the_jax_engines_tokens(tmp_path):
    """Bridged JAX weights through the port's cache: restored from disk,
    the port's greedy tokens are the JAX engine's."""
    jcfg = jax_config("qwen2:1.5b").tiny(vocab_size=259)
    np_params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    cache = WeightCache(tmp_path)
    cache.get_or_init("tiny", 0, lambda: params_from_numpy(np_params))
    restored = cache.get_or_init("tiny", 0, lambda: pytest.fail("the cache missed"))
    port = TorchEngine(registry={}, dtype=torch.float32, device="cpu")
    port.install_model("tiny", get_model_config("qwen2:1.5b").tiny(vocab_size=259), restored)
    jx = JaxEngine(registry={}, dtype=jnp.float32)
    jx.install_model("tiny", jcfg, jax.tree.map(jnp.asarray, np_params))
    for prompt in ("weights from disk", "a second prompt"):
        got = port.generate(GenerationRequest("tiny", prompt, 10, stop_at_eos=False))
        assert got.tokens == jx.generate(JaxRequest("tiny", prompt, 10, stop_at_eos=False)).tokens


def test_files_interchange_with_the_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    params = _params(torch.bfloat16, "int8")
    ours = save_params(params, tmp_path / "ours.safetensors")
    theirs = st.load_file(str(ours))
    flat = {f"{k}.{sub}" if isinstance(v, dict) else k: (t if isinstance(v, dict) else v)
            for k, v in params.items() for sub, t in (v.items() if isinstance(v, dict) else [(None, v)])}
    assert sorted(theirs) == sorted(flat)
    for name, t in flat.items():
        assert theirs[name].dtype == t.dtype and torch.equal(theirs[name], t), name
    st.save_file({k: t.contiguous() for k, t in flat.items()}, str(tmp_path / "theirs.safetensors"))
    _assert_same(load_params(tmp_path / "theirs.safetensors"), params)
    f = SafetensorsFile(tmp_path / "theirs.safetensors")
    assert set(f.keys()) == set(flat)


def test_odd_leaves_round_trip(tmp_path):
    tree = {"scalar": torch.tensor(2.5), "empty": torch.empty(0, 3), "flags": torch.tensor([True, False]),
            "i64": torch.arange(5), "nested": {"a": {"b": torch.ones(2, dtype=torch.float16)}}}
    path = save_params(tree, tmp_path / "odd.safetensors")
    _assert_same(load_params(path), tree)
