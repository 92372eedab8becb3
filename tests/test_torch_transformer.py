"""The port's transformer against the JAX package's on bridged weights.

``.tiny()`` configs of qwen2 (qkv bias, tied head), gemma (gemma norm,
GeGLU, MQA), phi3 (MHA, untied head) and llama3.1 (GQA) run a prefill and
then 8 decode steps in float32, with plain weights, int8 weights, and an
int8 KV cache for the decode steps. Hidden states and logits must agree
within 1e-4 (float32 math summed in another order across two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import quantize as jquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import transformer as jtf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as tquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import transformer as ttf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.cuda_attention import (
    cuda_decode_attention,
    cuda_decode_attention_int8,
    cuda_prefill_attention,
)

TOL = dict(atol=1e-4, rtol=1e-4)
MODELS = ["qwen2:1.5b", "gemma:2b", "phi3:3.8b", "llama3.1:8b"]
PROMPT, CACHE_LEN, STEPS = 12, 32, 8


def _int8_decode(q, kc, vc, lengths):
    return cuda_decode_attention_int8(q, kc["q"], kc["s"], vc["q"], vc["s"], lengths)


def test_config_copy_equals_the_jax_registry():
    for name in MODELS + ["qwen2:7b", "mistral:7b", "gemma:7b", "mixtral:8x7b"]:
        assert port_config(name).__dict__ == get_model_config(name).__dict__
        assert port_config(name).tiny().__dict__ == get_model_config(name).tiny().__dict__


@pytest.mark.parametrize("weights", ["plain", "int8"])
@pytest.mark.parametrize("model", MODELS)
def test_bridged_params_keep_names_shapes_and_dtypes(model, weights):
    cfg = get_model_config(model).tiny()
    jp = jtf.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    gen = torch.Generator().manual_seed(0)
    tp = ttf.init_params(port_config(model).tiny(), gen, torch.float32)
    if weights == "int8":
        jp = jquant.quantize_params(jp)
        tp = tquant.quantize_params(tp)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert sorted(bridged) == sorted(tp)
    for name in tp:
        a, b = bridged[name], tp[name]
        if isinstance(b, dict):
            assert {k: (v.shape, v.dtype) for k, v in a.items()} == {
                k: (v.shape, v.dtype) for k, v in b.items()
            }
        else:
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


@pytest.mark.parametrize("variant", ["plain", "int8-weights", "int8-kv"])
@pytest.mark.parametrize("model", MODELS)
def test_prefill_and_decode_match_jax(model, variant):
    cfg = get_model_config(model).tiny()
    jp = jtf.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    if variant == "int8-weights":
        jp = jquant.quantize_params(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tcfg = port_config(model).tiny()
    rng = np.random.default_rng(2)
    tokens = rng.integers(3, cfg.vocab_size, size=(1, PROMPT + STEPS)).astype(np.int32)

    shape = (cfg.n_layers, 1, cfg.n_kv_heads, CACHE_LEN, cfg.d_head)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    # the port runs twice: its plain inline path, and the kernel wrappers
    # (their plain versions on CPU tensors)
    tk2, tv2 = tk.clone(), tv.clone()

    jh, jk, jv = jtf.forward(jp, cfg, jnp.asarray(tokens[:, :PROMPT]), jnp.int32(0), jk, jv)
    th, _, _ = ttf.forward(tp, tcfg, torch.from_numpy(tokens[:, :PROMPT]).long(), 0, tk, tv)
    th2, _, _ = ttf.forward(
        tp, tcfg, torch.from_numpy(tokens[:, :PROMPT]).long(), 0, tk2, tv2,
        None, cuda_prefill_attention,
    )
    for out in (th, th2):
        np.testing.assert_allclose(out.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        ttf.logits_for(tp, tcfg, th[:, -1]).numpy(),
        np.asarray(jtf.logits_for(jp, cfg, jh[:, -1])),
        **TOL,
    )

    decode_fn = cuda_decode_attention
    if variant == "int8-kv":
        jk, jv = jquant.quantize_kv_cache(jk, jv)
        tk, tv = tquant.quantize_kv_cache(tk, tv)
        tk2, tv2 = tquant.quantize_kv_cache(tk2, tv2)
        decode_fn = _int8_decode
        np.testing.assert_array_equal(tk["q"].numpy(), np.asarray(jk["q"]))

    for i in range(STEPS):
        pos = PROMPT + i
        tok = tokens[:, pos : pos + 1]
        jh, jk, jv = jtf.forward(jp, cfg, jnp.asarray(tok), jnp.int32(pos), jk, jv)
        th, _, _ = ttf.forward(tp, tcfg, torch.from_numpy(tok).long(), pos, tk, tv)
        th2, _, _ = ttf.forward(
            tp, tcfg, torch.from_numpy(tok).long(), pos, tk2, tv2, decode_fn
        )
        jl = np.asarray(jtf.logits_for(jp, cfg, jh[:, 0]))
        for out in (th, th2):
            np.testing.assert_allclose(out.numpy(), np.asarray(jh), **TOL)
            np.testing.assert_allclose(
                ttf.logits_for(tp, tcfg, out[:, 0]).numpy(), jl, **TOL
            )


def _jax_paged_parts(q, kc, vc, lengths):
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_paged_attention as jpa

    if isinstance(kc["pool"], dict):
        return jpa.xla_paged_decode_attention_parts_int8(
            q, kc["pool"]["q"], kc["pool"]["s"], vc["pool"]["q"], vc["pool"]["s"],
            kc["table"], lengths,
        )
    return jpa.xla_paged_decode_attention_parts(q, kc["pool"], vc["pool"], kc["table"], lengths)


@pytest.mark.parametrize("kv", ["plain", "int8"])
@pytest.mark.parametrize("model", ["qwen2:1.5b", "phi3:3.8b"])
def test_stacked_paged_decode_matches_jax(model, kv):
    """Four batched decode steps over the stacked-hybrid paged leaf: a
    read-only prompt pool (shuffled pages of 8 tokens; one row with no
    prompt), side caches taking the generated tokens at each row's
    ``write_pos``, per-row RoPE positions. Hidden states, logits and the
    side caches agree with the JAX forward of the same leaf."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import (
        _paged_parts,
    )

    cfg = get_model_config(model).tiny()
    tcfg = port_config(model).tiny()
    jp = jtf.init_params(cfg, jax.random.PRNGKey(5), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(6)
    b, page, n_pool, t_gen, steps = 3, 8, 10, 8, 4
    plens = np.array([20, 0, 9], dtype=np.int32)
    table = rng.permutation(n_pool)[: b * 3].reshape(b, 3).astype(np.int32)
    shape = (cfg.n_layers, n_pool, cfg.n_kv_heads, page, cfg.d_head)
    pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    side_shape = (cfg.n_layers, b, cfg.n_kv_heads, t_gen, cfg.d_head)

    def leaves(pool, side, j):
        if j:
            return {"pool": pool, "table": jnp.asarray(table), "side": side,
                    "prompt_lens": jnp.asarray(plens)}
        return {"pool": pool, "table": torch.from_numpy(table), "side": side,
                "prompt_lens": torch.from_numpy(plens)}

    if kv == "int8":
        jpools = [dict(zip("qs", jquant.quantize_kv_vector(jnp.asarray(p)))) for p in pools]
        tpools = [{k: torch.from_numpy(np.array(v)) for k, v in p.items()} for p in jpools]
        jsides = [{"q": jnp.zeros(side_shape, jnp.int8), "s": jnp.zeros(side_shape[:-1])}] * 2
        tsides = [{"q": torch.zeros(side_shape, dtype=torch.int8),
                   "s": torch.zeros(side_shape[:-1])} for _ in range(2)]
    else:
        jpools = [jnp.asarray(p) for p in pools]
        tpools = [torch.from_numpy(p) for p in pools]
        jsides = [jnp.zeros(side_shape)] * 2
        tsides = [torch.zeros(side_shape) for _ in range(2)]
    jk, jv = (leaves(p, s, True) for p, s in zip(jpools, jsides))
    tk, tv = (leaves(p, s, False) for p, s in zip(tpools, tsides))
    tokens = rng.integers(3, cfg.vocab_size, size=(b, steps)).astype(np.int32)
    for i in range(steps):
        offs = plens + i
        for leaf, j in ((jk, True), (jv, True), (tk, False), (tv, False)):
            leaf["write_pos"] = jnp.full((b,), i, jnp.int32) if j else torch.full((b,), i)
        jh, jk, jv = jtf.forward(
            jp, cfg, jnp.asarray(tokens[:, i : i + 1]), jnp.asarray(offs), jk, jv, _jax_paged_parts
        )
        th, _, _ = ttf.forward(
            tp, tcfg, torch.from_numpy(tokens[:, i : i + 1]).long(),
            torch.from_numpy(offs).long(), tk, tv, _paged_parts,
        )
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(
            ttf.logits_for(tp, tcfg, th[:, 0]).numpy(),
            np.asarray(jtf.logits_for(jp, cfg, jh[:, 0])),
            **TOL,
        )
    # the port wrote its side caches in place; the JAX forward returned them
    for tleaf, jleaf in ((tk, jk), (tv, jv)):
        if kv == "int8":
            np.testing.assert_array_equal(tleaf["side"]["q"].numpy(), np.asarray(jleaf["side"]["q"]))
        else:
            np.testing.assert_allclose(tleaf["side"].numpy(), np.asarray(jleaf["side"]), **TOL)


@pytest.mark.parametrize(
    "leaf,s",
    [
        # the write-through leaf (pool + table only) is ported; what is not
        # is a paged decode kernel for an int8 write-through pool (the JAX
        # package has no int8 twin of B6), so the engine's dispatch raises
        (dict(int8=True), 1),
        (dict(side=True, layer=0), 1),  # the stacked-pool kernel form
        (dict(scratch=True), 2),  # the scratch (kernel-less) verify block
    ],
    ids=["write-through", "layer", "verify"],
)
def test_unported_paged_modes_raise(leaf, s):
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import (
        _paged_parts,
    )

    tcfg = port_config("qwen2:1.5b").tiny()
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), torch.float32)
    shape = (tcfg.n_layers, 4, tcfg.n_kv_heads, 8, tcfg.d_head)
    cache = {"pool": torch.zeros(shape), "table": torch.zeros((1, 1), dtype=torch.int32)}
    dispatch = lambda *a: None  # noqa: E731
    if leaf.pop("int8", False):
        cache["pool"] = {"q": torch.zeros(shape, dtype=torch.int8), "s": torch.ones(shape[:-1])}
        dispatch = _paged_parts
    if leaf.pop("side", False):
        cache.update(side=torch.zeros((tcfg.n_layers, 1, tcfg.n_kv_heads, 4, tcfg.d_head)),
                     write_pos=torch.zeros(1, dtype=torch.long),
                     prompt_lens=torch.ones(1, dtype=torch.int32))
    if leaf.pop("scratch", False):
        cache["scratch"] = torch.zeros((tcfg.n_layers, 1, tcfg.n_kv_heads, 2, tcfg.d_head))
    cache.update(leaf)
    with pytest.raises(NotImplementedError):
        ttf.forward(tp, tcfg, torch.zeros((1, s), dtype=torch.long), torch.ones(1, dtype=torch.long),
                    cache, dict(cache), dispatch)
