"""The port's mixture-of-experts MLP against the JAX package's, on the CPU.

Every case runs the ``.tiny()`` of ``mixtral:8x7b`` with 4 experts and
top-2 routing unless it says otherwise, on weights drawn by the JAX
package and carried over by ``models.bridge`` (numpy inputs from a seed):

- ``_moe_mlp`` of one layer against the JAX ``_moe_mlp``: f32 within
  ``atol=1e-5, rtol=2e-5``; bf16, and int8 / int4 / int4-i32 experts
  (codes carried exactly), within the tolerances the cases state;
- the forward's logits in f32 within ``1e-4`` and 16 greedy tokens equal;
  bf16 (plain and int4 weights) through teacher-forced logits;
- the framework-free cases of ``tests/test_moe.py`` on the port (one
  expert equals the dense MLP, decode equals prefill, int8 close to f32,
  the engine generates);
- the traps: a zero router chooses experts 0..k-1 as ``jax.lax.top_k``
  does; chunked dispatch equals unchunked; a dense config draws its
  weights exactly as whole-leaf draws do; the MoE init hands ``post`` one
  layer of an expert leaf at a time and never stacks a list of layers;
- quantization of ``[L, E, D, F]`` leaves, the bridge and the byte model;
  the bf16 full-width model refused before any allocation;
- the paths that run through ``run_blocks``: ``generate`` (also against
  ``JaxEngine``), ``generate_batch`` on both KV layouts (the paged one
  also against ``JaxEngine``), a stepped session with a joiner,
  speculation (n-gram and a one-layer draft cut from the target, experts
  included), the shared prefix store, a migration bundle seated on a
  second engine, and a ``GenerationServer`` over HTTP, each giving the
  port's solo greedy tokens.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import quantize as jquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import transformer as jtf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import GenerationRequest
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as tquant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import transformer as ttf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.cuda_attention import (
    cuda_decode_attention,
    cuda_prefill_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.utils import memory
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

F32_TOL = dict(atol=1e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=0)
MODES = ("int8", "int4", "int4-i32")
PROMPT, STEPS, CACHE_LEN = 12, 16, 32


def _cfgs(n_experts=4, top_k=2, **kw):
    """(JAX config, port config) of the tiny mixtral."""
    over = dict(n_experts=n_experts, top_k_experts=top_k, **kw)
    return (
        dataclasses.replace(get_model_config("mixtral:8x7b").tiny(), **over),
        dataclasses.replace(port_config("mixtral:8x7b").tiny(), **over),
    )


def _np_params(cfg, seed, dtype=jnp.float32, mode=None):
    params = jtf.init_params(cfg, jax.random.PRNGKey(seed), dtype)
    if mode is not None:
        params = jquant.quantize_params(params, mode=mode)
    return jax.tree.map(np.asarray, params)


def _layer0(params):
    return {k: jax.tree.map(lambda a: a[0], v) for k, v in params.items() if k not in ttf.NON_LAYER_LEAVES}


def _hidden(cfg, shape=(2, 5), seed=0):
    return np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)


# -- the MLP ------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["f32", "bf16", *MODES])
def test_moe_mlp_matches_jax(weights):
    """One layer's MoE MLP on the same weights and hidden states. f32 and
    the quantized experts run f32 activations (dequantized f32 operands:
    the f32 tolerance, 1e-5). bf16 rounds the products and the combine
    to 8 significant bits at other places in the two frameworks: within
    0.02 of the largest output (five steps of 2^-8)."""
    jcfg, tcfg = _cfgs()
    dtype = jnp.bfloat16 if weights == "bf16" else jnp.float32
    mode = weights if weights in MODES else None
    np_params = _np_params(jcfg, 1, dtype, mode)
    port = params_from_numpy(np_params, "cpu", torch.bfloat16 if weights == "bf16" else torch.float32)
    h = _hidden(jcfg)
    want = np.asarray(jtf._moe_mlp(jcfg, jnp.asarray(h, dtype), jax.tree.map(jnp.asarray, _layer0(np_params))),
                      np.float32)
    th = torch.from_numpy(h).to(port["final_norm"].dtype)
    got = ttf._moe_mlp(tcfg, th, ttf.split_layers(port)[0]).float().numpy()
    if mode is not None:
        key = next(k for k in np_params["w_gate"] if k != "s")
        for name in ("w_gate", "w_up", "w_down"):  # codes cross the bridge exactly
            np.testing.assert_array_equal(port[name][key].numpy(), np_params[name][key])
    if weights == "bf16":
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("router", ["zero", "pairs"])
def test_router_ties_choose_experts_as_jax_top_k(router):
    """A zero router gives every expert 1/E: JAX's top_k chooses 0..k-1,
    and so must the port (``torch.topk`` promises no order on ties).
    ``pairs`` gives experts (0, 2) and (1, 3) equal logits per token."""
    jcfg, tcfg = _cfgs(n_experts=4, top_k=3)
    np_params = _np_params(jcfg, 2)
    layer = _layer0(np_params)
    d = jcfg.d_model
    if router == "zero":
        layer["router"] = np.zeros((d, 4), np.float32)
    else:
        col = np.random.default_rng(3).standard_normal((d, 2)).astype(np.float32)
        layer["router"] = col[:, [0, 1, 0, 1]]
    h = _hidden(jcfg, (1, 6), seed=4)
    probs = jax.nn.softmax(jnp.asarray(h[0]) @ jnp.asarray(layer["router"]), axis=-1)
    want_w, want_i = jax.lax.top_k(probs, 3)
    got_w, got_i = ttf.moe_route(tcfg, torch.from_numpy(h[0]), torch.from_numpy(layer["router"]))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w / want_w.sum(-1, keepdims=True)), **F32_TOL)
    if router == "zero":
        assert (got_i.numpy() == [0, 1, 2]).all()
    want = np.asarray(jtf._moe_mlp(jcfg, jnp.asarray(h), jax.tree.map(jnp.asarray, layer)))
    tl = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    np.testing.assert_allclose(ttf._moe_mlp(tcfg, torch.from_numpy(h), tl).numpy(), want, **F32_TOL)


def test_chunked_dispatch_equals_unchunked(monkeypatch):
    """Each token's output depends on that token alone: chunks of 2, 4
    and 7 of 14 tokens equal one chunk bit for bit at f32. A chunk of one
    token is held to 1e-6 instead: the CPU's BLAS runs a one-row product
    as a matrix-vector product, which sums in another order."""
    _, tcfg = _cfgs()
    layer = ttf.split_layers(params_from_numpy(_np_params(_cfgs()[0], 5)))[0]
    h = torch.from_numpy(_hidden(tcfg, (2, 7), seed=6))
    token_bytes = tcfg.n_experts * tcfg.d_ff * 4  # one token's [E, F] f32

    def chunked(tokens):
        monkeypatch.setattr(ttf, "MOE_CHUNK_BYTES", tokens * token_bytes)
        return ttf._moe_mlp(tcfg, h, layer)

    whole = ttf._moe_mlp(tcfg, h, layer)  # the default chunk holds all 14
    assert torch.equal(chunked(14), whole)
    for tokens in (2, 4, 7):
        assert torch.equal(chunked(tokens), whole), tokens
    np.testing.assert_allclose(chunked(1).numpy(), whole.numpy(), atol=1e-6, rtol=0)
    # the default chunk at mixtral's full width keeps [E, T, F] within 1 GiB
    monkeypatch.undo()
    full = port_config("mixtral:8x7b")
    chunk = ttf.MOE_CHUNK_BYTES // (full.n_experts * full.d_ff * 2)
    assert chunk == 4681 and chunk * full.n_experts * full.d_ff * 2 <= 1 << 30


# -- the forward --------------------------------------------------------------


def test_forward_logits_and_greedy_tokens_match_jax():
    """f32: a 12-token prefill, then 16 greedy decode steps on each side
    (the port's through its kernel wrappers, their plain versions here):
    the 16 tokens equal, and the logits of every step within 1e-4."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, 3)
    jp, tp = jax.tree.map(jnp.asarray, np_params), params_from_numpy(np_params)
    tokens = np.random.default_rng(7).integers(3, jcfg.vocab_size, size=(1, PROMPT)).astype(np.int32)
    shape = (jcfg.n_layers, 1, jcfg.n_kv_heads, CACHE_LEN, jcfg.d_head)
    jc = [jnp.zeros(shape), jnp.zeros(shape)]
    tc = [torch.zeros(shape), torch.zeros(shape)]
    jh, *jc = jtf.forward(jp, jcfg, jnp.asarray(tokens), jnp.int32(0), *jc)
    th, _, _ = ttf.forward(tp, tcfg, torch.from_numpy(tokens).long(), 0, *tc, None, cuda_prefill_attention)
    jl = np.asarray(jtf.logits_for(jp, jcfg, jh[:, -1]))
    tl = ttf.logits_for(tp, tcfg, th[:, -1]).numpy()
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)

    def jstep(tok, pos):
        nonlocal jc
        h, *jc = jtf.forward(jp, jcfg, jnp.asarray([[tok]], jnp.int32), jnp.int32(pos), *jc)
        return np.asarray(jtf.logits_for(jp, jcfg, h[:, 0]))

    def tstep(tok, pos):
        h, _, _ = ttf.forward(tp, tcfg, torch.tensor([[tok]]), pos, *tc, cuda_decode_attention)
        return ttf.logits_for(tp, tcfg, h[:, 0]).numpy()

    def greedy(step, logits):
        out, seen = [], []
        for i in range(STEPS):
            out.append(int(np.argmax(logits)))
            logits = step(out[-1], PROMPT + i)
            seen.append(logits)
        return out, np.stack(seen)

    want, want_logits = greedy(jstep, jl)
    got, got_logits = greedy(tstep, tl)
    assert got == want
    np.testing.assert_allclose(got_logits, want_logits, **LOGIT_TOL)


# The smallest gap between the k-th and the (k+1)-th router probability
# below which a bf16 step counts as a routing near-tie: the two
# frameworks' bf16 hidden states differ by an ulp (2^-8 of a value) here
# and there, which moves a router logit of unit spread, and so a
# probability, by up to about 2^-8: enough to swap two experts that close
# in one framework and not in the other.
NEAR_TIE = 2**-8


@pytest.mark.parametrize("mode", [None, "int4"])
def test_bf16_forward_tracks_jax(mode, monkeypatch):
    """bf16 weights and activations (int4 attention and expert leaves
    too): a 12-token prefill and 8 teacher-forced decode steps. The greedy
    token agrees at every step; the logits agree within 0.02 of the
    largest one (as ``test_bf16_int4_forward_tracks_jax``) at every step
    whose routing has no near-tie (NEAR_TIE, read from the port's router
    on every token of every layer). A near-tie step may send a token to
    another expert in each framework, and is held to its greedy token
    alone; at most two of the nine steps may be such. At int4 the
    forwards' wq/wk/wv/wo take the int4 kernel route (its plain version
    here) on both sides, and the expert leaves dequantize."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, 1, jnp.bfloat16, mode)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, "cpu", torch.bfloat16)
    gaps = []
    route = ttf.moe_route

    def spy(cfg, x, router):
        top = torch.topk(torch.softmax(x.float() @ router.float(), dim=-1), cfg.top_k_experts + 1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))
        return route(cfg, x, router)

    monkeypatch.setattr(ttf, "moe_route", spy)
    tokens = np.random.default_rng(2).integers(3, jcfg.vocab_size, size=(1, 20)).astype(np.int32)
    shape = (jcfg.n_layers, 1, jcfg.n_kv_heads, CACHE_LEN, jcfg.d_head)
    jk = jv = jnp.zeros(shape, jnp.bfloat16)
    tk, tv = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16)
    near_ties = 0
    for start, end in [(0, 12)] + [(p, p + 1) for p in range(12, 20)]:
        tok = tokens[:, start:end]
        gaps.clear()
        jh, jk, jv = jtf.forward(jp, jcfg, jnp.asarray(tok), jnp.int32(start), jk, jv)
        th, _, _ = ttf.forward(tp, tcfg, torch.from_numpy(tok).long(), start, tk, tv)
        want = np.asarray(jtf.logits_for(jp, jcfg, jh[:, -1]))
        got = ttf.logits_for(tp, tcfg, th[:, -1]).numpy()
        assert got.argmax() == want.argmax(), (start, end)
        assert len(gaps) == jcfg.n_layers
        if min(gaps) < NEAR_TIE:
            near_ties += 1
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
    assert near_ties <= 2, near_ties


def test_int4_expert_leaves_never_reach_the_int4_kernel(monkeypatch):
    """At int4 a forward of at most 8 rows sends the 2-D attention leaves
    to B9's wrapper (4 calls a layer) and dequantizes the 3-D expert
    leaves."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    _, tcfg = _cfgs(d_model=256, n_heads=2, n_kv_heads=1, d_head=128)
    gen = torch.Generator().manual_seed(0)
    params = ttf.init_params(tcfg, gen, torch.float32, post=lambda n, x: tquant.quantize_leaf(n, x, "int4"))
    assert params["w_gate"]["q4"].shape == (2, 4, 128, 128)
    shapes = []
    real = cuda_quant.cuda_int4_matmul

    def spy(x, q4, s):
        shapes.append(tuple(q4.shape))
        return real(x, q4, s)

    monkeypatch.setattr(tquant, "cuda_int4_matmul", spy)
    shape = (tcfg.n_layers, 1, tcfg.n_kv_heads, 16, tcfg.d_head)
    k, v = torch.zeros(shape), torch.zeros(shape)
    ttf.forward(params, tcfg, torch.tensor([[5, 6, 7]]), 0, k, v)  # M 3 <= 8 routes too
    ttf.forward(params, tcfg, torch.tensor([[8]]), 3, k, v, cuda_decode_attention)
    assert len(shapes) == 2 * 4 * tcfg.n_layers and all(len(s) == 2 for s in shapes), shapes


# -- tests/test_moe.py's framework-free cases on the port ----------------------


def _run(cfg, params, tokens):
    b, s = tokens.shape
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.d_head)
    hidden, _, _ = ttf.forward(params, cfg, tokens, 0, torch.zeros(shape), torch.zeros(shape))
    return ttf.logits_for(params, cfg, hidden)


def _tokens(cfg, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape))


def test_single_expert_moe_equals_dense():
    _, moe_cfg = _cfgs(n_experts=1, top_k=1)
    dense_cfg = dataclasses.replace(moe_cfg, n_experts=0)
    dense = ttf.init_params(dense_cfg, torch.Generator().manual_seed(3), torch.float32)
    moe = dict(dense)
    for name in ("w_gate", "w_up", "w_down"):
        moe[name] = dense[name][:, None]
    moe["router"] = torch.zeros((moe_cfg.n_layers, moe_cfg.d_model, 1))
    tokens = _tokens(moe_cfg, (2, 7), 0)
    np.testing.assert_allclose(_run(moe_cfg, moe, tokens).numpy(), _run(dense_cfg, dense, tokens).numpy(),
                               rtol=2e-5, atol=1e-5)


def test_moe_decode_step_matches_prefill_logits():
    _, cfg = _cfgs()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    tokens = _tokens(cfg, (1, 8), 1)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 8, cfg.d_head)
    full, _, _ = ttf.forward(params, cfg, tokens, 0, torch.zeros(shape), torch.zeros(shape))
    want = ttf.logits_for(params, cfg, full[:, -1])
    k, v = torch.zeros(shape), torch.zeros(shape)
    ttf.forward(params, cfg, tokens[:, :7], 0, k, v)
    dec, _, _ = ttf.forward(params, cfg, tokens[:, 7:8], 7, k, v)
    np.testing.assert_allclose(ttf.logits_for(params, cfg, dec[:, -1]).numpy(), want.numpy(),
                               rtol=2e-5, atol=1e-5)


def test_moe_quantized_forward_close_to_fp():
    _, cfg = _cfgs()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(4), torch.float32)
    tokens = _tokens(cfg, (1, 6), 5)
    fp = _run(cfg, params, tokens).numpy()
    q = _run(cfg, tquant.quantize_params(params), tokens).numpy()
    assert np.max(np.abs(fp - q)) < 0.35
    assert np.argmax(fp[:, -1]) == np.argmax(q[:, -1])


def test_moe_engine_generates():
    _, cfg = _cfgs()
    engine = TorchEngine(registry={cfg.name: cfg}, dtype=torch.float32, device="cpu")
    result = engine.generate(GenerationRequest(cfg.name, "energy study", max_new_tokens=5))
    assert 1 <= result.generated_tokens <= 5
    assert result.decode_s >= 0


# -- init, quantization, bridge, byte model ------------------------------------


def _whole_leaf_init(cfg, gen, dtype):
    """The draws of a dense config, each leaf whole, in leaf order."""
    d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def mat(shape, fan_in):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) / fan_in**0.5).to(dtype)

    out = {"embed": (torch.randn((cfg.vocab_size, d), generator=gen, dtype=torch.float32) * 0.02).to(dtype)}
    out["wq"] = mat((l, d, hq * dh), d)
    out["wk"] = mat((l, d, hkv * dh), d)
    out["wv"] = mat((l, d, hkv * dh), d)
    out["wo"] = mat((l, hq * dh, d), hq * dh)
    out["w_gate"] = mat((l, d, f), d)
    out["w_up"] = mat((l, d, f), d)
    out["w_down"] = mat((l, f, d), f)
    if not cfg.tie_embeddings:
        out["lm_head"] = mat((d, cfg.vocab_size), d)
    return out


@pytest.mark.parametrize("model", ["qwen2:1.5b", "phi3:3.8b"])
def test_dense_init_draws_each_leaf_whole(model):
    cfg = port_config(model).tiny()
    got = ttf.init_params(cfg, torch.Generator().manual_seed(9), torch.bfloat16)
    want = _whole_leaf_init(cfg, torch.Generator().manual_seed(9), torch.bfloat16)
    for name, leaf in want.items():
        assert torch.equal(got[name], leaf), name


def test_moe_init_hands_post_one_layer_at_a_time(monkeypatch):
    """``post`` sees each expert leaf as L draws of [E, in, out], in the
    documented order, and quantizing through it never stacks a list of
    layers (``torch.stack`` is not called); the result equals the same
    draws made by hand and quantized whole."""
    _, cfg = _cfgs()
    e, d, f, l = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    seen = []

    def post(name, leaf):
        seen.append((name, tuple(leaf.shape)))
        return tquant.quantize_leaf(name, leaf, "int8")

    def no_stack(*a, **k):
        raise AssertionError("torch.stack of a list of layers")

    monkeypatch.setattr(torch, "stack", no_stack)
    got = ttf.init_params(cfg, torch.Generator().manual_seed(2), torch.float32, post=post)
    monkeypatch.undo()
    experts = [(n, s) for n, s in seen if n in ("w_gate", "w_up", "w_down")]
    assert experts == [("w_gate", (e, d, f))] * l + [("w_up", (e, d, f))] * l + [("w_down", (e, f, d))] * l
    assert all(len(s) <= 3 for _, s in seen) and ("router", (l, d, e)) in seen
    assert [n for n, _ in seen].index("router") > [n for n, _ in seen].index("final_norm")

    gen = torch.Generator().manual_seed(2)

    def mat(shape, fan_in):
        return torch.randn(shape, generator=gen, dtype=torch.float32) / fan_in**0.5

    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    want = {"embed": torch.randn((cfg.vocab_size, d), generator=gen) * 0.02}
    for name, shape, fan in (("wq", (l, d, hq * dh), d), ("wk", (l, d, hkv * dh), d),
                             ("wv", (l, d, hkv * dh), d), ("wo", (l, hq * dh, d), hq * dh)):
        want[name] = mat(shape, fan)
    for name, shape, fan in (("w_gate", (e, d, f), d), ("w_up", (e, d, f), d), ("w_down", (e, f, d), f)):
        want[name] = torch.stack([mat(shape, fan) for _ in range(l)])
    want["router"] = mat((l, d, e), d)
    want["lm_head"] = mat((d, cfg.vocab_size), d)
    want = tquant.quantize_params(want)
    for name, leaf in want.items():
        for k, t in (leaf.items() if isinstance(leaf, dict) else [("", leaf)]):
            g = got[name][k] if k else got[name]
            assert torch.equal(g, t), (name, k)


@pytest.mark.parametrize("mode", MODES)
def test_expert_leaf_quantization_equals_jax(mode):
    """``quantize_leaf`` of an [L, E, D, F] leaf (one layer, then one
    expert, at a time) equals the JAX package's quantizer on the whole
    leaf: codes and [L, E, 1, F] scales bit for bit."""
    jcfg, _ = _cfgs()
    w = np.random.default_rng(8).standard_normal((2, 4, 64, 48)).astype(np.float32)
    jfn = {"int8": jquant.quantize_tensor, "int4": jquant.quantize_tensor_int4,
           "int4-i32": jquant.quantize_tensor_int4_i32}[mode]
    want = jax.tree.map(np.asarray, jfn(jnp.asarray(w)))
    got = tquant.quantize_leaf("w_gate", torch.from_numpy(w), mode)
    assert set(got) == set(want) and got["s"].shape == (2, 4, 1, 48)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("mode", [None, *MODES])
def test_bridge_nbytes_and_byte_model_of_an_moe(mode):
    """The bridge carries the 4-D expert leaves and the router as they
    are (names, shapes, dtypes of the port's own init at that mode);
    ``params_nbytes`` counts every leaf, the router's included, as the
    JAX package's does; ``estimate_weight_bytes`` agrees within 2% (it
    bills the router, which stays full-precision, at the weight width)."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(jcfg, 0, jnp.float32, mode)
    bridged = params_from_numpy(np_params)
    post = None if mode is None else (lambda n, x: tquant.quantize_leaf(n, x, mode))
    own = ttf.init_params(tcfg, torch.Generator().manual_seed(0), torch.float32, post=post)
    assert sorted(bridged) == sorted(own)
    for name, leaf in own.items():
        b = bridged[name]
        if isinstance(leaf, dict):
            assert {k: (t.shape, t.dtype) for k, t in b.items()} == {k: (t.shape, t.dtype) for k, t in leaf.items()}
        else:
            assert (b.shape, b.dtype) == (leaf.shape, leaf.dtype)
            np.testing.assert_array_equal(b.numpy(), np.asarray(np_params[name], np.float32))
    assert bridged["router"].shape == (tcfg.n_layers, tcfg.d_model, tcfg.n_experts)
    nbytes = tquant.params_nbytes(own)
    assert nbytes == jquant.params_nbytes(np_params)
    router = own["router"].numel() * 4
    assert nbytes - router == tquant.params_nbytes({k: v for k, v in own.items() if k != "router"})
    est = memory.estimate_weight_bytes(tcfg, mode, dtype_bytes=4)
    assert abs(est - nbytes) <= 0.02 * nbytes, (est, nbytes)


def test_full_width_bf16_refused_before_allocation_and_int8_fits(monkeypatch):
    """On an 80 GB card's budget the bf16 model (93.4 GB) is refused with
    the quantize hint before anything is drawn; int8 (46.7 GB) plus the
    LRU guard's 14 GiB of load headroom fits."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine

    card = 80 * 1024**3
    monkeypatch.setenv(memory.ENV_OVERRIDE, str(card))
    monkeypatch.setattr(torch_engine, "init_params", lambda *a, **k: pytest.fail("allocated"))
    engine = TorchEngine(device="cpu")
    with pytest.raises(memory.ModelMemoryError, match="quantize"):
        engine.load_model("mixtral:8x7b")
    cfg = port_config("mixtral:8x7b")
    assert memory.estimate_weight_bytes(cfg, None) == pytest.approx(93.4e9, rel=2e-3)
    int8 = memory.estimate_weight_bytes(cfg, "int8")
    assert int8 == pytest.approx(46.7e9, rel=2e-3)
    assert int8 + memory.LOAD_TRANSIENT_HEADROOM_BYTES < card
    TorchEngine(device="cpu", quantize="int8")._check_memory_budget("mixtral:8x7b", cfg)


# -- the paths through run_blocks ----------------------------------------------

NAME = "tiny"
REQUESTS = [
    ("m" * 40 + " mixture of experts", 14),
    ("route each token to two experts", 10),
    ("x" * 70 + " energy", 12),
]


@pytest.fixture(scope="module")
def moe_np():
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, vocab_size=259, max_seq_len=512)
    tcfg = dataclasses.replace(tcfg, vocab_size=259, max_seq_len=512)
    return jcfg, tcfg, _np_params(jcfg, 11)


def _port(moe_np, **kw):
    _, tcfg, np_params = moe_np
    eng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    eng.install_model(NAME, tcfg, params_from_numpy(np_params))
    return eng


def _reqs(cls=GenerationRequest):
    return [cls(NAME, p, n, stop_at_eos=False) for p, n in REQUESTS]


@pytest.fixture(scope="module")
def solo(moe_np):
    eng = _port(moe_np)
    return [eng.generate(r).tokens for r in _reqs()]


def _drain(session, limit=200):
    out = []
    for _ in range(limit):
        if not session.active:
            break
        out.extend(session.step())
    assert not session.active
    return {r.request.prompt: r.tokens for r in out}


def test_solo_generate_equals_jax_engine(moe_np, solo):
    jcfg, _, np_params = moe_np
    jeng = JaxEngine(registry={}, dtype=jnp.float32)
    jeng.install_model(NAME, jcfg, jax.tree.map(jnp.asarray, np_params))
    assert [jeng.generate(r).tokens for r in _reqs(JaxRequest)] == solo


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_generate_batch_equals_solo(moe_np, solo, paged):
    got = [r.tokens for r in _port(moe_np, paged_kv=paged).generate_batch(_reqs())]
    assert got == solo
    if paged:
        jcfg, _, np_params = moe_np
        jeng = JaxEngine(registry={}, dtype=jnp.float32, paged_kv=True)
        jeng.install_model(NAME, jcfg, jax.tree.map(jnp.asarray, np_params))
        assert [r.tokens for r in jeng.generate_batch(_reqs(JaxRequest))] == solo


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_stepped_session_with_a_joiner_equals_solo(moe_np, solo, paged):
    reqs = _reqs()  # the joiner is the shortest: the contiguous cache is sized at open
    sess = _port(moe_np, paged_kv=paged).decode_open([reqs[0], reqs[2]], reserve_rows=3)
    sess.step(3)
    sess.join(reqs[1])
    got = _drain(sess)
    sess.close()
    assert [got[r.prompt] for r in reqs] == solo


@pytest.mark.parametrize("source", ["ngram", "draft"])
def test_speculative_session_equals_solo(moe_np, solo, source):
    """Greedy speculation gives the plain greedy tokens: an n-gram draft,
    and a draft model cut from the target to its first layer (its expert
    leaves and router included)."""
    _, tcfg, np_params = moe_np
    spec = ("ngram", 3) if source == "ngram" else ("tiny-d", 3)
    eng = _port(moe_np, paged_kv=True, speculative={NAME: spec})
    if source == "draft":
        draft = {k: v if k in ttf.NON_LAYER_LEAVES else v[:1] for k, v in np_params.items()}
        assert draft["w_gate"].shape[:2] == (1, tcfg.n_experts) and draft["router"].shape[0] == 1
        eng.install_model("tiny-d", dataclasses.replace(tcfg, n_layers=1), params_from_numpy(draft))
    sess = eng.decode_open(_reqs())
    got = _drain(sess)
    sess.close()
    assert [got[r.prompt] for r in _reqs()] == solo


def test_prefix_store_sharer_equals_solo(moe_np):
    """A joiner sharing the anchor's published page maps it from the
    store and decodes the plain engine's tokens."""
    shared = "s" * 140
    anchor = GenerationRequest(NAME, shared + " anchor", 12, stop_at_eos=False)
    joiner = GenerationRequest(NAME, shared + " joiner tail", 10, stop_at_eos=False)
    eng = _port(moe_np, paged_kv=True, prefix_share=True)
    sess = eng.decode_open([anchor], reserve_rows=2)
    sess.step(2)
    pending = sess.join_begin(joiner)
    assert pending.hit_tokens >= 128 and pending.shared_pages
    while not sess.join_step(pending):
        pass
    sess.join_commit(pending)
    got = _drain(sess)
    sess.close()
    plain = _port(moe_np, paged_kv=True)
    assert got[joiner.prompt] == plain.generate(joiner).tokens
    assert got[anchor.prompt] == plain.generate(anchor).tokens


def test_migration_bundle_seats_on_another_engine(moe_np, solo):
    """A row preempted mid-decode is exported as a JSON bundle, seated in
    a second engine's session and finishes with the solo tokens."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.migrate import (
        export_bundle,
        import_bundle,
    )

    reqs = _reqs()
    src = _port(moe_np, paged_kv=True)
    sess = src.decode_open(reqs[:2], reserve_rows=2)
    sess.step(4)
    pr = sess.preempt(reqs[1], policy="swap")
    bundle = json.loads(json.dumps(export_bundle(pr, reason="drain")))
    sess.resume_discard(pr)
    sess.close()
    dst = _port(moe_np, paged_kv=True)
    d_sess = dst.decode_open([reqs[0]], reserve_rows=2)
    seated = import_bundle(bundle)
    pending = d_sess.resume_begin(seated)
    while not d_sess.join_step(pending):
        pass
    d_sess.join_commit(pending)
    got = _drain(d_sess)
    d_sess.close()
    assert got[reqs[1].prompt] == solo[1] and got[reqs[0].prompt] == solo[0]


def test_server_answers_with_the_solo_tokens(moe_np, solo):
    """``GenerationServer`` (the continuous scheduler) over
    ``TorchEngine(device="cpu")`` serving the tiny mixtral over HTTP."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.client import RemoteHTTPBackend
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.serve.server import GenerationServer

    server = GenerationServer(_port(moe_np), host="127.0.0.1", port=0, models=[NAME], quiet=True,
                              scheduler="continuous")
    server.start()
    try:
        client = RemoteHTTPBackend(f"http://127.0.0.1:{server.port}")
        assert [client.generate(r).tokens for r in _reqs()] == solo
    finally:
        server.stop()


# -- expert parallelism ----------------------------------------------------------


def _ep_tp_params(mode):
    """tests/test_moe.py::test_ep_tp_sharded_forward_matches_unsharded's
    model (4 experts, d_ff 128, seed 1) and tokens, and the JAX
    package's logits of its tp 2 × ep 4 GSPMD-sharded forward."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import mesh as jmesh
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu.parallel import sharding as jsharding

    jcfg, tcfg = _cfgs(d_ff=128)
    params = jtf.Transformer.initialise(jcfg, seed=1, dtype=jnp.float32).params
    if mode is not None:
        params = jquant.quantize_params(params, mode=mode)
    tokens = jax.random.randint(jax.random.PRNGKey(2), (2, 6), 0, jcfg.vocab_size)
    jmesh_ = jmesh.build_mesh(jmesh.MeshSpec.tp_ep(2, 4), jax.devices())
    sharded = jsharding.shard_model(params, jcfg, jmesh_)

    def run(p):
        shape = (jcfg.n_layers, 2, jcfg.n_kv_heads, 6, jcfg.d_head)
        hidden, _, _ = jtf.forward(p, jcfg, tokens, jnp.int32(0), jnp.zeros(shape), jnp.zeros(shape), None)
        return jtf.logits_for(p, jcfg, hidden)

    want = np.asarray(jax.jit(run)(sharded))
    return tcfg, jax.tree.map(np.asarray, params), np.asarray(tokens), want


@pytest.mark.parametrize("mode", [None, "int8"])
def test_ep_tp_sharded_forward_matches_unsharded(mode):
    """tp 2 × ep 4 over 8 CPU shards: each shard runs 1 of the 4 experts
    at F/2 columns, the combine adds up over ep and tp, and the logits
    equal the JAX package's sharded forward's and the port's unsharded
    forward's within the JAX case's tolerance (2e-4)."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.sharding import param_specs, shard_model
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.tp import (
        ShardedParams,
        ShardedTransformer,
    )

    tcfg, np_params, tokens, want = _ep_tp_params(mode)
    params = params_from_numpy(np_params)
    mesh = build_mesh(MeshSpec.tp_ep(2, 4), ["cpu"] * 8)
    assert param_specs(tcfg, mesh)["w_gate"] == (None, "ep", None, "tp")
    trees = shard_model(params, tcfg, mesh)
    w_down = trees.mlp[(0, 1, 3)]["w_down"]  # [L, E/ep, F/tp, D]: 1 expert, 64 of 128 rows
    assert tuple((tquant.codes(w_down) if mode else w_down).shape[1:]) == (1, 64, 64)
    sharded = ShardedTransformer(cfg=tcfg, params=ShardedParams(trees, mesh))
    tok = torch.tensor(tokens, dtype=torch.long)

    def logits(p, cache):
        hidden, _, _ = ttf.forward(p, tcfg, tok, 0, *cache)
        return ttf.logits_for(p, tcfg, hidden).numpy()

    shape = (tcfg.n_layers, 2, tcfg.n_kv_heads, 6, tcfg.d_head)
    base = logits(params, (torch.zeros(shape), torch.zeros(shape)))
    got = logits(sharded.params, sharded.init_cache(2, 6, torch.float32))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, base, rtol=2e-4, atol=2e-4)


def test_ep_tp_engine_generates_the_unsharded_tokens(moe_np, solo):
    """The sharded engine over tp 2 × ep 4: solo, batched and a stepped
    session give the unsharded engine's greedy tokens."""
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.parallel.tp import TensorParallelEngine

    _, tcfg, np_params = moe_np
    eng = TensorParallelEngine(
        mesh=build_mesh(MeshSpec.tp_ep(2, 4), ["cpu"] * 8), registry={}, dtype=torch.float32, paged_kv=True,
    )
    eng.install_model(NAME, tcfg, params_from_numpy(np_params))
    assert [eng.generate(r).tokens for r in _reqs()] == solo
    assert [r.tokens for r in eng.generate_batch(_reqs())] == solo
    reqs = _reqs()
    sess = eng.decode_open([reqs[0], reqs[2]], reserve_rows=3)
    sess.step(3)
    sess.join(reqs[1])
    got = _drain(sess)
    sess.close()
    assert [got[r.prompt] for r in reqs] == solo
