"""The port's contiguous speculating session (the JAX package's "legacy"
verify) against the JAX package's, on the same (bridged) tiny weights in
float32.

- One verify forward: ``forward`` over a ``[B, k+1]`` block at per-row
  offsets on a contiguous batch cache (bf16-style and int8) equals the
  JAX ``forward``'s carry-cache branch (its per-row causal mask), hidden
  states and the written cache columns, to 1e-5 (the tolerance of
  ``tests/test_torch_speculative.py``); the engine's callable runs the
  plain version of the multi-query kernel over contiguous rows, which is
  also held against the paged plain version on a table that lays each
  row out in order.
- A session of three rows with a mid-flight joiner, for the model and
  the n-gram source on bf16 and int8 KV: greedy tokens and
  ``extras["spec"]`` equal the JAX contiguous session's, and the tokens
  the port's plain decode.
- A speculating row preempted (swap, recompute) and resumed: both rows'
  tokens equal the JAX session's under the same calls, and plain decode's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import transformer as jtf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.quantize import (
    quantize_kv_cache as jax_quantize_kv_cache,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import (
    TorchEngine,
    _contiguous_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import quantize_kv_cache
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import (
    forward,
    split_layers,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import attention as port_attn
from test_torch_runner import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
SOURCES = {"ngram": ("ngram", 3), "model": ("tiny-d", 3)}
KV = {"bf16-cache": None, "int8-cache": "int8"}
ROWS = [
    ("abc abc abc abc abc", 20),
    ("b" * 140 + " xyz xyz", 14),
    ("the cat the cat the", 17),
]
JOINER = ("a late joiner joins", 12)


def _cfgs(name="qwen2:1.5b"):
    return (
        get_model_config(name).tiny(vocab_size=259, max_seq_len=1024),
        port_config(name).tiny(vocab_size=259, max_seq_len=1024),
    )


@pytest.fixture(scope="module")
def weights():
    """Target params and a one-layer draft cut from them, as numpy."""
    params = jax.tree.map(np.asarray, jtf.init_params(_cfgs()[0], jax.random.PRNGKey(4), jnp.float32))
    draft = {k: v if k in ("embed", "final_norm", "lm_head") else v[:1] for k, v in params.items()}
    return params, draft


def _engines(weights, **kw):
    params, draft = weights
    jcfg, tcfg = _cfgs()
    jeng = JaxEngine(registry={}, dtype=jnp.float32, **kw)
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    for name, p, jc, tc in (
        ("tiny", params, jcfg, tcfg),
        ("tiny-d", draft, dataclasses.replace(jcfg, n_layers=1), dataclasses.replace(tcfg, n_layers=1)),
    ):
        jeng.install_model(name, jc, jax.tree.map(jnp.asarray, p))
        teng.install_model(name, tc, params_from_numpy(p, "cpu", torch.float32))
    return jeng, teng


def _drain(session, limit=400):
    out = []
    for _ in range(limit):
        if not session.active:
            break
        out.extend(session.step(4))
    assert not session.active, "session did not drain"
    return {r.request.prompt: r for r in out}


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("name", ["qwen2:1.5b", "phi3:3.8b"])
def test_verify_forward_equals_the_jax_carry_branch(name, kv):
    jcfg, tcfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    tparams = params_from_numpy(params, "cpu", torch.float32)
    rng = np.random.default_rng(5)
    b, t, s = 4, 64, 4  # k = 3
    shape = (tcfg.n_layers, b, tcfg.n_kv_heads, t, tcfg.d_head)
    k0, v0 = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    offs = np.array([0, 7, 33, t - s], dtype=np.int32)
    tokens = rng.integers(0, 259, (b, s))
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    if kv:
        jk, jv = jax_quantize_kv_cache(jk, jv)
        tk, tv = quantize_kv_cache(tk, tv)
    jh, jk2, jv2 = jtf.forward(params, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(offs), jk, jv)
    th, _, _ = forward(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(offs).long(), tk, tv,
        _contiguous_attention, layers=split_layers(tparams),
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)

    def dense(c):
        if isinstance(c, dict):
            return np.asarray(c["q"], np.float32) * np.asarray(c["s"], np.float32)[..., None]
        return np.asarray(c)

    for got, want in ((tk, jk2), (tv, jv2)):
        got = dense({key: x.numpy() for key, x in got.items()} if isinstance(got, dict) else got.numpy())
        np.testing.assert_allclose(got, dense(want), atol=5e-2 if kv else 1e-5, rtol=1e-5)


def test_contiguous_plain_version_is_the_paged_one_normalised():
    """Each row's cache laid out in pages of 16 read through an in-order
    table: the contiguous plain version equals the paged multi-query plain
    version's ``acc / l``, bf16-style and int8, at Q 1 to 5."""
    gen = torch.Generator().manual_seed(3)
    b, hq, hkv, t, d, page = 3, 12, 2, 64, 128, 16
    k = torch.randn((b, hkv, t, d), generator=gen)
    v = torch.randn((b, hkv, t, d), generator=gen)
    table = torch.arange(b * t // page, dtype=torch.int32).reshape(b, t // page)

    def pool(x):  # [B,Hkv,T,...] -> [B·T/page, Hkv, page, ...]
        x = x.reshape(b, hkv, t // page, page, *x.shape[3:]).transpose(1, 2)
        return x.reshape(b * t // page, hkv, page, *x.shape[4:]).contiguous()

    for q_len in range(1, 6):
        q = torch.randn((b, q_len, hq, d), generator=gen)
        offsets = torch.tensor([0, 20, t - q_len], dtype=torch.int32)
        lengths = offsets + q_len
        got = port_attn.contiguous_mq_attention_reference(q, k, v, lengths, offsets)
        parts = port_attn.paged_mq_attention_reference(q, pool(k), pool(v), table, lengths, offsets)
        torch.testing.assert_close(got, port_attn._normalised(parts, q), **TOL)
        kq, ks = quantize_kv_cache(k, v)
        got8 = port_attn.contiguous_mq_attention_int8_reference(
            q, kq["q"], kq["s"], ks["q"], ks["s"], lengths, offsets
        )
        parts8 = port_attn.paged_mq_attention_int8_reference(
            q, pool(kq["q"]), pool(kq["s"]), pool(ks["q"]), pool(ks["s"]), table, lengths, offsets
        )
        torch.testing.assert_close(got8, port_attn._normalised(parts8, q), **TOL)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("source", list(SOURCES))
def test_contiguous_session_with_a_joiner_equals_jax(weights, source, kv):
    jeng, teng = _engines(weights, kv_quantize=KV[kv], speculative={"tiny": SOURCES[source]})
    sessions = []
    for eng, make in ((jeng, JaxRequest), (teng, GenerationRequest)):
        sess = eng.decode_open([make("tiny", p, n, stop_at_eos=False) for p, n in ROWS], reserve_rows=4)
        assert sess.spec is not None and not sess.paged
        early = {r.request.prompt: r for r in sess.step(4)}
        joiner = make("tiny", *JOINER, stop_at_eos=False)
        assert sess.can_join(joiner)
        sess.join(joiner)
        sessions.append((sess, early))
    (js, j_early), (ts, t_early) = sessions
    assert ts.cache_len == js.cache_len and ts.spec_draft_len == js.spec_draft_len
    assert ts.debug_state()["spec"]["verify_mode"] == "legacy"
    want, got = {**j_early, **_drain(js)}, {**t_early, **_drain(ts)}
    assert set(got) == set(want) == {p for p, _ in ROWS + [JOINER]}
    for prompt, n in ROWS + [JOINER]:
        plain = teng._generate_plain(GenerationRequest("tiny", prompt, n, stop_at_eos=False))
        assert got[prompt].tokens == want[prompt].tokens == plain.tokens, (source, kv, prompt)
        assert got[prompt].extras["spec"] == {
            key: (int(x) if isinstance(x, (int, np.integer)) else x)
            for key, x in want[prompt].extras["spec"].items()
        }
    assert got[JOINER[0]].extras["spec"]["rounds"] >= 1
    ts.close()


@pytest.mark.parametrize(
    "source,kv,policy",
    [("model", "bf16-cache", "swap"), ("model", "int8-cache", "recompute"),
     ("ngram", "int8-cache", "swap"), ("ngram", "bf16-cache", "recompute")],
)
def test_preempted_speculating_row_resumes_as_in_jax(weights, source, kv, policy):
    jeng, teng = _engines(weights, kv_quantize=KV[kv], speculative={"tiny": SOURCES[source]})
    anchor = ("the anchor keeps the session warm", 40)
    victim = ("victim vvv www vvv www", 32)
    runs = []
    for eng, make in ((jeng, JaxRequest), (teng, GenerationRequest)):
        reqs = [make("tiny", p, n, stop_at_eos=False) for p, n in (anchor, victim)]
        sess = eng.decode_open(reqs, reserve_rows=4)
        sess.step(3)
        pr = sess.preempt(reqs[1], policy=policy)
        assert pr is not None
        assert (pr.draft_blob is not None) == (source == "model" and policy == "swap")
        sess.step(3)
        assert sess.can_resume(pr)
        pending = sess.resume_begin(pr, 64)
        while not sess.join_step(pending):
            pass
        sess.join_commit(pending)
        runs.append(_drain(sess))
        sess.close()
    want, got = runs
    for prompt, n in (anchor, victim):
        plain = teng._generate_plain(GenerationRequest("tiny", prompt, n, stop_at_eos=False))
        assert got[prompt].tokens == want[prompt].tokens == plain.tokens, (source, kv, policy, prompt)
        assert got[prompt].extras["spec"]["source"] == source
