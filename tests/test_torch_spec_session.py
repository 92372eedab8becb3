"""The port's speculative session over the paged pool against the JAX
package's stacked-hybrid spec session, on the same (bridged) tiny weights
in float32.

The JAX engine runs ``paged_kv=True`` with a decode kernel injected, so its
session takes the stacked-hybrid layout and its verify reaches the
multi-query Pallas kernels (interpret mode on the CPU;
``PAGED_XLA_PARTS_MIN_ROWS`` raised so its XLA-gather routing stays off).
The port runs the same layout on the plain versions of B7/B8. Four rows of
1–3 prompt pages at page 128 with their own budgets; the EOS id is set to
a token that row 0's greedy stream reaches mid-way, so that row retires
on EOS. For GQA (qwen2) and MHA (phi3), with the n-gram source and a model
draft (a one-layer cut of the target), over a bf16-style and an int8 pool:
greedy tokens, ``extras["spec"]`` and page counts equal the JAX session's,
and the tokens equal the port's plain ``generate_batch``.

Sampled rows are held to the distribution (the frameworks' random streams
differ): pooled tokens of a speculating session and of the plain batch
path pass a two-sample chi-squared and TV test, as the JAX package's
``tests/test_spec_sampled.py`` holds its own. Then ``generate_speculative``,
``generate``'s routing, and the guards.
"""

import dataclasses
import warnings

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
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

MODELS = {"qwen2": "qwen2:1.5b", "phi3": "phi3:3.8b"}  # GQA, MHA
SOURCES = {"ngram": ("ngram", 3), "model": ("tiny-d", 3)}
KV = {"bf16-pool": None, "int8-pool": "int8"}
# (prompt, max_new_tokens): 1, 2, 3 and 1 prompt pages; the byte
# tokenizer adds a BOS
ROWS = [
    ("abc abc abc abc abc", 20),
    ("b" * 149 + " xyz xyz", 14),
    ("c" * 299, 9),
    ("the cat the cat the", 17),
]
# chi-squared critical value, df=15 (16 bins), alpha=0.001, and the TV
# bound of the JAX package's sampled-spec tests
CHI2_CRIT_DF15 = 37.697
TV_BOUND = 0.06


def _cfgs(name):
    jcfg = get_model_config(name).tiny(vocab_size=259, max_seq_len=1024)
    tcfg = port_config(name).tiny(vocab_size=259, max_seq_len=1024)
    return jcfg, tcfg


def init_params_np(cfg):
    return jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(7), jnp.float32))


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """(model name, target params, draft params) as numpy; the draft is
    the target cut to its first layer, so it agrees with the target on
    some proposals and not on others."""
    name = MODELS[request.param]
    params = jax.tree.map(np.asarray, init_params(_cfgs(name)[0], jax.random.PRNGKey(4), jnp.float32))
    draft = {k: v if k in ("embed", "final_norm", "lm_head") else v[:1] for k, v in params.items()}
    return name, params, draft


@pytest.fixture(scope="module")
def qwen2_model():
    """The ``model`` fixture's GQA case alone."""
    name = MODELS["qwen2"]
    params = jax.tree.map(np.asarray, init_params(_cfgs(name)[0], jax.random.PRNGKey(4), jnp.float32))
    draft = {k: v if k in ("embed", "final_norm", "lm_head") else v[:1] for k, v in params.items()}
    return name, params, draft


def _port_engine(model, **kw):
    name, params, draft = model
    _, tcfg = _cfgs(name)
    eng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", paged_kv=True, **kw)
    eng.install_model("tiny", tcfg, params_from_numpy(params, "cpu", torch.float32))
    eng.install_model(
        "tiny-d", dataclasses.replace(tcfg, n_layers=1), params_from_numpy(draft, "cpu", torch.float32)
    )
    return eng


def _jax_engine(model, **kw):
    name, params, draft = model
    jcfg, _ = _cfgs(name)
    eng = JaxEngine(
        registry={}, dtype=jnp.float32, paged_kv=True, decode_attention=pallas_decode_attention, **kw
    )
    eng.install_model("tiny", jcfg, jax.tree.map(jnp.asarray, params))
    eng.install_model("tiny-d", dataclasses.replace(jcfg, n_layers=1), jax.tree.map(jnp.asarray, draft))
    return eng


def _drain(session, limit=400):
    out = []
    for _ in range(limit):
        if not session.active:
            break
        out.extend(session.step())
    assert not session.active, "session did not drain"
    return out


def _eos_inside(tokens, start=6):
    """A token of ``tokens`` at index >= ``start`` that does not occur
    earlier in it: as the EOS id, it ends this stream there."""
    for i in range(start, len(tokens)):
        if tokens[i] not in tokens[:i]:
            return tokens[i], i
    raise AssertionError("no fresh token to serve as EOS")


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("source", list(SOURCES))
def test_spec_session_equals_jax_stacked_session(model, source, kv, monkeypatch):
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    spec = {"tiny": SOURCES[source]}
    teng = _port_engine(model, kv_quantize=KV[kv], speculative=spec)
    jeng = _jax_engine(model, kv_quantize=KV[kv], speculative=spec)
    treqs = [GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS]
    jreqs = [JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS]
    eos, at = _eos_inside(teng.generate_batch(treqs[:1])[0].tokens)
    for eng in (teng, jeng):
        eng._tokenizer_for("tiny").eos_id = eos

    ts = teng.decode_open(treqs)
    js = jeng.decode_open(jreqs)
    assert js.stacked and js.spec is not None and ts.spec is not None
    assert [len(r.pages) for r in ts.rows if r] == [len(r.pages) for r in js.rows if r] == [1, 2, 3, 1]
    assert ts.pool.n_pages == js.pool.n_pages
    assert [r["pages"] for r in ts.debug_state()["rows"]] == [r["pages"] for r in js.debug_state()["rows"]]
    free_open = ts.pool.free_pages
    assert free_open == js.pool.free_pages
    got = {id(r.request): r for r in _drain(ts)}
    want = {r.request.prompt: r for r in _drain(js)}
    assert ts.pool.free_pages == js.pool.free_pages == ts.pool.n_pages - 1  # parking only
    plain = teng.generate_batch(treqs)
    for req, p in zip(treqs, plain):
        g, w = got[id(req)], want[req.prompt]
        assert g.tokens == w.tokens == p.tokens, (source, kv, req.prompt)
        assert g.extras["spec"] == w.extras["spec"]
        assert g.extras["retire_reason"] == w.extras["retire_reason"]
        spec_x = g.extras["spec"]
        assert spec_x["source"] == ("ngram" if source == "ngram" else "model")
        assert 0 <= spec_x["accepted"] <= spec_x["drafted"] == 3 * spec_x["rounds"]
    row0 = got[id(treqs[0])]
    assert row0.extras["retire_reason"] == "eos" and len(row0.tokens) == at + 1
    ts.close()


@pytest.mark.parametrize("kv", list(KV))
def test_spec_session_at_k12_equals_jax_stacked_session(qwen2_model, kv, monkeypatch):
    """k = 12: the verify block holds 13 query positions, more than the
    multi-query kernel takes in one launch (9), so the CUDA wrappers cut it
    into chunks (``chunk_queries``). On the CPU the wrappers' plain
    versions have no cap; here they run through the same helper with a cap
    of 3 (five chunks a verify). The n-gram session's greedy tokens and
    spec counts equal the JAX stacked session's, and the plain batch's."""
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    chunks = []
    for name in ("paged_mq_attention_reference", "paged_mq_attention_int8_reference"):
        plain = getattr(cpa, name)

        def chunked(q, *rest, plain=plain):
            def run(qc, oc):
                chunks.append(qc.shape[1])
                return plain(qc, *rest[:-1], oc)

            return cpa.chunk_queries(run, q, rest[-1], 3)

        monkeypatch.setattr(cpa, name, chunked)
    spec = {"tiny": ("ngram", 12)}
    teng = _port_engine(qwen2_model, kv_quantize=KV[kv], speculative=spec)
    jeng = _jax_engine(qwen2_model, kv_quantize=KV[kv], speculative=spec)
    treqs = [GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS]
    jreqs = [JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS]
    ts = teng.decode_open(treqs)
    js = jeng.decode_open(jreqs)
    assert js.stacked and js.spec is not None and ts.spec is not None
    got = {id(r.request): r for r in _drain(ts)}
    want = {r.request.prompt: r for r in _drain(js)}
    assert chunks and set(chunks) == {3, 1} and len(chunks) % 5 == 0
    plain = teng.generate_batch(treqs)
    for req, p in zip(treqs, plain):
        g, w = got[id(req)], want[req.prompt]
        assert g.tokens == w.tokens == p.tokens, (kv, req.prompt)
        assert g.extras["spec"] == w.extras["spec"]
        assert g.extras["spec"]["drafted"] == 12 * g.extras["spec"]["rounds"]
    ts.close()


def _dist_requests(n_rows=96, n_tokens=160):
    """Sampled rows: prompts repeat a little (so the n-gram source gets
    some lookup hits), seeds differ per row (independent draws)."""
    return [
        GenerationRequest(
            "tiny", f"the probe row {i % 7} the probe row {i % 7} again", n_tokens,
            temperature=0.7, seed=1000 + i, stop_at_eos=False,
        )
        for i in range(n_rows)
    ]


def _bins16(results):
    counts = [0] * 16
    for r in results:
        for t in r.tokens:
            counts[t % 16] += 1
    return counts


def _chi2_tv(a, b):
    na, nb = sum(a), sum(b)
    ra, rb = (nb / na) ** 0.5, (na / nb) ** 0.5
    chi2 = sum((ai * ra - bi * rb) ** 2 / (ai + bi) for ai, bi in zip(a, b) if ai + bi)
    tv = 0.5 * sum(abs(ai / na - bi / nb) for ai, bi in zip(a, b))
    return chi2, tv


@pytest.mark.parametrize(
    "source,kv,draft_temperature",
    [("model", "bf16-pool", None), ("ngram", "int8-pool", None), ("model", "bf16-pool", 1.3)],
)
def test_sampled_spec_rows_match_the_plain_distribution(model, source, kv, draft_temperature):
    """At temperature 0.7 the speculating session's pooled tokens and the
    plain batch path's agree in distribution (>= 10k tokens each), also
    when the model draft proposes at its own temperature
    (``spec_draft_temperature``: q follows the proposals' chain)."""
    eng = _port_engine(
        model, kv_quantize=KV[kv], speculative={"tiny": SOURCES[source]},
        spec_draft_temperature=draft_temperature,
    )
    sess = eng.decode_open(_dist_requests())
    assert sess.spec is not None
    results = _drain(sess)
    spec_bins = _bins16(results)
    assert sum(spec_bins) >= 10_000
    assert all(r.extras["spec"]["rounds"] >= 1 for r in results)
    assert sum(r.extras["spec"]["accepted"] for r in results) > 0  # the accept lane ran
    base = _bins16(eng.generate_batch(_dist_requests()))
    chi2, tv = _chi2_tv(base, spec_bins)
    assert chi2 < CHI2_CRIT_DF15, f"{source} {kv}: chi2={chi2:.2f} tv={tv:.4f}"
    assert tv < TV_BOUND, f"{source} {kv}: tv={tv:.4f}"


def test_generate_speculative_lanes(model, monkeypatch):
    """A greedy model draft runs the solo loop (contiguous caches, rounds
    and accepted equal the JAX package's solo loop); an n-gram request
    and a sampled request drain a one-row session; greedy tokens equal
    plain decode's."""
    eng = _port_engine(model)
    jeng = _jax_engine(model)
    req = GenerationRequest("tiny", "solo spec probe abc abc", 24, stop_at_eos=False)
    plain = eng.generate(req)
    solo = eng.generate_speculative(req, "tiny-d", 3)
    jsolo = jeng.generate_speculative(JaxRequest("tiny", req.prompt, 24, stop_at_eos=False), "tiny-d", 3)
    assert solo.tokens == plain.tokens == jsolo.tokens
    for key in ("spec_rounds", "spec_accepted", "draft_model", "k"):
        assert solo.extras[key] == jsolo.extras[key], key
    assert "stepped" not in solo.extras

    ngram = eng.generate_speculative(req, k=3, source="ngram")
    assert ngram.tokens == plain.tokens
    assert ngram.extras["stepped"] and ngram.extras["spec"]["source"] == "ngram"
    assert ngram.extras["spec_rounds"] == ngram.extras["spec"]["rounds"] >= 1

    sampled = eng.generate_speculative(
        GenerationRequest("tiny", "sampled solo", 12, temperature=0.7, seed=5, stop_at_eos=False),
        "tiny-d", 3,
    )
    assert sampled.generated_tokens == 12 and sampled.extras["spec"]["source"] == "model"
    with pytest.raises(ValueError, match="repeat_penalty"):
        eng.generate_speculative(GenerationRequest("tiny", "x", 4, repeat_penalty=1.2), "tiny-d", 3)


def test_generate_routes_eligible_requests_to_speculation(model):
    eng = _port_engine(model, speculative={"tiny": ("tiny-d", 3)}, spec_temperature_max=1.0)
    plain_eng = _port_engine(model)
    req = GenerationRequest("tiny", "routed greedy row", 16, stop_at_eos=False)
    routed = eng.generate(req)
    assert routed.extras["spec"]["draft_model"] == "tiny-d"
    assert routed.tokens == plain_eng.generate(req).tokens
    sampled = eng.generate(GenerationRequest("tiny", "routed sampled", 10, temperature=0.7, seed=3))
    assert sampled.extras["spec"]["source"] == "model"
    for unrouted in (
        GenerationRequest("tiny", "too hot", 6, temperature=1.5, seed=3),
        GenerationRequest("tiny", "penalised", 6, repeat_penalty=1.2),
        GenerationRequest("tiny", "with a stop string", 6, stop=("zz",)),
    ):
        assert "spec" not in (eng.generate(unrouted).extras or {})
    ngram_eng = _port_engine(model, speculative={"tiny": ("ngram", 3)})
    assert ngram_eng.generate(req).extras["spec"]["source"] == "ngram"


def test_session_plain_branch_debug_state_and_guards(model):
    """Without a spec config a session decodes on the batch path's steps
    (the same tokens as ``generate_batch``); a draft whose vocabulary
    differs serves the session plain; a floor is taken (one of 1 or more
    raises), and a contiguous engine serves an n-gram request."""
    reqs = [GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS]
    eng = _port_engine(model)
    sess = eng.decode_open(reqs, reserve_rows=8, slice_steps=3)
    assert sess.spec is None and sess.b_bucket == 8 and sess.free_slots == 4
    assert sess.slice_bucket == 3
    assert "spec" not in sess.debug_state()
    res = {id(r.request): r for r in _drain(sess)}
    assert [res[id(r)].tokens for r in reqs] == [g.tokens for g in eng.generate_batch(reqs)]
    assert "spec" not in res[id(reqs[0])].extras

    spec_eng = _port_engine(model, speculative={"tiny": ("ngram", 3)})
    sess = spec_eng.decode_open(reqs)
    state = sess.debug_state()
    assert state["spec"]["source"] == "ngram" and state["spec"]["k"] == 3
    assert [r["pages"] for r in state["rows"]] == [1, 2, 3, 1]
    # the side caches carry the verify's k-column overshoot
    assert sess.carry["side_k"].shape[3] == sess.g_bucket + 3
    sess.step(1)
    assert sess.debug_state()["spec"]["rounds_total"] == len(reqs)
    sess.close()
    assert sess.active == 0 and sess.pool.free_pages == sess.pool.n_pages - 1

    name, params, _ = model
    _, tcfg = _cfgs(name)
    wide = _port_engine(model, speculative={"tiny": ("wide", 3)})
    wide.install_model(
        "wide", dataclasses.replace(tcfg, vocab_size=300),
        params_from_numpy(init_params_np(dataclasses.replace(_cfgs(name)[0], vocab_size=300)), "cpu", torch.float32),
    )
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess = wide.decode_open(reqs[:1])
    assert sess.spec is None and any("vocab" in str(w.message) for w in caught)
    sess.close()

    # the options item 13 once refused: an engine's floor and a session's
    # override of it, and an n-gram request on the contiguous layout
    assert _port_engine(model, spec_accept_floor=0.5).spec_accept_floor == 0.5
    sess = spec_eng.decode_open(reqs[:1], spec_accept_floor=0.5)
    assert sess.spec["floor"] == 0.5 and sess.debug_state()["spec"]["accept_floor"] == 0.5
    sess.close()
    with pytest.raises(ValueError, match="spec_accept_floor"):
        _port_engine(model, spec_accept_floor=1.0)
    contiguous = TorchEngine(
        registry={"tiny": tcfg}, dtype=torch.float32, device="cpu", speculative={"tiny": ("ngram", 3)}
    )
    res = contiguous.generate_speculative(reqs[0], k=3, source="ngram")
    assert res.extras["spec"]["source"] == "ngram" and res.extras["stepped"]
    assert res.tokens == contiguous._generate_plain(
        GenerationRequest("tiny", reqs[0].prompt, reqs[0].max_new_tokens, stop_at_eos=False)).tokens

