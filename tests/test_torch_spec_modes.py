"""The rest of the port's speculation against the JAX package, on the
same (bridged) tiny weights in float32.

- The port's paged session (always stacked-hybrid) gives the tokens and
  spec counts of the JAX package's kernel-less scratch session, which
  the port does not have.
- The port's draft-fit rules: a draft cache that would pass the draft's
  ``max_seq_len`` (paged), or a contiguous cache whose rounds' margin
  would pass the target's, serves the session plain, with the tokens of
  the port's plain path.
- The adaptive policy: under ``spec_accept_floor=0.95`` a weak draft's
  session steps k 3 -> 1 and falls back, as the JAX session does on the
  same calls (the k of every slice, the extras), with plain greedy
  tokens; ``llm_spec_k_adapt_total`` and ``llm_spec_fallback_total`` move
  and the ``spec_k_adapt``/``spec_fallback`` events are recorded. Fed
  the same counter deltas, the port's and the JAX session's policies
  move k down, up and to the fallback on the same slices.
- The per-source memory blocks, decays and clears as the JAX engine's
  ``_spec_source_blocked`` does, and gates the session's arming.
- ``extras["spec"]["draft_wasted_J"]`` is present, and positive, exactly
  for the ``cross`` rows that had a fully rejected round, priced by the
  fleet's ``spec_draft_jpt`` hook.
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
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.energy import WASTED_J
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.flight import FLIGHT
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.obs.metrics import REGISTRY
from test_torch_runner import one_torch_thread  # noqa: F401

COUNTERS = ("rounds", "accepted", "drafted", "rejected")


def _cfgs(max_seq_len=1024):
    return (
        get_model_config("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=max_seq_len),
        port_config("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=max_seq_len),
    )


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray, jtf.init_params(_cfgs()[0], jax.random.PRNGKey(4), jnp.float32))
    draft = {k: v if k in ("embed", "final_norm", "lm_head") else v[:1] for k, v in params.items()}
    return params, draft


def _engines(weights, max_seq_len=1024, **kw):
    params, draft = weights
    jcfg, tcfg = _cfgs(max_seq_len)
    jeng = JaxEngine(registry={}, dtype=jnp.float32, **kw)
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", **kw)
    for name, p, jc, tc in (
        ("tiny", params, jcfg, tcfg),
        ("tiny-d", draft, dataclasses.replace(jcfg, n_layers=1), dataclasses.replace(tcfg, n_layers=1)),
    ):
        jeng.install_model(name, jc, jax.tree.map(jnp.asarray, p))
        teng.install_model(name, tc, params_from_numpy(p, "cpu", torch.float32))
    return jeng, teng


def _drain(session, n=4, limit=400):
    out, ks = [], []
    for _ in range(limit):
        if not session.active:
            break
        out.extend(session.step(n))
        ks.append(session.spec["k"] if session.spec is not None else None)
    assert not session.active, "session did not drain"
    return {r.request.prompt: r for r in out}, ks


@pytest.mark.parametrize("source,kv", [("model", None), ("ngram", "int8")])
def test_stacked_session_gives_the_jax_scratch_sessions_tokens(weights, source, kv):
    spec = {"tiny": ("ngram", 3) if source == "ngram" else ("tiny-d", 3)}
    jeng, teng = _engines(weights, paged_kv=True, kv_quantize=kv, speculative=spec)
    rows = [("mode agreement probe abc abc", 20), ("a second row", 9)]
    js = jeng.decode_open([JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in rows])
    ts = teng.decode_open([GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in rows])
    assert not js.stacked and "scratch_k" in js.carry  # the JAX kernel-less mode
    assert ts.stacked and "scratch_k" not in ts.carry
    want, _ = _drain(js)
    got, _ = _drain(ts)
    for prompt, _ in rows:
        assert got[prompt].tokens == want[prompt].tokens, (source, kv, prompt)
        assert {k: got[prompt].extras["spec"][k] for k in COUNTERS} == {
            k: int(want[prompt].extras["spec"][k]) for k in COUNTERS
        }


@pytest.mark.parametrize(
    "paged,spec",
    [(True, ("tiny-d", 3)), (False, ("ngram", 3))],
    ids=["paged-draft-cache", "contiguous-margin"],
)
def test_a_speculation_that_cannot_fit_serves_plain(weights, paged, spec):
    """max_seq_len 256 and a 128-token budget: a model draft's cache
    (prompt allocation + 128 + the 128-slot margin) passes the draft's
    max_seq_len, and a contiguous session's rows with that margin pass
    the target's; either way the session serves plain, with the port's
    plain path's tokens, however many that is."""
    _, teng = _engines(weights, max_seq_len=256, paged_kv=paged, speculative={"tiny": spec})
    req = GenerationRequest("tiny", "big budget", max_new_tokens=128, stop_at_eos=False)
    sess = teng.decode_open([req])
    assert sess.spec is None and sess.spec_info is None and sess.spec_margin == 0
    assert sess.paged == paged and "spec" not in sess.debug_state()
    got, _ = _drain(sess)
    plain = teng._generate_plain(GenerationRequest("tiny", "big budget", 128, stop_at_eos=False))
    assert got["big budget"].tokens == plain.tokens
    assert got["big budget"].generated_tokens == len(plain.tokens)
    assert "spec" not in got["big budget"].extras
    assert teng.live_sessions("tiny-d") == 0


def _metric(name, *labels):
    return sum(
        v for key, v in REGISTRY.snapshot().get(name, {}).items()
        if set(labels) <= set(key.split(","))
    )


def test_the_adaptive_policy_shrinks_k_and_falls_back_as_in_jax(weights):
    jeng, teng = _engines(weights, speculative={"tiny": ("tiny-d", 3)}, spec_accept_floor=0.95)
    prompt = "long fallback run"
    down0 = _metric("llm_spec_k_adapt_total", "direction=down", "source=model")
    falls0 = _metric("llm_spec_fallback_total", "source=model")
    n_events = len(FLIGHT.events(type_="spec_fallback"))
    runs = []
    for eng, make in ((jeng, JaxRequest), (teng, GenerationRequest)):
        sess = eng.decode_open([make("tiny", prompt, 120, stop_at_eos=False)])
        assert sess.spec["k"] == 3 and sess.spec["k0"] == 3 and sess.spec["floor"] == 0.95
        got, ks = _drain(sess)
        assert sess.spec is None and sess.spec_fallback
        assert sess.debug_state()["spec"]["fallback"] is True
        assert not any(key in sess.carry for key in ("draft_k", "spec_rounds"))
        runs.append((got[prompt], ks))
        sess.close()
    (want, want_ks), (res, ks) = runs
    assert ks == want_ks and ks[0] == 3 and 1 in ks and ks[-1] is None, ks  # 3 -> 1 -> fallback
    assert res.tokens == want.tokens == teng._generate_plain(
        GenerationRequest("tiny", prompt, 120, stop_at_eos=False)).tokens
    assert res.extras["spec"] == {
        k: (int(v) if isinstance(v, (int, np.integer)) and not isinstance(v, bool) else v)
        for k, v in want.extras["spec"].items()
    }
    assert res.extras["spec"]["fallback"] is True and res.extras["spec"]["k"] == 1
    assert _metric("llm_spec_k_adapt_total", "direction=down", "source=model") == down0 + 1
    assert _metric("llm_spec_fallback_total", "source=model") == falls0 + 1
    assert len(FLIGHT.events(type_="spec_fallback")) == n_events + 1
    assert FLIGHT.events(type_="spec_k_adapt")[-1]["k_to"] == 1
    # the source's memory holds the fallback's acceptance, on both engines
    assert len(teng._spec_source_health["model:tiny-d"]) == len(jeng._spec_source_health["model:tiny-d"]) == 1


def test_the_policy_moves_k_as_the_jax_policy_on_the_same_deltas(weights):
    """Counter deltas fed to both sessions' ``_spec_after_slice``: a
    window of 2 slices judges; 2/16 under the floor 0.5 halves k 4 -> 2,
    a full-acceptance window doubles it back (>= 0.65), then three empty
    windows take it 4 -> 2 -> 1 -> fallback."""
    jeng, teng = _engines(weights, speculative={"tiny": ("ngram", 4)}, spec_accept_floor=0.5)
    rows = [("row one", 64), ("row two", 64)]
    js = jeng.decode_open([JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in rows])
    ts = teng.decode_open([GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in rows])
    b = ts.b_bucket
    total = {key: [0] * b for key in COUNTERS}
    trajectory = []
    for accepted_per_row in (1, 1, None, None, 0, 0, 0, 0, 0, 0):
        k = ts.spec["k"]
        for r in range(len(rows)):
            total["rounds"][r] += 1
            total["drafted"][r] += k
            total["accepted"][r] += k if accepted_per_row is None else accepted_per_row
        for key in COUNTERS:
            ts.carry["spec_" + key][:] = torch.tensor(total[key])
            js.carry["spec_" + key] = jnp.asarray(total[key], jnp.int32)
        assert ts._spec_after_slice([0, 1]) == js._spec_after_slice([0, 1]) == 1
        trajectory.append((ts.spec["k"] if ts.spec else None, js.spec["k"] if js.spec else None))
        assert ts.debug_state()["spec"]["acceptance_recent"] == js.debug_state()["spec"]["acceptance_recent"]
        if ts.spec is None:
            break
    assert trajectory == [(4, 4), (2, 2), (2, 2), (4, 4), (4, 4), (2, 2), (2, 2), (1, 1), (1, 1),
                          (None, None)]
    assert ts.spec_fallback and js.spec_fallback
    ts.close()
    js.close()


def test_the_source_memory_blocks_and_decays_as_jax(weights):
    jeng, teng = _engines(weights, speculative={"tiny": ("ngram", 3)}, spec_accept_floor=0.5)
    calls = [
        ("blocked", "ngram", None, 0.5), ("feedback", "ngram", None, 0.1),
        ("blocked", "ngram", None, 0.5), ("feedback", "ngram", None, 0.2),
        ("blocked", "model", "tiny-d", 0.5), ("blocked", "ngram", None, 0.0),
        ("blocked", "ngram", None, 0.5), ("blocked", "ngram", None, 0.5),
        ("feedback", "ngram", None, 0.9), ("feedback", "ngram", None, 0.9),
        ("blocked", "ngram", None, 0.5),
    ] + [("feedback", "cross", "tiny-d", 0.01)] * 10 + [
        ("blocked", "cross", "tiny-d", 0.5), ("clear", "cross", "tiny-d", None),
        ("blocked", "cross", "tiny-d", 0.5),
    ]
    for op, source, draft, x in calls:
        args = (source, draft) if op == "clear" else (source, draft, x)
        assert getattr(teng, f"_spec_source_{op}")(*args) == getattr(jeng, f"_spec_source_{op}")(*args)
        assert teng._spec_source_health == jeng._spec_source_health, (op, source)
    # the memory gates arming: two low fallbacks block the next session
    # (and decay by one), the one after speculates; an override ignores it
    teng._spec_source_health.clear()
    for x in (0.1, 0.2):
        teng._spec_source_feedback("ngram", None, x)
    reqs = [GenerationRequest("tiny", "probe probe probe", 8, stop_at_eos=False)]
    blocked = teng.decode_open(reqs)
    assert blocked.spec is None
    blocked.close()
    armed = teng.decode_open(reqs)
    assert armed.spec is not None and armed.spec["source"] == "ngram"
    _drain(armed)
    armed.close()  # a session that speculated to its close clears the source
    assert "ngram:" not in teng._spec_source_health


def test_draft_waste_is_billed_for_cross_rows_with_a_fully_rejected_round(weights):
    _, teng = _engines(weights, speculative={"tiny": ("cross:tiny-d", 3)})
    assert teng.spec_draft_jpt is None
    teng.spec_draft_jpt = lambda name: 0.25 if name == "tiny-d" else None
    rows = [("abc abc abc abc abc", 24), ("the cat the cat the cat", 24), ("zq", 6)]
    wasted0 = WASTED_J.labels(cause="draft").value
    got, _ = _drain(teng.decode_open([GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in rows]))
    billed = 0.0
    for prompt, _ in rows:
        spec = got[prompt].extras["spec"]
        assert spec["source"] == "cross"
        if spec["rejected"]:
            assert spec["draft_wasted_J"] == round(spec["rejected"] * 3 * 0.25, 6) > 0
            assert got[prompt].extras["energy_model"]["wasted_J"] >= spec["draft_wasted_J"] - 1e-9
            billed += spec["draft_wasted_J"]
        else:
            assert "draft_wasted_J" not in spec
    assert billed > 0, "no fully rejected round: the draft agreed with the target throughout"
    assert WASTED_J.labels(cause="draft").value == pytest.approx(wasted0 + billed)
    # a model draft's rejections are its own session's work: never billed
    _, model_eng = _engines(weights, speculative={"tiny": ("tiny-d", 3)})
    model_eng.spec_draft_jpt = teng.spec_draft_jpt
    got, _ = _drain(model_eng.decode_open([GenerationRequest("tiny", p, n, stop_at_eos=False)
                                           for p, n in rows]))
    assert any(r.extras["spec"]["rejected"] for r in got.values())
    assert not any("draft_wasted_J" in r.extras["spec"] for r in got.values())
