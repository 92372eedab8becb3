"""The port's speculative pieces against the JAX package's, in float32.

- ``ngram_propose``: equal proposals on random histories over a small
  alphabet (so suffixes recur), rows with no earlier match, and rows of
  0–3 valid tokens.
- One verify round of the stacked paged spec step: a port session and a
  JAX stacked-hybrid session (the JAX multi-query Pallas kernels in
  interpret mode) open the same greedy rows on the same bridged tiny
  weights, each runs ``step(1)`` (one round), and the rows' emitted
  tokens, their counts ``m``, the cumulative spec counters, the offsets
  and the side-cache columns ``0..write_pos+k`` are equal.
- The draft model's batch cache at per-row offsets ``[B]``: one decode
  step of a batch equals each row's own step at its scalar offset.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine import jax_engine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine import speculative as jspec
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.transformer import init_params
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops.pallas_attention import (
    pallas_decode_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import speculative as tspec
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import (
    TorchEngine,
    _norm_spec,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.transformer import (
    Transformer,
    forward,
    init_params as port_init_params,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.attention import (
    decode_attention_reference,
)
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)


def test_constants_and_spec_forms_match_the_jax_package():
    assert tspec.NGRAM_MAX == jspec.NGRAM_MAX
    assert tspec.DraftSpec._fields == jspec.DraftSpec._fields
    assert _norm_spec(("ngram", 4)) == ("ngram", None, 4)
    assert _norm_spec(("cross:m", 2)) == ("cross", "m", 2)
    assert _norm_spec(("draft", 3)) == ("model", "draft", 3)


@pytest.mark.parametrize("k,nmax", [(1, 3), (3, 3), (4, 3), (4, 2)])
def test_ngram_propose_equals_jax(k, nmax):
    rng = np.random.default_rng(k * 10 + nmax)
    b, h = 24, 40
    hist = rng.integers(3, 9, size=(b, h)).astype(np.int32)  # 6 symbols: matches recur
    hist[:4] = np.arange(4 * h).reshape(4, h) + 10  # all distinct: no match
    hlen = rng.integers(4, h + 1, size=b).astype(np.int32)
    hlen[4:8] = [0, 1, 2, 3]
    want = np.asarray(jspec.ngram_propose(jnp.asarray(hist), jnp.asarray(hlen), k, nmax))
    got = tspec.ngram_propose(
        torch.from_numpy(hist.astype(np.int64)), torch.from_numpy(hlen), k, nmax
    )
    assert got.shape == (b, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # rows without a match propose their last token repeated
    for r in range(4):
        assert (got[r] == int(hist[r, max(int(hlen[r]) - 1, 0)])).all()


ROWS = [("abc abc abc abc abc", 20), ("b" * 149 + " xyz xyz", 14), ("the cat the cat the", 17)]


def _engines(source, kv):
    """A JAX stacked-hybrid spec engine and a port spec engine on the same
    tiny qwen2 weights; the model source drafts with a one-layer cut of
    the target (so some drafts are accepted and some rejected)."""
    cfg = get_model_config("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=1024)
    tcfg = port_config("qwen2:1.5b").tiny(vocab_size=259, max_seq_len=1024)
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(4), jnp.float32))
    draft = {k: v if k in ("embed", "final_norm", "lm_head") else v[:1] for k, v in params.items()}
    spec = {"tiny": ("ngram", 3) if source == "ngram" else ("tiny-d", 3)}
    jeng = JaxEngine(
        registry={}, dtype=jnp.float32, paged_kv=True, kv_quantize=kv,
        decode_attention=pallas_decode_attention, speculative=spec,
    )
    teng = TorchEngine(
        registry={}, dtype=torch.float32, device="cpu", paged_kv=True, kv_quantize=kv,
        speculative=spec,
    )
    for name, p, c, pc in (
        ("tiny", params, cfg, tcfg),
        ("tiny-d", draft, dataclasses.replace(cfg, n_layers=1), dataclasses.replace(tcfg, n_layers=1)),
    ):
        jeng.install_model(name, c, jax.tree.map(jnp.asarray, p))
        teng.install_model(name, pc, params_from_numpy(p, "cpu", torch.float32))
    return jeng, teng


def _side_np(side):
    if isinstance(side, dict):
        return np.asarray(side["q"], np.float32) * np.asarray(side["s"])[..., None]
    return np.asarray(side)


@pytest.mark.parametrize("source,kv", [("ngram", None), ("model", "int8")])
def test_one_verify_round_equals_the_jax_round(source, kv, monkeypatch):
    monkeypatch.setattr(jax_engine, "PAGED_XLA_PARTS_MIN_ROWS", 10**9)
    jeng, teng = _engines(source, kv)
    js = jeng.decode_open([JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS])
    ts = teng.decode_open([GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in ROWS])
    assert js.stacked and js.spec is not None and ts.spec is not None
    assert np.array_equal(np.asarray(js.carry["offsets"]), ts.carry["offsets"].numpy())
    for _ in range(2):  # two rounds, each one step(1)
        js.step(1)
        ts.step(1)
        for jrow, trow in zip(js.rows, ts.rows):
            assert (jrow is None) == (trow is None)
            if jrow is not None:
                assert trow.generated == jrow.generated  # emit[:m] of every round
        for key in ("rounds", "accepted", "drafted", "rejected"):
            assert ts._spec_host[key] == [int(x) for x in js._spec_host[key]], key
        offs = ts.carry["offsets"].numpy()
        assert np.array_equal(np.asarray(js.carry["offsets"]), offs)
    k = 3
    wp = offs - ts.carry["prompt_lens"].numpy()
    for name in ("side_k", "side_v"):
        j_side, t_side = _side_np(js.carry[name]), _side_np(ts.carry[name])
        assert j_side.shape == t_side.shape
        for r in range(len(ROWS)):
            cols = slice(0, int(wp[r]) + k + 1)
            np.testing.assert_allclose(t_side[:, r, :, cols], j_side[:, r, :, cols], atol=1e-5, rtol=1e-5)
    js.close()
    ts.close()


@pytest.mark.parametrize("cache", ["bf16-style", "int8"])
def test_batch_cache_decode_at_per_row_offsets_equals_each_rows_own_step(cache):
    """The draft's contiguous batch cache: one token per row at offsets
    [B] writes column offs[b] of its row and attends ``offs[b] + 1``
    positions, as a solo step at that scalar offset does."""
    cfg = port_config("qwen2:1.5b").tiny(vocab_size=259)
    tf = Transformer(cfg=cfg, params=port_init_params(cfg, torch.Generator().manual_seed(0), torch.float32))
    gen = torch.Generator().manual_seed(1)
    offs = torch.tensor([3, 9, 0, 5])
    b, t = len(offs), 16
    base = tf.init_cache(b, t, dtype=torch.float32)
    base = tuple(torch.randn(x.shape, generator=gen) for x in base)

    def as_cache(x):
        if cache == "int8":
            from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import (
                quantize_kv_cache,
            )

            return quantize_kv_cache(*x)
        return x

    def attn(q, kc, vc, lengths):
        if isinstance(kc, dict):
            kc = kc["q"].to(torch.float32) * kc["s"][..., None]
            vc = vc["q"].to(torch.float32) * vc["s"][..., None]
        return decode_attention_reference(q, kc, vc, lengths)

    tokens = torch.tensor([[5], [17], [42], [7]])
    kc, vc = as_cache(tuple(x.clone() for x in base))
    batch, _, _ = forward(tf.params, cfg, tokens, offs, kc, vc, attn, layers=tf.layers)
    for r in range(b):
        rk, rv = as_cache(tuple(x[:, r : r + 1].clone() for x in base))
        solo, _, _ = forward(tf.params, cfg, tokens[r : r + 1], int(offs[r]), rk, rv, attn, layers=tf.layers)
        torch.testing.assert_close(batch[r], solo[0], atol=1e-5, rtol=1e-5)
        # the row's column offs[b] took this step's K (its own step's, to
        # the f32 rounding of a batched matmul), and no other column moved
        col = int(offs[r])
        got_k, solo_k, base_k = (
            (c["q"].to(torch.float32) * c["s"][..., None]) if isinstance(c, dict) else c
            for c in (kc, rk, as_cache(base)[0])
        )
        tol = 5e-2 if cache == "int8" else 1e-5  # int8: a code may round apart
        torch.testing.assert_close(got_k[:, r, :, col], solo_k[:, 0, :, col], atol=tol, rtol=tol)
        assert not torch.equal(got_k[:, r, :, col], base_k[:, r, :, col])
        others = [c for c in range(t) if c != col]
        assert torch.equal(got_k[:, r, :, others], base_k[:, r, :, others])
