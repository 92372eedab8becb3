"""The write-through paged decode slice against the JAX package.

- B6's plain version (``paged_decode_attention_reference``, what
  ``cuda_paged_decode_attention`` computes on the CPU) against the JAX
  Pallas kernel ``pallas_paged_decode_attention`` in interpret mode and
  against the JAX reference: head dims 64, 96 and 128, GQA 8/2 and MQA
  8/1, a shuffled table whose entries past each row's frontier are junk
  (some outside the pool), lengths at, before and after a page boundary.
  float32 within 2e-5 (the tolerance of ``tests/test_paged_attention.py``).
- The pool functions (``write_prefill``, ``write_token``, ``share``,
  ``free``, ``refcount``, ``swap_out``, ``swap_in``) against the JAX
  package's: pool contents, codes and scales bit for bit on f32 and int8
  pools, and the same errors.
- One write-through ``forward`` per step against the JAX ``forward`` over
  its legacy leaf (the table broadcast per layer, as its legacy loop does)
  with the JAX engine's paged dispatch (B6 in interpret mode), on bridged
  tiny qwen2 and phi3 in f32: hidden states within 1e-5 and greedy tokens
  equal over 8 steps; an int8 pool through the gather path likewise.
- The slice: mixed-length requests prefilled, written with
  ``write_prefill`` and decoded greedily for 12 steps through the
  engine's dispatch; tokens equal ``JaxEngine(paged_kv=True)
  .generate_batch``'s (its write-through gather mode) and the port's own
  stacked ``generate_batch``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine import paged_kv as jpk
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.backend import (
    GenerationRequest as JaxRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine.jax_engine import JaxEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models import transformer as jtf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.config import get_model_config
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_paged_attention as jpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops.pallas_attention import (
    pallas_decode_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import paged_kv as tpk
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import torch_engine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
    GenerationRequest,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import TorchEngine
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import transformer as ttf
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.bridge import params_from_numpy
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.config import (
    get_model_config as port_config,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import attention as tpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

TOL = dict(atol=2e-5, rtol=2e-5)
PAGE = 16
# at, before and after a page boundary, several pages, and one token
LENGTHS = [16, 15, 17, 40, 1]
MODELS = {"qwen2": "qwen2:1.5b", "phi3": "phi3:3.8b"}  # GQA, MHA


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _b6_inputs(seed, hq, hkv, d, lengths=LENGTHS):
    """q, shuffled pools, a table whose entries past each row's frontier
    are junk (in and out of the pool's range), lengths; numpy."""
    rng = np.random.default_rng(seed)
    need = [-(-n // PAGE) for n in lengths]
    jmax = max(need) + 2
    n_pool = sum(need) + 3
    perm = rng.permutation(n_pool)
    table = rng.integers(-3, n_pool + 5, size=(len(lengths), jmax)).astype(np.int32)
    pos = 0
    for r, k in enumerate(need):
        table[r, :k] = perm[pos : pos + k]
        pos += k
    q = rng.standard_normal((len(lengths), hq, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, hkv, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, hkv, PAGE, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, dtype=np.int32)


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (8, 1)])
def test_b6_plain_version_matches_the_jax_kernel_and_reference(hq, hkv, d):
    q, k, v, table, lengths = _b6_inputs(d + hkv, hq, hkv, d)
    assert (table < 0).any() and (table >= k.shape[0]).any()  # junk past the frontiers
    jargs = [jnp.asarray(a) for a in (q, k, v, table, lengths)]
    kernel = np.asarray(jpa.pallas_paged_decode_attention(*jargs, interpret=True))
    ref = np.asarray(jpa.paged_decode_attention_reference(*jargs))
    got = cpa.cuda_paged_decode_attention(*(_t(a) for a in (q, k, v, table, lengths)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_b6_plain_version_keeps_bf16():
    q, k, v, table, lengths = _b6_inputs(3, 8, 2, 128)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + [jnp.asarray(table), jnp.asarray(lengths)]
    want = np.asarray(jpa.pallas_paged_decode_attention(*jargs, interpret=True).astype(jnp.float32))
    bf = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = cpa.cuda_paged_decode_attention(*bf, _t(table), _t(lengths))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_b6_plain_version_is_the_gathered_contiguous_decode():
    """Through the clipped table, B6's plain version is B2's on the
    gathered pages: the same function the two kernels share a body for."""
    q, k, v, table, lengths = (_t(a) for a in _b6_inputs(5, 8, 2, 64))
    got = tpa.paged_decode_attention_reference(q, k, v, table, lengths)
    kc, vc = tpa._gather_pages(k, table), tpa._gather_pages(v, table)
    torch.testing.assert_close(got, tpa.decode_attention_reference(q, kc, vc, lengths), atol=0, rtol=0)


# -- the pool --------------------------------------------------------------------


def _pools(quantized, n_pages=6, layers=2, hkv=2, d=16):
    kw = dict(n_layers=layers, n_pages=n_pages, n_kv_heads=hkv, d_head=d,
              page_size=PAGE, quantized=quantized)
    return jpk.PagePool.create(**kw, dtype=jnp.float32), tpk.PagePool.create(**kw, dtype=torch.float32)


def _assert_pool_equal(jleaf, tleaf):
    if isinstance(jleaf, dict):
        assert set(jleaf) == set(tleaf) == {"q", "s"}
        for key in jleaf:
            np.testing.assert_array_equal(tleaf[key].numpy(), np.asarray(jleaf[key]))
    else:
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_write_prefill_and_write_token_match_jax(quantized):
    rng = np.random.default_rng(11)
    jp, tp = _pools(quantized)
    s_real = 20  # two pages, the second partly filled
    k_seq = rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
    v_seq = rng.standard_normal((2, 2, 32, 16)).astype(np.float32)
    for pool in (jp, tp):
        pages = pool.alloc(3)
        assert pages == [0, 1, 2]
    row = np.array([4, 1, 3], dtype=np.int32)  # not the allocation order
    jp.k, jp.v = jpk.write_prefill(jp.k, jp.v, jnp.asarray(row), jnp.asarray(k_seq), jnp.asarray(v_seq), s_real)
    out = tpk.write_prefill(tp.k, tp.v, _t(row), _t(k_seq), _t(v_seq), s_real)
    assert out[0] is tp.k and out[1] is tp.v  # in place
    _assert_pool_equal(jp.k, tp.k)
    _assert_pool_equal(jp.v, tp.v)
    # tokens 20..33: the last of page 1 is 31, then 32 opens page 3 (row[2])
    for length in range(s_real, 34):
        kv = rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
        jp.k, jp.v = jpk.write_token(jp.k, jp.v, jnp.asarray(row), jnp.int32(length),
                                     jnp.asarray(kv[0]), jnp.asarray(kv[1]))
        tpk.write_token(tp.k, tp.v, _t(row), length, _t(kv[0]), _t(kv[1]))
    _assert_pool_equal(jp.k, tp.k)
    _assert_pool_equal(jp.v, tp.v)


def test_share_free_and_refcounts_match_jax():
    jp, tp = _pools(False)
    trace = []
    for pool in (jp, tp):
        a = pool.alloc(3)
        pool.share(a[:2])
        pool.share(a[:1])
        counts = [pool.refcount(p) for p in range(pool.n_pages)]
        shared = pool.shared_pages
        with pytest.raises(ValueError, match="cannot share a free page"):
            pool.share([5])
        pool.free(a)
        after_one = (pool.free_pages, [pool.refcount(p) for p in a])
        pool.free(a[:2])
        pool.free(a[:1])
        with pytest.raises(ValueError, match="double free"):
            pool.free(a[:1])
        trace.append((a, counts, shared, after_one, pool.free_pages, pool._free))
    assert trace[0] == trace[1]
    assert trace[1][1][:3] == [3, 2, 1] and trace[1][2] == 2


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_swap_out_and_in_match_jax(quantized):
    rng = np.random.default_rng(12)
    jp, tp = _pools(quantized, n_pages=8)
    k_seq = rng.standard_normal((2, 2, 48, 16)).astype(np.float32)
    v_seq = rng.standard_normal((2, 2, 48, 16)).astype(np.float32)
    blobs, restored = [], []
    for pool, mod, conv in ((jp, jpk, jnp.asarray), (tp, tpk, _t)):
        pages = pool.alloc(3)
        pool.k, pool.v = mod.write_prefill(pool.k, pool.v, conv(np.asarray(pages, np.int32)),
                                           conv(k_seq), conv(v_seq), 48)
        other = pool.alloc(2)
        pool.share(other[:1])
        with pytest.raises(ValueError, match="shared"):
            pool.swap_out(other[:1])
        with pytest.raises(ValueError, match="is free"):
            pool.swap_out([7])
        blob = pool.swap_out(pages[1:])
        assert pool.free_pages == 5 and blob.n_pages == 2 and blob.quantized == quantized
        blobs.append(blob)
        # back into pages the caller reserved, then into fresh ones
        reserved = pool.alloc(2)
        restored.append((pool.swap_in(blob, pages=reserved), reserved, pool.swap_in(blob)))
        with pytest.raises(ValueError, match="reserved 1 pages"):
            pool.swap_in(blob, pages=[1])
        mismatched = mod.PagePool.create(2, 4, 2, 16, page_size=PAGE, quantized=not quantized)
        with pytest.raises(ValueError, match="does not match"):
            mismatched.swap_in(blob)
    jb, tb = blobs
    assert tb.nbytes == jb.nbytes
    for jc, tc in ((jb.k_chunks, tb.k_chunks), (jb.v_chunks, tb.v_chunks)):
        assert (tc["q"] if quantized else tc).device.type == "cpu"
        _assert_pool_equal(jc, tc)
    assert restored[0] == restored[1] == ([5, 6], [5, 6], [7, 1])
    _assert_pool_equal(jp.k, tp.k)
    _assert_pool_equal(jp.v, tp.v)
    assert tp._free == jp._free


# -- the model -------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    name = MODELS[request.param]
    cfg = get_model_config(name).tiny(vocab_size=259, max_seq_len=512)
    params = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(7), jnp.float32))
    tcfg = port_config(name).tiny(vocab_size=259, max_seq_len=512)
    return cfg, tcfg, params, params_from_numpy(params, "cpu", torch.float32)


def _prefilled_pools(cfg, tcfg, np_params, t_params, prompts, quantized, page=PAGE, extra=9):
    """Both packages' pools with each prompt prefilled (contiguous forward)
    and written with write_prefill; rows own ceil((len + extra) / page)
    pages, shuffled, and the table's entries past them are junk. Returns
    (jax pool, port pool, table, lengths, first greedy tokens)."""
    rng = np.random.default_rng(21)
    need = [-(-(len(p) + extra) // page) for p in prompts]
    n_pool = sum(need) + 2
    kw = dict(n_layers=cfg.n_layers, n_pages=n_pool, n_kv_heads=cfg.n_kv_heads,
              d_head=cfg.d_head, page_size=page, quantized=quantized)
    jp = jpk.PagePool.create(**kw, dtype=jnp.float32)
    tp = tpk.PagePool.create(**kw, dtype=torch.float32)
    perm = rng.permutation(n_pool)
    table = rng.integers(0, n_pool, size=(len(prompts), max(need) + 1)).astype(np.int32)
    firsts, pos = [], 0
    jparams = jax.tree.map(jnp.asarray, np_params)
    for r, ids in enumerate(prompts):
        table[r, : need[r]] = perm[pos : pos + need[r]]
        pos += need[r]
        s = len(ids)
        shape = (cfg.n_layers, 1, cfg.n_kv_heads, s, cfg.d_head)
        h, kc, vc = jtf.forward(jparams, cfg, jnp.asarray([ids]), 0, jnp.zeros(shape), jnp.zeros(shape))
        firsts.append(int(jnp.argmax(jtf.logits_for(jparams, cfg, h[:, -1]))))
        jp.k, jp.v = jpk.write_prefill(jp.k, jp.v, jnp.asarray(table[r]), kc[:, 0], vc[:, 0], s)
        tk, tv = torch.zeros(shape), torch.zeros(shape)
        th, tk, tv = ttf.forward(t_params, tcfg, torch.tensor([ids]), 0, tk, tv)
        assert int(torch.argmax(ttf.logits_for(t_params, tcfg, th[:, -1]))) == firsts[-1]
        tpk.write_prefill(tp.k, tp.v, _t(table[r]), tk[:, 0], tv[:, 0], s)
    lengths = np.asarray([len(p) for p in prompts], dtype=np.int32)
    return jp, tp, table, lengths, np.asarray(firsts)


PROMPTS = [[1] + [7 + i % 50 for i in range(n)] for n in (4, 14, 15, 30)]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32-pool-B6", "int8-pool-gather"])
def test_write_through_forward_matches_jax(model, quantized):
    """Eight greedy steps: the f32 pool through each package's paged
    dispatch (B6), the int8 pool through each package's gather path."""
    cfg, tcfg, np_params, t_params = model
    jp, tp, table, lengths, first = _prefilled_pools(cfg, tcfg, np_params, t_params, PROMPTS, quantized)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jdispatch = None
    tdispatch = None
    if not quantized:
        jeng = JaxEngine(registry={}, dtype=jnp.float32, paged_kv=True,
                         decode_attention=pallas_decode_attention)
        jdispatch = jeng._paged_decode_attention(cfg)
        tdispatch = torch_engine._paged_parts
        assert jdispatch is not None
    jtable = jnp.broadcast_to(jnp.asarray(table), (cfg.n_layers,) + table.shape)
    tok_j, tok_t = jnp.asarray(first), torch.from_numpy(first.copy())
    offs = lengths.copy()
    for step in range(8):
        jk = {"pool": jp.k, "table": jtable}
        jv = {"pool": jp.v, "table": jtable}
        jh, jk, jv = jtf.forward(jparams, cfg, tok_j[:, None], jnp.asarray(offs), jk, jv, jdispatch)
        jp.k, jp.v = jk["pool"], jv["pool"]
        tk = {"pool": tp.k, "table": _t(table)}
        tv = {"pool": tp.v, "table": _t(table)}
        th, _, _ = ttf.forward(t_params, tcfg, tok_t[:, None], _t(offs).long(), tk, tv, tdispatch)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
        tok_j = jnp.argmax(jtf.logits_for(jparams, cfg, jh[:, 0]), axis=-1)
        tok_t = torch.argmax(ttf.logits_for(t_params, tcfg, th[:, 0]), dim=-1)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j), err_msg=f"step {step}")
        offs = offs + 1
    # the steps' K/V went into the pools through the table, as JAX wrote them
    if quantized:
        np.testing.assert_allclose(tp.k["s"].numpy(), np.asarray(jp.k["s"]), rtol=1e-5)
    else:
        np.testing.assert_allclose(tp.k.numpy(), np.asarray(jp.k), atol=1e-5, rtol=1e-5)


def test_write_through_dispatch_counts_b6_and_refuses_int8(model, monkeypatch):
    """The engine's dispatch sends a bf16/f32 write-through leaf to B6 once
    per layer per step, and refuses an int8 pool (the JAX package has no
    int8 B6); prefill and multi-token blocks on the leaf raise."""
    cfg, tcfg, np_params, t_params = model
    _, tp, table, lengths, first = _prefilled_pools(cfg, tcfg, np_params, t_params, PROMPTS[:2], False)
    calls = []
    real = torch_engine.cuda_paged_decode_attention
    monkeypatch.setattr(torch_engine, "cuda_paged_decode_attention",
                        lambda *a: calls.append(a[4].tolist()) or real(*a))
    leaf_k, leaf_v = {"pool": tp.k, "table": _t(table)}, {"pool": tp.v, "table": _t(table)}
    ttf.forward(t_params, tcfg, torch.from_numpy(first)[:, None], _t(lengths).long(),
                leaf_k, leaf_v, torch_engine._paged_parts)
    assert calls == [(lengths + 1).tolist()] * tcfg.n_layers
    with pytest.raises(ValueError, match="single-token"):
        ttf.forward(t_params, tcfg, torch.zeros((2, 3), dtype=torch.long), 0, leaf_k, leaf_v)
    _, tq, _, _, _ = _prefilled_pools(cfg, tcfg, np_params, t_params, PROMPTS[:2], True)
    with pytest.raises(NotImplementedError, match="int8 write-through"):
        ttf.forward(t_params, tcfg, torch.from_numpy(first)[:, None], _t(lengths).long(),
                    {"pool": tq.k, "table": _t(table)}, {"pool": tq.v, "table": _t(table)},
                    torch_engine._paged_parts)


# -- the slice -------------------------------------------------------------------

SLICE_ROWS = [("a short row", 13), ("b" * 149, 13), ("c" * 299, 9), ("the fourth row " * 3, 13)]


def _write_through_generate(engine, model_name, requests):
    """The write-through slice at the model level: each row prefilled by the
    engine (contiguous), written into one pool with ``write_prefill`` (the
    row owns prompt + budget pages, the JAX legacy bill), then greedy steps
    through ``forward`` with the engine's paged dispatch; a row is done at
    its budget or EOS, as in the JAX legacy loop. Returns token lists."""
    tf = engine._models[model_name]
    cfg, page = tf.cfg, engine.page_size
    tok = engine._tokenizer_for(model_name)
    ids = [tok.encode(r.prompt) for r in requests]
    budgets = [r.max_new_tokens - 1 for r in requests]
    need = [-(-(len(x) + b + 1) // page) for x, b in zip(ids, budgets)]
    pool = tpk.PagePool.create(cfg.n_layers, sum(need), cfg.n_kv_heads, cfg.d_head, page,
                               dtype=engine.dtype, device=engine.device)
    table = torch.zeros((len(ids), max(need)), dtype=torch.int32)
    first = []
    for r, row in enumerate(ids):
        table[r, : need[r]] = torch.tensor(pool.alloc(need[r]))
        logits, kc, vc = engine._run_prefill(model_name, row, torch_engine._prompt_alloc(len(row)))
        first.append(int(torch.argmax(logits[0])))
        tpk.write_prefill(pool.k, pool.v, table[r], kc[:, 0], vc[:, 0], len(row))
    token = torch.tensor(first)
    offs = torch.tensor([len(x) for x in ids])
    done = torch.tensor([b <= 0 for b in budgets])
    out = [[f] for f in first]
    for i in range(max(budgets)):
        kc, vc = {"pool": pool.k, "table": table}, {"pool": pool.v, "table": table}
        h, _, _ = ttf.forward(tf.params, cfg, token[:, None], offs, kc, vc,
                              torch_engine._paged_parts, layers=tf.layers)
        nxt = torch.argmax(ttf.logits_for(tf.params, cfg, h[:, 0]), dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, tok.eos_id), nxt)
        for r in range(len(ids)):
            if not bool(done[r]):
                out[r].append(int(nxt[r]))
        done = done | (nxt == tok.eos_id) | torch.tensor([i + 1 >= b for b in budgets])
        offs = torch.where(done, offs, offs + 1)
        token = nxt
    return out


def test_write_through_slice_equals_jax_legacy_and_stacked_batches(model):
    cfg, tcfg, np_params, t_params = model
    jeng = JaxEngine(registry={}, dtype=jnp.float32, paged_kv=True)
    jeng.install_model("tiny", cfg, jax.tree.map(jnp.asarray, np_params))
    assert jeng._paged_decode_attention(cfg) is None  # the write-through gather mode
    teng = TorchEngine(registry={}, dtype=torch.float32, device="cpu", paged_kv=True)
    teng.install_model("tiny", tcfg, t_params)
    want = jeng.generate_batch([JaxRequest("tiny", p, n, stop_at_eos=False) for p, n in SLICE_ROWS])
    treqs = [GenerationRequest("tiny", p, n, stop_at_eos=False) for p, n in SLICE_ROWS]
    stacked = teng.generate_batch(treqs)
    got = _write_through_generate(teng, "tiny", treqs)
    for g, w, s, (prompt, n) in zip(got, want, stacked, SLICE_ROWS):
        assert g == w.tokens == s.tokens, prompt
        assert len(g) == n  # no EOS inside the budgets
