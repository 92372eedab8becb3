"""The port's page pool and page helpers against the JAX package's
``engine/paged_kv.py``: the allocator hands out and recycles the same
pages in the same order, and the helpers address, paginate, group,
quantize (codes bit for bit) and scatter identically."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.engine import paged_kv as jpk
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine import paged_kv as tpk
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_page_pool_allocation_order_matches_jax():
    kw = dict(n_layers=2, n_pages=8, n_kv_heads=2, d_head=16, page_size=128)
    jp = jpk.PagePool.create(**kw)
    tp = tpk.PagePool.create(**kw, dtype=torch.float32)
    assert tp.k.shape == jp.k.shape and tp.n_pages == jp.n_pages == 8
    for pool in (jp, tp):
        assert [pool.pages_for(n) for n in (1, 128, 129, 300)] == [1, 1, 2, 3]
    trace = []
    for pool, exhausted in ((jp, jpk.PagePoolExhausted), (tp, tpk.PagePoolExhausted)):
        a = pool.alloc(3)
        b = pool.alloc(4)
        with pytest.raises(exhausted):
            pool.alloc(2)
        assert pool.try_alloc(2) is None
        pool.free(a)
        c = pool.alloc(4)
        with pytest.raises(ValueError, match="double free"):
            pool.free([a[0], a[0]])
        trace.append((a, b, c, pool.free_pages))
    assert trace[0] == trace[1]


@pytest.mark.parametrize("quantized", [False, True])
def test_debug_state_and_payload_bytes_match_jax(quantized):
    kw = dict(n_layers=2, n_pages=8, n_kv_heads=2, d_head=16, page_size=128, quantized=quantized)
    jp = jpk.PagePool.create(**kw, dtype=jnp.bfloat16)
    tp = tpk.PagePool.create(**kw, dtype=torch.bfloat16)
    for pool in (jp, tp):
        pool.free(pool.alloc(5)[1:3])
        pool.alloc(1)
    assert tp.debug_state() == jp.debug_state()
    assert tp.payload_nbytes() == jp.payload_nbytes()


@pytest.mark.parametrize("dp_shards", [2, 4])
def test_dp_shard_allocation_matches_jax(dp_shards):
    """``PagePool(dp_shards=)``: the same shard of each page, and the same
    pages for shard-tagged allocations (a shard's own range first, then a
    spill into any free page) through frees and re-allocations."""
    kw = dict(n_layers=1, n_pages=16, n_kv_heads=1, d_head=16, page_size=128, dp_shards=dp_shards)
    jp = jpk.PagePool.create(**kw, dtype=jnp.bfloat16)
    tp = tpk.PagePool.create(**kw, dtype=torch.bfloat16)
    assert [tp.shard_of(p) for p in range(16)] == [jp.shard_of(p) for p in range(16)]
    got, want = [], []
    for pool, out in ((jp, want), (tp, got)):
        a = pool.alloc(3, shard=1)
        b = pool.alloc(2, shard=dp_shards - 1)
        pool.free(a[:2])
        c = pool.alloc(16 // dp_shards + 2, shard=1)  # more than the range: spills
        out.append((a, b, c, pool.free_pages, pool.debug_state()))
    assert got == want


def test_page_slot_matches_jax():
    table = np.array([[5, 2, 7], [1, 0, 3]], dtype=np.int32)
    lengths = np.array([129, 300], dtype=np.int32)
    jpages, jslots = jpk.page_slot(jnp.asarray(table), jnp.asarray(lengths), 128)
    tpages, tslots = tpk.page_slot(torch.from_numpy(table), torch.from_numpy(lengths), 128)
    np.testing.assert_array_equal(tpages.numpy(), np.asarray(jpages))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    # one row and a scalar length give scalars
    jp, js = jpk.page_slot(jnp.asarray(table[0]), 200, 128)
    tp, ts = tpk.page_slot(torch.from_numpy(table[0]), 200, 128)
    assert (int(tp), int(ts)) == (int(jp), int(js)) == (2, 72)


@pytest.mark.parametrize("s_real", [1, 128, 200])
def test_paginate_matches_jax(s_real):
    seq = _normal(np.random.default_rng(0), (2, 3, 256, 16))
    want = jpk._paginate(jnp.asarray(seq), s_real, 128)
    got = tpk._paginate(torch.from_numpy(seq), s_real, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,t", [([0, 1, 2], 256), ([2, 0], 200)])
def test_group_chunks_matches_jax(rows, t):
    rng = np.random.default_rng(1)
    k = _normal(rng, (2, 3, 2, t, 16))
    v = _normal(rng, (2, 3, 2, t, 16))
    jk, jv = jpk.group_chunks(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows, jnp.int32), 128, 16
    )
    tk, tv = tpk.group_chunks(torch.from_numpy(k), torch.from_numpy(v), rows, 128)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantize_chunks_codes_are_bit_identical():
    rng = np.random.default_rng(2)
    k = _normal(rng, (3, 2, 2, 128, 16))
    k[0, :, :, 100:] = 0.0  # zero (padded) positions: epsilon scale, zero codes
    v = _normal(rng, (3, 2, 2, 128, 16))
    jk, jv = jpk.quantize_chunks(jnp.asarray(k), jnp.asarray(v))
    tk, tv = tpk.quantize_chunks(torch.from_numpy(k), torch.from_numpy(v))
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
        np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("quantized", [False, True])
def test_scatter_pages_matches_jax(quantized):
    rng = np.random.default_rng(3)
    kw = dict(n_layers=2, n_pages=6, n_kv_heads=2, d_head=16, page_size=128, quantized=quantized)
    jp = jpk.PagePool.create(**kw, dtype=jnp.float32)
    tp = tpk.PagePool.create(**kw, dtype=torch.float32)
    k = _normal(rng, (3, 2, 2, 128, 16))
    v = _normal(rng, (3, 2, 2, 128, 16))
    dest = [4, 0, 2]
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    if quantized:
        jk, jv = jpk.quantize_chunks(jk, jv)
        tk, tv = tpk.quantize_chunks(tk, tv)
    jp.k, jp.v = jpk.scatter_pages(jp.k, jp.v, jnp.asarray(dest, jnp.int32), jk, jv)
    out_k, out_v = tpk.scatter_pages(tp.k, tp.v, dest, tk, tv)
    assert out_k is tp.k and out_v is tp.v  # in place
    for got, want in ((tp.k, jp.k), (tp.v, jp.v)):
        if quantized:
            np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
            np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
