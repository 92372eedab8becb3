"""How the port's attention wrappers keep a kernel's caps from their
callers, and the stacked ``layer=`` form, on the CPU against the JAX
package (Pallas kernels in interpret mode).

- Query chunks: ``chunk_queries`` runs the multi-query parts on chunks of
  at most ``q_max`` query positions (``offsets`` shifted by each chunk's
  start) and concatenates them. Here it runs the plain versions of B7/B8
  with a cap of 3 at Q 10–17, against the JAX Pallas multi-query kernels
  over float and int8 pools.
- Head groups: ``tile_groups`` runs a kernel on sub-groups of the query
  heads of each kv head and stitches them. Here it runs the plain versions
  of B1–B8 with caps of 1–4 against the untiled plain versions and the
  JAX kernels.
- ``layer=``: the four parts wrappers read a stacked ``[L,P,Hkv,page,D]``
  pool through a view of one layer; against the JAX kernels' own
  ``layer=`` form.

Float32 throughout: 1e-5 (the same f32 math summed in another order over
a few hundred keys). Queries that see no token are compared where the
Pallas kernels define them (they leave NaN there; the port gives
(0, -inf, 0)), as ``tests/test_torch_paged_mq.py`` does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.quantize import (
    quantize_kv_vector as jax_quantize_kv_vector,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_attention as jpat
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_paged_attention as jpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import attention as tpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_attention as ca
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 128
LENGTHS = [0, 1, 129, 300, 512]  # an empty row, page edges, four pages
OFFSETS = [0, -1, 100, 290, 500]  # cuts in rows 1-4


def _pool_inputs(seed, q_shape, hkv, d, lengths=LENGTHS, n_layers=None):
    """q, pools [P,Hkv,page,D] (or stacked [L,P,Hkv,page,D]), a scattered
    table [B,Jmax] and lengths [B], as numpy."""
    rng = np.random.default_rng(seed)
    need = [-(-n // PAGE) for n in lengths]
    jmax = max(need)
    n_pool = sum(need) + 3
    perm = rng.permutation(n_pool)
    table = np.zeros((len(lengths), jmax), dtype=np.int32)
    pos = 0
    for r, k in enumerate(need):
        table[r, :k] = perm[pos : pos + k]
        pos += k
    lead = (n_layers,) if n_layers else ()
    q = rng.standard_normal(q_shape).astype(np.float32)
    k = rng.standard_normal((*lead, n_pool, hkv, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((*lead, n_pool, hkv, PAGE, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, dtype=np.int32)


def _lane_pad(x, d):
    """The JAX Pallas paged kernels take pools pre-padded to 128 lanes."""
    pad = (-d) % 128
    return x if not pad else jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]  # writable copies


def _seen(q_len, lengths=LENGTHS, offsets=OFFSETS):
    return np.array(
        [[min(n, off + j + 1) > 0 for j in range(q_len)] for n, off in zip(lengths, offsets)]
    )


def _assert_parts(got, want, seen=None, tol=TOL):
    for x, y in zip(got, want):
        x, y = np.asarray(x), np.asarray(y)
        if seen is not None:
            x, y = x[seen], y[seen]
        np.testing.assert_allclose(x, y, **tol)


# ---- query chunks (B7/B8) ----------------------------------------------------


@pytest.mark.parametrize("kind", ["float-pool", "int8-pool"])
@pytest.mark.parametrize("q_len", [10, 13, 17])
def test_query_chunks_match_pallas_mq_kernel(q_len, kind):
    """Q 10–17 in chunks of at most 3 query positions equal the JAX
    multi-query kernel's one call, and the plain version's one call."""
    hq, hkv, d = 12, 2, 128
    q, k, v, table, lengths = _pool_inputs(q_len, (len(LENGTHS), q_len, hq, d), hkv, d)
    offsets = np.asarray(OFFSETS, dtype=np.int32)
    jargs = (jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(offsets))
    tq, tt, tl, to = _t(q, table, lengths, offsets)
    if kind == "int8-pool":
        jkq, jks = jax_quantize_kv_vector(jnp.asarray(k))
        jvq, jvs = jax_quantize_kv_vector(jnp.asarray(v))
        want = jpa.pallas_paged_decode_attention_mq_parts_int8(
            jnp.asarray(q), _lane_pad(jkq, d), jks, _lane_pad(jvq, d), jvs, *jargs, interpret=True,
        )
        pool = _t(np.asarray(jkq), np.asarray(jks), np.asarray(jvq), np.asarray(jvs))
        plain = tpa.paged_mq_attention_int8_reference
    else:
        want = jpa.paged_mq_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *jargs)
        pool = _t(k, v)
        plain = tpa.paged_mq_attention_reference
    calls = []

    def run(qc, oc):
        calls.append(qc.shape[1])
        return plain(qc, *pool, tt, tl, oc)

    got = cpa.chunk_queries(run, tq, to, 3)
    assert calls == [3] * (q_len // 3) + ([q_len % 3] if q_len % 3 else [])
    assert got[0].shape == (len(LENGTHS), q_len, hkv, hq // hkv, d)
    _assert_parts(got, want, seen=_seen(q_len))
    one = plain(tq, *pool, tt, tl, to)
    _assert_parts(got, one)  # the empty queries too: exactly (0, -inf, 0)


def test_query_chunks_pass_a_block_within_the_cap_whole():
    q = torch.zeros((2, 5, 4, 64))
    offsets = torch.zeros(2, dtype=torch.int32)
    calls = []
    cpa.chunk_queries(lambda qc, oc: calls.append((qc.shape[1], oc.tolist())) or (qc, qc, qc), q, offsets, 9)
    assert calls == [(5, [0, 0])]


# ---- head groups (B1-B8) -----------------------------------------------------

GROUP_CASES = [(16, 1, 64, 8), (12, 2, 128, 4), (8, 2, 96, 3), (6, 1, 256, 1)]  # (Hq, Hkv, D, cap)


@pytest.mark.parametrize("hq,hkv,d,cap", GROUP_CASES)
def test_group_tiles_of_decode_match_pallas(hq, hkv, d, cap):
    """B2/B3's plain versions on sub-groups of at most ``cap`` heads equal
    their one call and the JAX Pallas decode kernels."""
    rng = np.random.default_rng(hq + d)
    t = 200
    q = rng.standard_normal((3, hq, d)).astype(np.float32)
    k = rng.standard_normal((3, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((3, hkv, t, d)).astype(np.float32)
    lengths = np.asarray([1, 77, 200], dtype=np.int32)
    tq, tk, tv, tl = _t(q, k, v, lengths)
    got = ca.tile_groups(lambda qs: tpa.decode_attention_reference(qs, tk, tv, tl), tq, hkv, cap)
    np.testing.assert_allclose(got.numpy(), tpa.decode_attention_reference(tq, tk, tv, tl).numpy(), **TOL)
    want = jpat.pallas_decode_attention(*map(jnp.asarray, (q, k, v, lengths)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jkq, jks = jax_quantize_kv_vector(jnp.asarray(k))
    jvq, jvs = jax_quantize_kv_vector(jnp.asarray(v))
    codes = _t(np.asarray(jkq), np.asarray(jks), np.asarray(jvq), np.asarray(jvs))
    got = ca.tile_groups(lambda qs: tpa.decode_attention_int8_reference(qs, *codes, tl), tq, hkv, cap)
    want = jpat.pallas_decode_attention_int8(
        jnp.asarray(q), jkq, jks, jvq, jvs, jnp.asarray(lengths), interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hq,hkv,d,cap", GROUP_CASES)
def test_group_tiles_of_prefill_match_pallas(hq, hkv, d, cap):
    rng = np.random.default_rng(hq * d)
    s, t, offset = 20, 64, 30
    q = rng.standard_normal((2, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, t, d)).astype(np.float32)
    tq, tk, tv = _t(q, k, v)
    got = ca.tile_groups(lambda qs: tpa.prefill_attention_cached(qs, tk, tv, offset), tq, hkv, cap)
    np.testing.assert_allclose(got.numpy(), tpa.prefill_attention_cached(tq, tk, tv, offset).numpy(), **TOL)
    want = jpat.pallas_prefill_attention(
        *map(jnp.asarray, (q, k, v)), jnp.int32(offset), block_q=8, block_k=16, interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hq,hkv,d,cap", GROUP_CASES)
def test_group_tiles_of_paged_parts_match_pallas(hq, hkv, d, cap):
    """B4/B5 (parts), B6 (normalised) and B7/B8 (multi-query parts) on
    sub-groups equal the JAX kernels."""
    q, k, v, table, lengths = _pool_inputs(d, (len(LENGTHS), 4, hq, d), hkv, d)
    offsets = np.asarray(OFFSETS, dtype=np.int32)
    tq, tk, tv, tt, tl, to = _t(q, k, v, table, lengths, offsets)
    jq, jk, jv = jnp.asarray(q), _lane_pad(jnp.asarray(k), d), _lane_pad(jnp.asarray(v), d)
    jt, jl = jnp.asarray(table), jnp.asarray(lengths)
    live = lengths > 0

    got = ca.tile_groups(
        lambda qs: tpa.paged_decode_attention_parts_reference(qs, tk, tv, tt, tl), tq[:, 0], hkv, cap
    )
    want = jpa.pallas_paged_decode_attention_parts(jq[:, 0], jk, jv, jt, jl, interpret=True)
    _assert_parts([x[live] for x in got], [np.asarray(x)[live] for x in want])

    jkq, jks = jax_quantize_kv_vector(jnp.asarray(k))
    jvq, jvs = jax_quantize_kv_vector(jnp.asarray(v))
    codes = _t(np.asarray(jkq), np.asarray(jks), np.asarray(jvq), np.asarray(jvs))
    got = ca.tile_groups(
        lambda qs: tpa.paged_decode_attention_parts_int8_reference(qs, *codes, tt, tl), tq[:, 0], hkv, cap
    )
    want = jpa.pallas_paged_decode_attention_parts_int8(
        jq[:, 0], _lane_pad(jkq, d), jks, _lane_pad(jvq, d), jvs, jt, jl, interpret=True
    )
    _assert_parts([x[live] for x in got], [np.asarray(x)[live] for x in want])

    full = tl + (tl == 0).to(torch.int32)  # B6 attends the current token: no empty row
    got = ca.tile_groups(
        lambda qs: tpa.paged_decode_attention_reference(qs, tk, tv, tt, full), tq[:, 0], hkv, cap
    )
    want = jpa.paged_decode_attention_reference(jq[:, 0], jnp.asarray(k), jnp.asarray(v), jt,
                                                jnp.asarray(full.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    got = ca.tile_groups(
        lambda qs: tpa.paged_mq_attention_reference(qs, tk, tv, tt, tl, to), tq, hkv, cap
    )
    want = jpa.pallas_paged_decode_attention_mq_parts(
        jq, jk, jv, jt, jl, jnp.asarray(offsets), interpret=True
    )
    _assert_parts(got, want, seen=_seen(4))


# ---- the stacked layer= form (B4/B5/B7/B8) -----------------------------------

N_LAYERS = 3


def _stacked(seed, q_shape, hkv, d, int8):
    q, k, v, table, lengths = _pool_inputs(seed, q_shape, hkv, d, n_layers=N_LAYERS)
    if int8:
        jkq, jks = jax_quantize_kv_vector(jnp.asarray(k))
        jvq, jvs = jax_quantize_kv_vector(jnp.asarray(v))
        jpool = (_lane_pad(jkq, d), jks, _lane_pad(jvq, d), jvs)
        pool = _t(np.asarray(jkq), np.asarray(jks), np.asarray(jvq), np.asarray(jvs))
    else:
        jpool = (_lane_pad(jnp.asarray(k), d), _lane_pad(jnp.asarray(v), d))
        pool = _t(k, v)
    return q, table, lengths, jpool, pool


def _as_layer(layer, form):
    return torch.tensor(layer, dtype=torch.int32) if form == "tensor" else layer


@pytest.mark.parametrize("form", ["int", "tensor"])
@pytest.mark.parametrize(
    "fn,jfn,int8",
    [
        (cpa.cuda_paged_decode_attention_parts, jpa.pallas_paged_decode_attention_parts, False),
        (cpa.cuda_paged_decode_attention_parts_int8, jpa.pallas_paged_decode_attention_parts_int8, True),
    ],
    ids=["parts", "parts_int8"],
)
def test_stacked_layer_parts_match_pallas_layer_form(fn, jfn, int8, form):
    hq, hkv, d = 12, 2, 128
    q, table, lengths, jpool, pool = _stacked(5, (len(LENGTHS), hq, d), hkv, d, int8)
    tq, tt, tl = _t(q, table, lengths)
    live = lengths > 0
    for layer in range(N_LAYERS):
        got = fn(tq, *pool, tt, tl, layer=_as_layer(layer, form))
        want = jfn(jnp.asarray(q), *jpool, jnp.asarray(table), jnp.asarray(lengths),
                   layer=jnp.int32(layer), interpret=True)
        _assert_parts([x[live] for x in got], [np.asarray(x)[live] for x in want])
        per_layer = fn(tq, *(p[layer] for p in pool), tt, tl)
        for a, b in zip(got, per_layer):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["int", "tensor"])
@pytest.mark.parametrize(
    "fn,jfn,int8",
    [
        (cpa.cuda_paged_decode_attention_mq_parts, jpa.pallas_paged_decode_attention_mq_parts, False),
        (cpa.cuda_paged_decode_attention_mq_parts_int8, jpa.pallas_paged_decode_attention_mq_parts_int8, True),
    ],
    ids=["mq_parts", "mq_parts_int8"],
)
def test_stacked_layer_mq_parts_match_pallas_layer_form(fn, jfn, int8, form):
    q_len, hq, hkv, d = 5, 12, 2, 128
    q, table, lengths, jpool, pool = _stacked(6, (len(LENGTHS), q_len, hq, d), hkv, d, int8)
    offsets = np.asarray(OFFSETS, dtype=np.int32)
    tq, tt, tl, to = _t(q, table, lengths, offsets)
    for layer in range(N_LAYERS):
        got = fn(tq, *pool, tt, tl, to, layer=_as_layer(layer, form))
        want = jfn(jnp.asarray(q), *jpool, jnp.asarray(table), jnp.asarray(lengths),
                   jnp.asarray(offsets), layer=jnp.int32(layer), interpret=True)
        _assert_parts(got, want, seen=_seen(q_len))
        per_layer = fn(tq, *(p[layer] for p in pool), tt, tl, to)
        for a, b in zip(got, per_layer):
            assert torch.equal(a, b)


@pytest.mark.parametrize("layer", [3, -1, torch.tensor(1.0), torch.tensor([1])])
def test_stacked_layer_out_of_range_or_not_an_index_raises(layer):
    pool = torch.zeros((N_LAYERS, 2, 1, PAGE, 64))
    with pytest.raises((ValueError, TypeError)):
        cpa.cuda_paged_decode_attention_parts(
            torch.zeros((1, 2, 64)), pool, pool, torch.zeros((1, 1), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), layer=layer,
        )


def test_per_layer_pool_with_a_layer_raises():
    pool = torch.zeros((2, 1, PAGE, 64))
    with pytest.raises(ValueError, match="stacked"):
        cpa.cuda_paged_decode_attention_mq_parts(
            torch.zeros((1, 2, 2, 64)), pool, pool, torch.zeros((1, 1), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32), layer=0,
        )
