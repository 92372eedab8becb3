"""The port's plain multi-query paged parts (the plain versions of B7/B8)
against the JAX package's reference and its Pallas multi-query kernels
(interpret mode on the CPU).

Inputs come from a numpy seed: a pool whose pages are a shuffled
permutation (plus pages no row names), rows of 0–4 pages at page 128, and
offsets that cut inside the cached range (row 2's queries see 101–105 of
its 129 tokens, row 3's 291–295 of 300), one whose first query sees
nothing (offset -1) and one past its length (no cut). Q 1–5, G 1/4/6/8,
D 64/96/128/256. In float32 the parts agree to 1e-5 (the same f32 math
summed in another order over a few hundred keys); a query with no visible
token gives exactly (0, -inf, 0) in the plain versions and the JAX
reference (the Pallas kernels leave NaN there, so they are compared on
the other queries); at Q = 1 with every cached token visible the
multi-query versions equal the single-query ones bit for bit.
``tests/test_torch_kernels_cuda.py`` holds the CUDA kernels against these
plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.quantize import (
    quantize_kv_vector as jax_quantize_kv_vector,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_paged_attention as jpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import attention as tpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 128
LENGTHS = [0, 1, 129, 300, 512]  # an empty row, page edges, four pages
OFFSETS = [0, -1, 100, 290, 600]  # cuts in rows 1-3; none in row 4

# (Q, Hq, Hkv, D): G = Hq / Hkv of 6, 8, 4, 1 and 4
SHAPES = [(5, 12, 2, 128), (3, 8, 1, 64), (2, 4, 1, 96), (5, 2, 2, 256), (4, 8, 2, 128)]


def _inputs(seed, q_len, hq, hkv, d, lengths=LENGTHS):
    """q [B,Q,Hq,D], pools [P,Hkv,page,D], a scattered table [B,Jmax]
    whose entries past a row's need are 0, and lengths [B], as numpy."""
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
    q = rng.standard_normal((len(lengths), q_len, hq, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, hkv, PAGE, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, hkv, PAGE, d)).astype(np.float32)
    return q, k, v, table, np.asarray(lengths, dtype=np.int32)


def _lane_pad(x, d):
    """The JAX Pallas kernels take pools pre-padded to 128 lanes."""
    pad = (-d) % 128
    if not pad:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]  # writable copies


def _assert_parts(got, want, tol=TOL, seen=None):
    """``seen`` [B, Q] bool: compare only the queries that see a token."""
    for x, y in zip(got, want):
        x, y = np.asarray(x), np.asarray(y)
        if seen is not None:
            x, y = x[seen], y[seen]
        np.testing.assert_allclose(x, y, **tol)  # -inf == -inf


def _seen(q_len, lengths=LENGTHS, offsets=OFFSETS):
    """[B, Q]: whether query j of row b sees any cached token. The Pallas
    kernels leave NaN parts for a query that sees none in a row that is
    not empty (no engine path makes one: its candidates sit past the
    prompt); the reference and the port give (0, -inf, 0) there."""
    return np.array(
        [[min(n, off + j + 1) > 0 for j in range(q_len)] for n, off in zip(lengths, offsets)]
    )


def _assert_empty_queries(parts, lengths, offsets):
    """Every (row, query) with no visible token is exactly (0, -inf, 0),
    and every other one has l > 0."""
    acc, m, l = (x.numpy() for x in parts)
    for b, (n, off) in enumerate(zip(lengths, offsets)):
        for j in range(acc.shape[1]):
            if min(n, off + j + 1) <= 0:
                assert np.all(acc[b, j] == 0) and np.all(np.isneginf(m[b, j])) and np.all(l[b, j] == 0)
            else:
                assert np.all(l[b, j] > 0)


@pytest.mark.parametrize("q_len,hq,hkv,d", SHAPES)
def test_mq_parts_match_reference_and_pallas_kernel(q_len, hq, hkv, d):
    q, k, v, table, lengths = _inputs(0, q_len, hq, hkv, d)
    offsets = np.asarray(OFFSETS, dtype=np.int32)
    jargs = (jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(offsets))
    tq, tk, tv, tt, tl, to = _t(q, k, v, table, lengths, offsets)
    got = tpa.paged_mq_attention_reference(tq, tk, tv, tt, tl, to)
    assert got[0].shape == (len(LENGTHS), q_len, hkv, hq // hkv, d)
    want = jpa.paged_mq_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *jargs)
    _assert_parts(got, want)
    kernel = jpa.pallas_paged_decode_attention_mq_parts(
        jnp.asarray(q), _lane_pad(jnp.asarray(k), d), _lane_pad(jnp.asarray(v), d), *jargs,
        interpret=True,
    )
    _assert_parts(got, kernel, seen=_seen(q_len))
    _assert_empty_queries(got, LENGTHS, OFFSETS)
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(cpa.cuda_paged_decode_attention_mq_parts(tq, tk, tv, tt, tl, to), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("q_len,hq,hkv,d", SHAPES)
def test_int8_mq_parts_match_pallas_int8_kernel(q_len, hq, hkv, d):
    q, k, v, table, lengths = _inputs(1, q_len, hq, hkv, d)
    offsets = np.asarray(OFFSETS, dtype=np.int32)
    jkq, jks = jax_quantize_kv_vector(jnp.asarray(k))
    jvq, jvs = jax_quantize_kv_vector(jnp.asarray(v))
    jargs = (jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(offsets))
    kernel = jpa.pallas_paged_decode_attention_mq_parts_int8(
        jnp.asarray(q), _lane_pad(jkq, d), jks, _lane_pad(jvq, d), jvs, *jargs, interpret=True,
    )
    tq, tt, tl, to = _t(q, table, lengths, offsets)
    codes = _t(np.asarray(jkq), np.asarray(jks), np.asarray(jvq), np.asarray(jvs))
    got = tpa.paged_mq_attention_int8_reference(tq, *codes, tt, tl, to)
    _assert_parts(got, kernel, seen=_seen(q_len))
    _assert_empty_queries(got, LENGTHS, OFFSETS)
    # the same math as the reference on the dequantized pool; the scales
    # multiply scores and probabilities instead of K and V, so f32
    # rounding differs at about 1e-6 of |acc| <= ~30
    kf = np.asarray(jkq, np.float32) * np.asarray(jks)[..., None]
    vf = np.asarray(jvq, np.float32) * np.asarray(jvs)[..., None]
    want = jpa.paged_mq_attention_reference(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), *jargs)
    _assert_parts(got, want, dict(atol=1e-4, rtol=1e-5))
    for a, b in zip(cpa.cuda_paged_decode_attention_mq_parts_int8(tq, *codes, tt, tl, to), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hq,hkv,d", [(12, 2, 128), (8, 8, 96), (8, 1, 256), (4, 1, 64)])
def test_q1_equals_the_single_query_parts(hq, hkv, d):
    """At Q = 1 with every cached token visible (the decode mask) the
    multi-query plain versions are the single-query ones (B4/B5's), bit
    for bit."""
    q, k, v, table, lengths = _inputs(2, 1, hq, hkv, d)
    tq, tk, tv, tt, tl = _t(q, k, v, table, lengths)
    to = tl + 3  # offsets past the cached tokens
    mq = tpa.paged_mq_attention_reference(tq, tk, tv, tt, tl, to)
    single = tpa.paged_decode_attention_parts_reference(tq[:, 0], tk, tv, tt, tl)
    for a, b in zip(mq, single):
        assert torch.equal(a[:, 0], b)
    kq, ks = jax_quantize_kv_vector(jnp.asarray(k))
    vq, vs = jax_quantize_kv_vector(jnp.asarray(v))
    codes = _t(np.asarray(kq), np.asarray(ks), np.asarray(vq), np.asarray(vs))
    mq = tpa.paged_mq_attention_int8_reference(tq, *codes, tt, tl, to)
    single = tpa.paged_decode_attention_parts_int8_reference(tq[:, 0], *codes, tt, tl)
    for a, b in zip(mq, single):
        assert torch.equal(a[:, 0], b)


def test_mq_kernels_join_the_launch_counts():
    assert cpa.cuda_paged_decode_attention_mq_parts in cpa.KERNELS
    assert cpa.cuda_paged_decode_attention_mq_parts_int8 in cpa.KERNELS
    assert cpa.cuda_paged_decode_attention_mq_parts.launches >= 0  # CPU calls do not count
