"""The port's plain paged-attention parts against the JAX package's Pallas
parts kernels (interpret mode on the CPU).

Inputs come from a numpy seed: a pool whose pages are a shuffled
permutation, with extra pages no row names, GQA and MHA groups, head dims
16, 96 and 128, and one row with no cached token. In float32 the parts
agree to 1e-5 (the same f32 math summed in another order over a few
hundred keys); the zero-length row gives exactly (0, -inf, 0); and
``acc / l`` equals the normalised ``paged_decode_attention_reference``.
The wrappers of ``ops/cuda_paged_attention.py`` take these plain versions
for CPU tensors; ``tests/test_torch_kernels_cuda.py`` holds the CUDA
kernels against them on the card.
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
LENGTHS = [0, 1, 129, 300]  # an empty row, page edges, three pages


def _inputs(seed, hq, hkv, d, lengths=LENGTHS):
    """q [B,Hq,D], pools [P,Hkv,page,D], a scattered table [B,Jmax] whose
    entries past a row's need are 0, and lengths [B], as numpy."""
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
    q = rng.standard_normal((len(lengths), hq, d)).astype(np.float32)
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
    return [torch.from_numpy(np.array(a)) for a in arrays]  # a writable copy


def _assert_parts(got, want):
    acc, m, l = (np.asarray(x) for x in got)
    acc_w, m_w, l_w = (np.asarray(x) for x in want)
    np.testing.assert_allclose(acc, acc_w, **TOL)
    np.testing.assert_allclose(l, l_w, **TOL)
    np.testing.assert_allclose(m, m_w, **TOL)  # -inf == -inf on the empty row


def _assert_empty_row(parts, row=0):
    acc, m, l = (x.numpy() for x in parts)
    assert np.all(acc[row] == 0) and np.all(np.isneginf(m[row])) and np.all(l[row] == 0)


SHAPES = [(4, 2, 16), (8, 2, 96), (4, 4, 128), (12, 2, 128)]  # GQA and MHA


@pytest.mark.parametrize("hq,hkv,d", SHAPES)
def test_parts_match_pallas_parts_kernel(hq, hkv, d):
    q, k, v, table, lengths = _inputs(0, hq, hkv, d)
    want = jpa.pallas_paged_decode_attention_parts(
        jnp.asarray(q), _lane_pad(jnp.asarray(k), d), _lane_pad(jnp.asarray(v), d),
        jnp.asarray(table), jnp.asarray(lengths), interpret=True,
    )
    tq, tk, tv, tt, tl = _t(q, k, v, table, lengths)
    got = tpa.paged_decode_attention_parts_reference(tq, tk, tv, tt, tl)
    _assert_parts([x.numpy() for x in got], want)
    _assert_empty_row(got)
    # the wrapper takes the plain version for CPU tensors
    via_wrapper = cpa.cuda_paged_decode_attention_parts(tq, tk, tv, tt, tl)
    for a, b in zip(via_wrapper, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hq,hkv,d", SHAPES)
def test_int8_parts_match_pallas_int8_parts_kernel(hq, hkv, d):
    q, k, v, table, lengths = _inputs(1, hq, hkv, d)
    jkq, jks = jax_quantize_kv_vector(jnp.asarray(k))
    jvq, jvs = jax_quantize_kv_vector(jnp.asarray(v))
    want = jpa.pallas_paged_decode_attention_parts_int8(
        jnp.asarray(q), _lane_pad(jkq, d), jks, _lane_pad(jvq, d), jvs,
        jnp.asarray(table), jnp.asarray(lengths), interpret=True,
    )
    tq, tt, tl = _t(q, table, lengths)
    codes = _t(np.asarray(jkq), np.asarray(jks), np.asarray(jvq), np.asarray(jvs))
    got = tpa.paged_decode_attention_parts_int8_reference(tq, *codes, tt, tl)
    _assert_parts([x.numpy() for x in got], want)
    _assert_empty_row(got)
    via_wrapper = cpa.cuda_paged_decode_attention_parts_int8(tq, *codes, tt, tl)
    for a, b in zip(via_wrapper, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hq,hkv,d", SHAPES)
def test_normalised_parts_equal_paged_reference(hq, hkv, d):
    lengths = [5, 1, 129, 300]  # every row cached: acc / l is defined
    q, k, v, table, lens = _inputs(2, hq, hkv, d, lengths)
    tq, tk, tv, tt, tl = _t(q, k, v, table, lens)
    acc, _, l = tpa.paged_decode_attention_parts_reference(tq, tk, tv, tt, tl)
    out = (acc / l[..., None]).reshape(len(lengths), hq, d)
    want = jpa.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), jnp.asarray(lens)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tpa.paged_decode_attention_reference(tq, tk, tv, tt, tl).numpy(), np.asarray(want), **TOL
    )


def test_table_entries_are_clipped_to_the_pool():
    """Entries outside [0, P-1] read the nearest page, as the JAX wrappers'
    clip does; a row's entries past its length are never read."""
    q, k, v, table, lengths = _inputs(3, 4, 2, 16, [200, 100])
    table[1, 1] = 10_000  # past row 1's need: unread whatever it names
    wild = table.copy()
    wild[0, 1] = 10_000  # clipped to the last page
    clipped = table.copy()
    clipped[0, 1] = k.shape[0] - 1
    tq, tk, tv, tl = _t(q, k, v, lengths)
    a = tpa.paged_decode_attention_parts_reference(tq, tk, tv, *_t(wild), tl)
    b = tpa.paged_decode_attention_parts_reference(tq, tk, tv, *_t(clipped), tl)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
