"""The port's plain attention versions against the JAX package's references
and Pallas kernels (interpret mode on the CPU), and the CUDA wrappers'
CPU dispatch. The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py).

Tolerances: float32 inputs atol = rtol = 1e-5 (the same math summed in
another order); bfloat16 inputs 2e-2 (one bf16 rounding of the output,
|out| <= ~3, plus different rounding of intermediates between frameworks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.models.quantize import (
    quantize_kv_vector as jax_quantize_kv_vector,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import attention as jax_attn
from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops.pallas_attention import (
    pallas_decode_attention,
    pallas_decode_attention_int8,
    pallas_prefill_attention,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import attention as port_attn
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_attention
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

HEADS = [
    pytest.param(4, 2, id="gqa"),
    pytest.param(4, 1, id="mqa"),
    pytest.param(4, 4, id="mha"),
]
# GQA, MQA and MHA, each at one of the head dims 16, 96 and 128 (plus GQA
# at qwen2's 128), rather than the full cross product: the dims exercise
# no head-count-specific code.
CASES = [
    pytest.param(4, 2, 16, id="gqa-d16"),
    pytest.param(4, 1, 96, id="mqa-d96"),
    pytest.param(4, 4, 128, id="mha-d128"),
    pytest.param(4, 2, 128, id="gqa-d128"),
]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_jax(a, dtype):
    return jnp.asarray(a, dtype=dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _decode_inputs(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return (
        _normal(rng, (b, hq, d)),
        _normal(rng, (b, hkv, t, d)),
        _normal(rng, (b, hkv, t, d)),
    )


@pytest.mark.parametrize("hq,hkv,d", CASES)
def test_decode_reference_matches_pallas_and_jax_reference(hq, hkv, d):
    q, k, v = _decode_inputs(0, 2, hq, hkv, 64, d)
    lengths = np.array([9, 64], dtype=np.int32)  # per-row lengths
    port = port_attn.decode_attention_reference(
        *(_to_torch(a, torch.float32) for a in (q, k, v)), torch.from_numpy(lengths)
    )
    jq, jk, jv = (_to_jax(a, jnp.float32) for a in (q, k, v))
    pallas = pallas_decode_attention(jq, jk, jv, jnp.asarray(lengths), interpret=True)
    ref = jax_attn.decode_attention_reference(jq, jk, jv, jnp.asarray(lengths))
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)


def test_decode_reference_ignores_garbage_past_length():
    q, k, v = _decode_inputs(1, 1, 4, 2, 48, 16)
    lengths = torch.tensor([7], dtype=torch.int32)
    args = [_to_torch(a, torch.float32) for a in (q, k, v)]
    clean = port_attn.decode_attention_reference(*args, lengths)
    args[1][:, :, 7:] = 1e9
    args[2][:, :, 7:] = -1e9
    dirty = port_attn.decode_attention_reference(*args, lengths)
    np.testing.assert_allclose(dirty.numpy(), clean.numpy(), **F32_TOL)


def test_decode_reference_bf16_matches_pallas():
    q, k, v = _decode_inputs(2, 1, 8, 2, 128, 64)
    lengths = np.array([100], dtype=np.int32)
    port = port_attn.decode_attention_reference(
        *(_to_torch(a, torch.bfloat16) for a in (q, k, v)), torch.from_numpy(lengths)
    )
    pallas = pallas_decode_attention(
        *(_to_jax(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(lengths), interpret=True
    )
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(pallas, dtype=np.float32), **BF16_TOL
    )


@pytest.mark.parametrize("hq,hkv,d", CASES)
def test_decode_int8_reference_matches_pallas_int8(hq, hkv, d):
    q, k, v = _decode_inputs(3, 2, hq, hkv, 64, d)
    lengths = np.array([33, 50], dtype=np.int32)
    kq, ks = (np.array(a) for a in jax_quantize_kv_vector(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quantize_kv_vector(jnp.asarray(v)))
    port = port_attn.decode_attention_int8_reference(
        _to_torch(q, torch.float32),
        torch.from_numpy(kq), torch.from_numpy(ks),
        torch.from_numpy(vq), torch.from_numpy(vs),
        torch.from_numpy(lengths),
    )
    pallas = pallas_decode_attention_int8(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        jnp.asarray(lengths), interpret=True,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **F32_TOL)
    # and equal to plain decode over the dequantized cache (scales commute)
    deq = port_attn.decode_attention_reference(
        _to_torch(q, torch.float32),
        torch.from_numpy(kq).float() * torch.from_numpy(ks)[..., None],
        torch.from_numpy(vq).float() * torch.from_numpy(vs)[..., None],
        torch.from_numpy(lengths),
    )
    np.testing.assert_allclose(port.numpy(), deq.numpy(), **F32_TOL)


@pytest.mark.parametrize("hq,hkv,d", CASES)
@pytest.mark.parametrize("offset", [0, 24])
def test_prefill_cached_matches_pallas_prefill(hq, hkv, d, offset):
    rng = np.random.default_rng(4)
    s, t = 16, 64
    q = _normal(rng, (1, s, hq, d))
    k = _normal(rng, (1, hkv, t, d))
    v = _normal(rng, (1, hkv, t, d))
    port = port_attn.prefill_attention_cached(
        _to_torch(q, torch.float32), _to_torch(k, torch.float32), _to_torch(v, torch.float32), offset
    )
    pallas = pallas_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(offset),
        block_q=8, block_k=16, interpret=True,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), **F32_TOL)
    # garbage past the causal frontier changes nothing
    kd, vd = k.copy(), v.copy()
    kd[:, :, offset + s :] = 1e9
    vd[:, :, offset + s :] = -1e9
    dirty = port_attn.prefill_attention_cached(
        _to_torch(q, torch.float32), _to_torch(kd, torch.float32), _to_torch(vd, torch.float32), offset
    )
    np.testing.assert_allclose(dirty.numpy(), port.numpy(), **F32_TOL)


def test_prefill_cached_bf16_matches_pallas_prefill():
    rng = np.random.default_rng(5)
    q = _normal(rng, (1, 32, 8, 64))
    k = _normal(rng, (1, 2, 64, 64))
    v = _normal(rng, (1, 2, 64, 64))
    port = port_attn.prefill_attention_cached(
        *(_to_torch(a, torch.bfloat16) for a in (q, k, v)), 16
    )
    pallas = pallas_prefill_attention(
        *(_to_jax(a, jnp.bfloat16) for a in (q, k, v)), jnp.int32(16),
        block_q=16, block_k=32, interpret=True,
    )
    np.testing.assert_allclose(
        port.float().numpy(), np.asarray(pallas, dtype=np.float32), **BF16_TOL
    )


@pytest.mark.parametrize("hq,hkv", HEADS)
def test_prefill_attention_matches_jax_reference(hq, hkv):
    rng = np.random.default_rng(6)
    q = _normal(rng, (2, 12, hq, 16))
    k = _normal(rng, (2, 12, hkv, 16))
    v = _normal(rng, (2, 12, hkv, 16))
    port = port_attn.prefill_attention(*(_to_torch(a, torch.float32) for a in (q, k, v)))
    ref = jax_attn.prefill_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **F32_TOL)
    # the cached form at offset 0 over a cache of exactly the prompt agrees
    cached = port_attn.prefill_attention_cached(
        _to_torch(q, torch.float32),
        _to_torch(k, torch.float32).transpose(1, 2),
        _to_torch(v, torch.float32).transpose(1, 2),
        0,
    )
    np.testing.assert_allclose(cached.numpy(), port.numpy(), **F32_TOL)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    q, k, v = _decode_inputs(7, 1, 4, 2, 32, 16)
    tq, tk, tv = (_to_torch(a, torch.float32) for a in (q, k, v))
    lengths = torch.tensor([20], dtype=torch.int32)
    before = [fn.launches for fn in cuda_attention.KERNELS]
    torch.testing.assert_close(
        cuda_attention.cuda_decode_attention(tq, tk, tv, lengths),
        port_attn.decode_attention_reference(tq, tk, tv, lengths),
        rtol=0, atol=0,
    )
    kq, ks = (torch.from_numpy(np.array(a)) for a in jax_quantize_kv_vector(jnp.asarray(k)))
    torch.testing.assert_close(
        cuda_attention.cuda_decode_attention_int8(tq, kq, ks, kq, ks, lengths),
        port_attn.decode_attention_int8_reference(tq, kq, ks, kq, ks, lengths),
        rtol=0, atol=0,
    )
    qp = tq[None].expand(1, 4, 4, 16).reshape(1, 4, 4, 16).contiguous()
    torch.testing.assert_close(
        cuda_attention.cuda_prefill_attention(qp, tk, tv, 3),
        port_attn.prefill_attention_cached(qp, tk, tv, 3),
        rtol=0, atol=0,
    )
    assert [fn.launches for fn in cuda_attention.KERNELS] == before
