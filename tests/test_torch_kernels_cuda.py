"""The CUDA kernels against their plain versions, on the card.

Skips without a CUDA device: the kernels have no CPU mode. This file
imports no jax, so it also runs where JAX is absent; the suite's
conftest.py imports jax, so on such a machine run it as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The sharded engine's shard shapes (``SHARD_HEADS``, ``SHARD_MATMULS``)
run in the parametrizations beside the unsharded ones, and a row-sharded
int4 ``w_down`` (each shard's rows repacked) sums to the whole leaf's
product. Tolerances: float32 1e-4 (f32 math summed in another order over up to a
few hundred keys); bfloat16 2e-2 (both round one f32 result to bf16, so
they differ by about one bf16 ulp of |out| <= 4); the multi-query
tensor-core kernel (B7/B8 with a bf16 q) 5e-3 (it rounds each p, the V
scale folded in, to bf16 for the P·V product: a relative error of at
most 2^-9 a term, so acc/l moves by at most about 2^-9 · max|v|, within
atol + rtol · |acc/l|); the w4a8 kernel none (its sums are integers, so
it equals its plain version bit for bit).
"""

import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import (
    quantize_kv_vector,
    quantize_tensor_int4,
    quantize_tensor_int4_i32,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import attention as port_attn
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import _kernels, cuda_attention
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import quant as port_quant

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
MQ_MMA_TOL = dict(atol=5e-3, rtol=5e-3)
# The sharded engine's shapes (parallel/tp.py at tp 2): a shard of
# qwen2:1.5b runs 6 query heads over 1 KV head and mixtral:8x7b's 16 over
# 4; qwen2's int4 shard matmuls (M 1) are F/2 columns of w_gate, F/2 rows
# of w_down (repacked), 6 heads of wq and wo, 1 of wk.
SHARD_HEADS = [(6, 1, 128), (16, 4, 128)]
SHARD_MATMULS = [(1, 1536, 4480), (1, 4480, 1536), (1, 1536, 768), (1, 768, 1536), (1, 1536, 128)]
# The trained tiny LM's heads (models/tiny_lm.py): 4 query heads over 2 KV
# heads of width 32, which B1-B8 take natively.
TINY_LM_HEADS = [(4, 2, 32)]
# The .tiny() configs' heads (models/config.py): width 16, which B1-B8 take
# natively too (at D 16 the decode body gives a half-warp a position):
# qwen2:1.5b's 4 query heads over 2 KV heads, gemma:2b's 8 over 1.
TINY_D16_HEADS = [(4, 2, 16), (8, 1, 16)]


def _to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _junk_past_frontiers(table, lengths, page, n_pool):
    """``table`` with every entry past a row's pages replaced by junk,
    inside and outside [0, P)."""
    gen = torch.Generator(device=table.device).manual_seed(7)
    need = torch.tensor([-(-n // page) for n in lengths], device=table.device)
    junk = torch.randint(-n_pool - 5, 2 * n_pool + 5, table.shape, generator=gen,
                         device=table.device, dtype=torch.int32)
    cols = torch.arange(table.shape[1], device=table.device)
    return torch.where(cols[None, :] < need[:, None], table, junk)


def _page_constant(pool):
    """A V pool ``[P,Hkv,page,D]`` like ``pool`` whose rows are constant
    over each (page, kv head), one of nine values in [-1, 1] (exact in
    bf16): acc/l is then a mix of the constants of the pages a query
    reads, so a tile read from a wrong page moves it by about its weight."""
    n_pool, hkv = pool.shape[:2]
    p = torch.arange(n_pool, device=pool.device)[:, None]
    h = torch.arange(hkv, device=pool.device)[None, :]
    c = ((3 * p + 5 * h) % 9 - 4).float() / 4
    return c[:, :, None, None].expand(pool.shape).to(pool.dtype).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,d", [(12, 2, 128), (32, 32, 96), (8, 1, 256), (4, 4, 64), *SHARD_HEADS,
                                      *TINY_LM_HEADS, *TINY_D16_HEADS])
def test_kernels_match_plain_versions_on_the_card(dtype, tol, hq, hkv, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(8)
    dev = "cuda"
    t, s, offset = 300, 70, 100
    q = _to_torch(_normal(rng, (2, hq, d)), dtype).to(dev)
    k = _to_torch(_normal(rng, (2, hkv, t, d)), dtype).to(dev)
    v = _to_torch(_normal(rng, (2, hkv, t, d)), dtype).to(dev)
    lengths = torch.tensor([37, 300], dtype=torch.int32, device=dev)
    out = cuda_attention.cuda_decode_attention(q, k, v, lengths)
    ref = port_attn.decode_attention_reference(q, k, v, lengths)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    out = cuda_attention.cuda_decode_attention_int8(q, kq, ks, vq, vs, lengths)
    ref = port_attn.decode_attention_int8_reference(q, kq, ks, vq, vs, lengths)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    qp = _to_torch(_normal(rng, (2, s, hq, d)), dtype).to(dev)
    out = cuda_attention.cuda_prefill_attention(qp, k, v, offset)
    ref = port_attn.prefill_attention_cached(qp, k, v, offset)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.cuda.synchronize()


def _paged_inputs(rng, dtype, b, hq, hkv, d, page, lengths, dev):
    """A shuffled pool holding each row's pages, its table (entries past a
    row's need are 0) and q, all on ``dev``."""
    need = [-(-n // page) for n in lengths]
    jmax = max(max(need), 1)
    n_pool = sum(need) + 3
    perm = rng.permutation(n_pool)
    table = np.zeros((b, jmax), dtype=np.int32)
    pos = 0
    for r, k in enumerate(need):
        table[r, :k] = perm[pos : pos + k]
        pos += k
    q = _to_torch(_normal(rng, (b, hq, d)), dtype).to(dev)
    k = _to_torch(_normal(rng, (n_pool, hkv, page, d)), dtype).to(dev)
    v = _to_torch(_normal(rng, (n_pool, hkv, page, d)), dtype).to(dev)
    return (q, k, v, torch.from_numpy(table).to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _assert_parts_close(got, want, tol):
    acc, m, l = got
    acc_r, m_r, l_r = want
    empty = l_r == 0
    # a zero-length row is exactly (0, -inf, 0)
    assert torch.equal(empty, l == 0)
    assert torch.all(torch.isneginf(m[empty])) and torch.all(acc[empty] == 0)
    live = ~empty
    torch.testing.assert_close(m[live], m_r[live], **tol)
    torch.testing.assert_close(l[live], l_r[live], **tol)
    torch.testing.assert_close(
        (acc / l[..., None])[live], (acc_r / l_r[..., None])[live], **tol
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,d", [(12, 2, 128), (32, 32, 96), (8, 1, 256), (4, 4, 64), *SHARD_HEADS,
                                      *TINY_LM_HEADS, *TINY_D16_HEADS])
def test_paged_parts_kernels_match_plain_versions_on_the_card(dtype, tol, hq, hkv, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(9)
    lengths = [0, 1, 129, 300, 1100]  # an empty row, page edges, several pages
    q, k, v, table, lens = _paged_inputs(rng, dtype, len(lengths), hq, hkv, d, 128, lengths, "cuda")
    got = cpa.cuda_paged_decode_attention_parts(q, k, v, table, lens)
    want = port_attn.paged_decode_attention_parts_reference(q, k, v, table, lens)
    _assert_parts_close(got, want, tol)
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    got = cpa.cuda_paged_decode_attention_parts_int8(q, kq, ks, vq, vs, table, lens)
    want = port_attn.paged_decode_attention_parts_int8_reference(q, kq, ks, vq, vs, table, lens)
    _assert_parts_close(got, want, tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize(
    "m,in_dim,out_dim",
    [(1, 1536, 256), (8, 1536, 8960), (5, 8960, 1536), (1, 4096, 1024), (8, 4096, 4096),
     (8, 96, 200), (3, 64, 7), (2, 16, 128), *SHARD_MATMULS],
)
def test_int4_kernels_match_plain_versions_on_the_card(dtype, tol, m, in_dim, out_dim):
    """B9 and B10 against their plain versions; weights at the model's
    1/sqrt(IN) scale so that outputs are O(1); OUT 200 and 7 exercise the
    column edge and the byte-wise loads, IN 16 a single K split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(10)
    w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
    x = _to_torch(_normal(rng, (m, in_dim)), dtype).cuda()
    leaf = quantize_tensor_int4(w)
    out = cuda_quant.cuda_int4_matmul(x, leaf["q4"], leaf["s"])
    ref = port_quant.int4_matmul_reference(x, leaf["q4"], leaf["s"])
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    leaf = quantize_tensor_int4_i32(w)
    out = cuda_quant.cuda_int4_matmul_i32(x, leaf["q32"], leaf["s"])
    ref = port_quant.int4_matmul_i32_reference(x, leaf["q32"], leaf["s"])
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    with pytest.raises(ValueError, match="rows"):
        cuda_quant.cuda_int4_matmul_i32(torch.zeros((9, in_dim), device="cuda"), leaf["q32"], leaf["s"])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, MQ_MMA_TOL)])
@pytest.mark.parametrize(
    "q_len,hq,hkv,d",
    [(5, 12, 2, 128), (3, 32, 32, 96), (5, 8, 1, 256), (9, 4, 1, 64), (9, 8, 1, 256),
     *[(5, *heads) for heads in SHARD_HEADS + TINY_LM_HEADS + TINY_D16_HEADS]],
)
def test_paged_mq_parts_kernels_match_plain_versions_on_the_card(dtype, tol, q_len, hq, hkv, d):
    """B7 and B8 against their plain versions, with offsets that cut inside
    the cached range (row 2's queries see 101–105 of its 129 tokens), a
    first query that sees nothing (row 1, offset -1) and an empty row; at
    Q = 1 each equals B4/B5 on lengths cut to the causal limit, bit for
    bit; Q 10 and 17 (past the f32 kernel's limit of 9: chunks; one launch
    of the bf16 tensor-core kernel) match the plain version too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(11)
    lengths = [0, 1, 129, 300, 1100]
    offsets = torch.tensor([0, -1, 100, 290, 1100], dtype=torch.int32, device="cuda")
    _, k, v, table, lens = _paged_inputs(rng, dtype, len(lengths), hq, hkv, d, 128, lengths, "cuda")
    q = _to_torch(_normal(rng, (len(lengths), q_len, hq, d)), dtype).cuda()
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    pools = {
        "bf16": (cpa.cuda_paged_decode_attention_mq_parts, port_attn.paged_mq_attention_reference,
                 cpa.cuda_paged_decode_attention_parts, (k, v)),
        "int8": (cpa.cuda_paged_decode_attention_mq_parts_int8, port_attn.paged_mq_attention_int8_reference,
                 cpa.cuda_paged_decode_attention_parts_int8, (kq, ks, vq, vs)),
    }
    for fn, ref_fn, single, pool in pools.values():
        got = fn(q, *pool, table, lens, offsets)
        assert got[0].shape == (len(lengths), q_len, hkv, hq // hkv, d)
        _assert_parts_close(got, ref_fn(q, *pool, table, lens, offsets), tol)
        one = fn(q[:, :1].contiguous(), *pool, table, lens, offsets)
        cut = torch.clamp(torch.minimum(lens, offsets + 1), min=0)
        for a, b in zip(one, single(q[:, 0].contiguous(), *pool, table, cut)):
            assert torch.equal(a[:, 0], b)
        for long_q in (10, 17):  # past the kernel's 9: the wrapper launches chunks
            ql = _to_torch(_normal(rng, (len(lengths), long_q, hq, d)), dtype).cuda()
            got = fn(ql, *pool, table, lens, offsets)
            assert got[0].shape == (len(lengths), long_q, hkv, hq // hkv, d)
            _assert_parts_close(got, ref_fn(ql, *pool, table, lens, offsets), tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,d", [(12, 2, 128), (32, 32, 96), (8, 1, 256), (4, 4, 64), *SHARD_HEADS,
                                      *TINY_LM_HEADS, *TINY_D16_HEADS])
def test_paged_decode_kernel_matches_plain_version_on_the_card(dtype, tol, hq, hkv, d):
    """B6 against its plain version, rows at, before and after a page edge
    and over several pages, with junk table entries (outside the pool)
    past every frontier; and within the same tolerance of B4's acc / l
    (both run the one-launch body; B4 writes its parts in f32 where B6
    rounds acc / l to q's dtype)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(12)
    lengths = [1, 127, 128, 129, 1100]
    q, k, v, table, lens = _paged_inputs(rng, dtype, len(lengths), hq, hkv, d, 128, lengths, "cuda")
    table = _junk_past_frontiers(table, lengths, 128, k.shape[0])
    out = cpa.cuda_paged_decode_attention(q, k, v, table, lens)
    assert out.dtype == dtype and out.shape == q.shape
    ref = port_attn.paged_decode_attention_reference(q, k, v, table, lens)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    acc, _, l = cpa.cuda_paged_decode_attention_parts(q, k, v, table, lens)
    torch.testing.assert_close(out.float(), (acc / l[..., None]).reshape(q.shape), **tol)
    torch.cuda.synchronize()


W4A8_CASES = [  # (M, IN, OUT)
    (8, 1536, 8960), (8, 4096, 14336), (8, 256, 640), (3, 512, 130), (1, 256, 7),
    (2, 256, 7), (5, 256, 7), (8, 256, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,in_dim,out_dim", W4A8_CASES)
def test_w4a8_kernel_equals_plain_version_on_the_card(dtype, m, in_dim, out_dim):
    """B11 against its plain version bit for bit (the kernel quantizes x
    as the plain torch ops do, its integer sums are exact, and both apply
    the two scales in one order): the probe's shape, llama3.1:8b's
    w_gate, one OUT past the 512-column block, OUT 130 and 7 through the
    byte-wise loads, at M 1, 2, 3, 5 and 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(13)
    w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
    x = _to_torch(_normal(rng, (m, in_dim)), dtype).cuda()
    leaf = quantize_tensor_int4(w)
    out = cuda_quant.cuda_w4a8_matmul(x, leaf["q4"], leaf["s"])
    ref = port_quant.w4a8_matmul_reference(x, leaf["q4"], leaf["s"])
    assert out.dtype == torch.float32 and out.shape == (m, out_dim)
    assert torch.equal(out, ref), (out - ref).abs().max().item()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,in_dim,out_dim", [(8, 1536, 8960), (1, 256, 7), (5, 4096, 130)])
def test_w4a8_kernel_zero_row_on_the_card(dtype, m, in_dim, out_dim):
    """A zero row of x (0/0 in the kernel's quantization, code 0) gives an
    output row of exact zeros, the other rows unchanged, bit for bit
    against the plain version; a row of ties (x/sx = k + 0.5 exactly) is
    rounded to even as the plain version rounds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(17)
    w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
    x = _to_torch(_normal(rng, (m, in_dim)), dtype).cuda()
    x[m // 2] = 0
    if m > 2:  # max 127 (sx = 1), then the ties ±0.5, ±1.5, ±2.5, ...
        ties = torch.arange(in_dim, device="cuda") % 16 - 7.5
        ties[0] = 127
        x[m - 1] = ties.to(dtype)
    leaf = quantize_tensor_int4(w)
    out = cuda_quant.cuda_w4a8_matmul(x, leaf["q4"], leaf["s"])
    ref = port_quant.w4a8_matmul_reference(x, leaf["q4"], leaf["s"])
    assert torch.equal(out, ref), (out - ref).abs().max().item()
    assert not out[m // 2].any()
    torch.cuda.synchronize()


PREFILL_CASES = [  # (S, offset, B)
    (s, off, b) for s in (1, 7, 63, 65, 130) for off in (0, 100, 2048) for b in (1, 3)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("group", [1, 6, 8])
def test_prefill_kernel_matches_plain_version_on_the_card(dtype, tol, d, group):
    """B1 (bf16: the tensor-core kernel, with its key splits where the
    blocks are few; f32: the CUDA-core kernel) against its plain version at
    S 1, 7, 63, 65 and 130, offsets 0, 100 and 2048, B 1 and 3, over a
    cache with 37 positions of slack past the chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(14)
    hkv = 2
    for s, offset, b in PREFILL_CASES:
        t = offset + s + 37
        q = _to_torch(_normal(rng, (b, s, hkv * group, d)), dtype).cuda()
        k = _to_torch(_normal(rng, (b, hkv, t, d)), dtype).cuda()
        v = _to_torch(_normal(rng, (b, hkv, t, d)), dtype).cuda()
        out = cuda_attention.cuda_prefill_attention(q, k, v, offset)
        ref = port_attn.prefill_attention_cached(q, k, v, offset)
        assert out.dtype == dtype and out.shape == q.shape
        torch.testing.assert_close(out.float(), ref.float(), **tol, msg=f"S {s} offset {offset} B {b}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("hq,hkv,d", [(12, 2, 128), (32, 32, 96), (8, 1, 256), (4, 4, 64), *SHARD_HEADS,
                                      *TINY_LM_HEADS, *TINY_D16_HEADS])
def test_decode_kernels_at_split_edges_match_plain_versions_on_the_card(dtype, tol, hq, hkv, d):
    """B2 and B3 against their plain versions at lengths 1, 63, 64, 65, 2100
    and the capacity T (one row each, so the kernel sizes one, one, one,
    two and many splits from the row), then a B 4 batch with a row of
    length 1 beside long rows; the kernel's tickets stay zero after every
    call (the last split of each row resets its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(15)
    t = 2200
    cases = [[n] for n in (1, 63, 64, 65, 2100, t)] + [[1, 300, 2100, t]]
    for lengths in cases:
        b = len(lengths)
        q = _to_torch(_normal(rng, (b, hq, d)), dtype).cuda()
        k = _to_torch(_normal(rng, (b, hkv, t, d)), dtype).cuda()
        v = _to_torch(_normal(rng, (b, hkv, t, d)), dtype).cuda()
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        out = cuda_attention.cuda_decode_attention(q, k, v, lens)
        ref = port_attn.decode_attention_reference(q, k, v, lens)
        torch.testing.assert_close(out.float(), ref.float(), **tol, msg=f"lengths {lengths}")
        kq, ks = quantize_kv_vector(k)
        vq, vs = quantize_kv_vector(v)
        out = cuda_attention.cuda_decode_attention_int8(q, kq, ks, vq, vs, lens)
        ref = port_attn.decode_attention_int8_reference(q, kq, ks, vq, vs, lens)
        torch.testing.assert_close(out.float(), ref.float(), **tol, msg=f"int8 lengths {lengths}")
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[q.device]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_group_above_a_kernel_cap_runs_in_sub_groups_on_the_card(dtype, tol):
    """G 16 (past the decode kernels' 8) through B2/B3, B4/B5, B6 and
    B7/B8, and G 128 (past the prefill block's 64 rows) through B1: each
    wrapper launches sub-groups against the same cache or pool and matches
    the plain version, which has no cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(16)
    hq, hkv, d, t = 32, 2, 128, 700
    q = _to_torch(_normal(rng, (2, hq, d)), dtype).cuda()
    k = _to_torch(_normal(rng, (2, hkv, t, d)), dtype).cuda()
    v = _to_torch(_normal(rng, (2, hkv, t, d)), dtype).cuda()
    lens = torch.tensor([5, 700], dtype=torch.int32, device="cuda")
    before = cuda_attention.cuda_decode_attention.launches
    out = cuda_attention.cuda_decode_attention(q, k, v, lens)
    assert cuda_attention.cuda_decode_attention.launches == before + 2
    torch.testing.assert_close(out.float(), port_attn.decode_attention_reference(q, k, v, lens).float(), **tol)
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    out = cuda_attention.cuda_decode_attention_int8(q, kq, ks, vq, vs, lens)
    ref = port_attn.decode_attention_int8_reference(q, kq, ks, vq, vs, lens)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    qp = _to_torch(_normal(rng, (1, 3, 128, 64)), dtype).cuda()
    kp = _to_torch(_normal(rng, (1, 1, 40, 64)), dtype).cuda()
    vp = _to_torch(_normal(rng, (1, 1, 40, 64)), dtype).cuda()
    out = cuda_attention.cuda_prefill_attention(qp, kp, vp, 30)
    torch.testing.assert_close(out.float(), port_attn.prefill_attention_cached(qp, kp, vp, 30).float(), **tol)

    lengths = [0, 129, 1100]
    offsets = torch.tensor([0, 100, 1100], dtype=torch.int32, device="cuda")
    q1, kpool, vpool, table, plens = _paged_inputs(rng, dtype, 3, hq, hkv, d, 128, lengths, "cuda")
    _assert_parts_close(cpa.cuda_paged_decode_attention_parts(q1, kpool, vpool, table, plens),
                        port_attn.paged_decode_attention_parts_reference(q1, kpool, vpool, table, plens), tol)
    kq, ks = quantize_kv_vector(kpool)
    vq, vs = quantize_kv_vector(vpool)
    _assert_parts_close(
        cpa.cuda_paged_decode_attention_parts_int8(q1, kq, ks, vq, vs, table, plens),
        port_attn.paged_decode_attention_parts_int8_reference(q1, kq, ks, vq, vs, table, plens), tol)
    full = plens + 1
    out = cpa.cuda_paged_decode_attention(q1, kpool, vpool, table, full)
    ref = port_attn.paged_decode_attention_reference(q1, kpool, vpool, table, full)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    qm = _to_torch(_normal(rng, (3, 5, hq, d)), dtype).cuda()
    _assert_parts_close(
        cpa.cuda_paged_decode_attention_mq_parts(qm, kpool, vpool, table, plens, offsets),
        port_attn.paged_mq_attention_reference(qm, kpool, vpool, table, plens, offsets), tol)
    _assert_parts_close(
        cpa.cuda_paged_decode_attention_mq_parts_int8(qm, kq, ks, vq, vs, table, plens, offsets),
        port_attn.paged_mq_attention_int8_reference(qm, kq, ks, vq, vs, table, plens, offsets), tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_layer_form_equals_the_per_layer_call_on_the_card(dtype):
    """The four parts wrappers on a stacked [L,P,Hkv,page,D] pool with
    ``layer=`` (an int and a 0-d tensor) equal the call on that layer's
    pool bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(17)
    hq, hkv, d, n_layers = 12, 2, 128, 3
    lengths = [1, 300, 1100]
    offsets = torch.tensor([1, 290, 1100], dtype=torch.int32, device="cuda")
    q, k, v, table, lens = _paged_inputs(rng, dtype, 3, hq, hkv, d, 128, lengths, "cuda")
    ks_ = torch.stack([k] + [torch.randn_like(k) for _ in range(n_layers - 1)])
    vs_ = torch.stack([v] + [torch.randn_like(v) for _ in range(n_layers - 1)])
    kq, ksc = quantize_kv_vector(ks_)
    vq, vsc = quantize_kv_vector(vs_)
    qm = _to_torch(_normal(rng, (3, 5, hq, d)), dtype).cuda()
    for layer in range(n_layers):
        for form in (layer, torch.tensor(layer, device="cuda")):
            pairs = [
                (cpa.cuda_paged_decode_attention_parts(q, ks_, vs_, table, lens, layer=form),
                 cpa.cuda_paged_decode_attention_parts(q, ks_[layer], vs_[layer], table, lens)),
                (cpa.cuda_paged_decode_attention_parts_int8(q, kq, ksc, vq, vsc, table, lens, layer=form),
                 cpa.cuda_paged_decode_attention_parts_int8(q, kq[layer], ksc[layer], vq[layer],
                                                            vsc[layer], table, lens)),
                (cpa.cuda_paged_decode_attention_mq_parts(qm, ks_, vs_, table, lens, offsets, layer=form),
                 cpa.cuda_paged_decode_attention_mq_parts(qm, ks_[layer], vs_[layer], table, lens, offsets)),
                (cpa.cuda_paged_decode_attention_mq_parts_int8(qm, kq, ksc, vq, vsc, table, lens, offsets,
                                                               layer=form),
                 cpa.cuda_paged_decode_attention_mq_parts_int8(qm, kq[layer], ksc[layer], vq[layer],
                                                               vsc[layer], table, lens, offsets)),
            ]
            for got, want in pairs:
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_prefill_kernel_runs_on_the_tensor_cores():
    """The built attention library's SASS: the bf16 prefill kernel issues
    HMMA (mma.sync) instructions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import subprocess
    from pathlib import Path

    _kernels.library("attention")
    cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_kernels.library_path("attention"))],
        capture_output=True, text=True, check=True,
    ).stdout
    functions = sass.split("Function : ")[1:]
    prefill = [f for f in functions if "prefill_mma_kernel" in f.splitlines()[0]]
    assert len(prefill) == 6, [f.splitlines()[0] for f in functions]  # D 16, 32, 64, 96, 128, 256
    for body in prefill:
        assert "HMMA" in body, body.splitlines()[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("page", [16, 48, 128])
@pytest.mark.parametrize("hq,hkv,d", [(12, 2, 128), (8, 1, 256)])
def test_paged_decode_kernel_at_page_sizes_on_the_card(dtype, tol, page, hq, hkv, d):
    """B6 at pages of 16 and 48 positions (not multiples of the kernel's
    32-position tile: each position looks its page up) and 128 (a tile
    stays in one page), rows of 0 to 2,100 tokens whose splits cut pages,
    junk table entries past every frontier and a table wider than any row
    needs; a zero-length row gives NaN, as the plain version does. The
    kernel's tickets stay zero after every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(16)
    lengths = [1, 47, 49, 200, 2100, 0]
    q, k, v, table, lens = _paged_inputs(rng, dtype, len(lengths), hq, hkv, d, page, lengths, "cuda")
    table = torch.cat([table, torch.zeros_like(table[:, :3])], dim=1)  # wider than any row needs
    table = _junk_past_frontiers(table, lengths, page, k.shape[0])
    out = cpa.cuda_paged_decode_attention(q, k, v, table, lens)
    ref = port_attn.paged_decode_attention_reference(q, k, v, table, lens)
    assert torch.all(torch.isnan(out[-1])) and torch.all(torch.isnan(ref[-1]))
    torch.testing.assert_close(out[:-1].float(), ref[:-1].float(), **tol)
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[q.device]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize(
    "in_dim,out_dim",
    [(96, 200), (64, 7), (16, 128), (1536, 256), (8960, 1536)],
)
def test_int4_kernel_at_every_row_count_on_the_card(dtype, tol, in_dim, out_dim):
    """B9 at every M from 1 to 8: OUT 200 and 7 exercise the column edge
    and the byte-wise loads, IN 16 a single k-step, qwen2's wk (1536 →
    256) and w_down (8960 → 1536) the packed rows split over blocks and
    merged by the last one to arrive. Its tickets stay zero after every
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(17)
    w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
    leaf = quantize_tensor_int4(w)
    for m in range(1, 9):
        x = _to_torch(_normal(rng, (m, in_dim)), dtype).cuda()
        out = cuda_quant.cuda_int4_matmul(x, leaf["q4"], leaf["s"])
        ref = port_quant.int4_matmul_reference(x, leaf["q4"], leaf["s"])
        assert out.dtype == dtype and out.shape == (m, out_dim)
        torch.testing.assert_close(out.float(), ref.float(), **tol, msg=f"M {m}")
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[x.device]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_launch_kernels_repeat_their_bits_on_the_card(dtype):
    """Two back-to-back calls of B6 (rows split over many blocks) and of B9
    (split packed rows) on the same inputs give the same bits: the last
    block of each group finds its ticket reset by the call before, and
    adds the splits in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(18)
    lengths = [300, 2100, 1100, 62]
    q, k, v, table, lens = _paged_inputs(rng, dtype, len(lengths), 12, 2, 128, 128, lengths, "cuda")
    first = cpa.cuda_paged_decode_attention(q, k, v, table, lens)
    assert torch.equal(first, cpa.cuda_paged_decode_attention(q, k, v, table, lens))
    for in_dim, out_dim in ((1536, 256), (8960, 1536), (1536, 8960)):
        w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
        leaf = quantize_tensor_int4(w)
        x = _to_torch(_normal(rng, (8, in_dim)), dtype).cuda()
        first = cuda_quant.cuda_int4_matmul(x, leaf["q4"], leaf["s"])
        assert torch.equal(first, cuda_quant.cuda_int4_matmul(x, leaf["q4"], leaf["s"]))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_int4_kernel_runs_on_the_tensor_cores():
    """The built int4 library's SASS: B9's kernel issues HMMA (mma.sync)
    instructions, in each of its instantiations (bf16 and f32 x, vector
    and byte-wise loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import subprocess
    from pathlib import Path

    _kernels.library("int4_matmul")
    cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_kernels.library_path("int4_matmul"))],
        capture_output=True, text=True, check=True,
    ).stdout
    functions = sass.split("Function : ")[1:]
    mma = [f for f in functions if "int4_mma_kernel" in f.splitlines()[0]]
    assert len(mma) == 4, [f.splitlines()[0] for f in functions]
    for body in mma:
        assert "HMMA" in body, body.splitlines()[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize(
    "in_dim,out_dim",
    [(96, 200), (64, 7), (16, 128), (1536, 256), (1536, 8960), (8960, 1536), (4096, 1024), (14336, 4096)],
)
def test_int4_i32_kernel_at_every_row_count_on_the_card(dtype, tol, in_dim, out_dim):
    """B10 (the tensor-core kernel over int32 lanes) at every M from 1 to
    8: OUT 200 and 7 exercise the column edge and the byte-wise loads, IN
    16 and 64 less than one k-step, qwen2's and llama's projections the
    packed rows split over blocks (up to llama's w_down, 7 splits of 256
    rows) and merged by the last one to arrive. One launch a call, two
    calls give the same bits, and its tickets stay zero after every
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(19)
    w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
    leaf = quantize_tensor_int4_i32(w)
    for m in range(1, 9):
        x = _to_torch(_normal(rng, (m, in_dim)), dtype).cuda()
        before = cuda_quant.cuda_int4_matmul_i32.launches
        out = cuda_quant.cuda_int4_matmul_i32(x, leaf["q32"], leaf["s"])
        assert cuda_quant.cuda_int4_matmul_i32.launches == before + 1
        ref = port_quant.int4_matmul_i32_reference(x, leaf["q32"], leaf["s"])
        assert out.dtype == dtype and out.shape == (m, out_dim)
        torch.testing.assert_close(out.float(), ref.float(), **tol, msg=f"M {m}")
        assert torch.equal(out, cuda_quant.cuda_int4_matmul_i32(x, leaf["q32"], leaf["s"]))
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[x.device]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 48, 128])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (12, 2, 128), (14, 2, 96), (8, 1, 256), (32, 2, 128)])
def test_mq_tensor_core_kernel_in_one_launch_on_the_card(page, hq, hkv, d):
    """B7 and B8 with a bf16 q (the tensor-core kernel) at Q 2 to 17: G 1,
    6, 7 and 8 (G 16 through two sub-groups), D 64, 96, 128 and 256,
    pages of 16 and 48 (each position looked up) and 128 (a tile in one
    page), junk table entries past every frontier, an empty row, a first
    query that sees nothing and offsets that cut inside rows. Each call is
    one launch per sub-group (Q 17 at G 6 is two q-tiles of it) and
    matches the plain version to 5e-3, also over a V pool that is constant
    per page (a wrong page lookup on the V side shows there); two calls
    give the same bits (the last split's ticket is reset: the tickets stay
    zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(20)
    lengths = [0, 1, 129, 300, 1100]
    offsets = torch.tensor([0, -1, 100, 290, 1090], dtype=torch.int32, device="cuda")
    _, k, v, table, lens = _paged_inputs(rng, torch.bfloat16, len(lengths), hq, hkv, d, page, lengths, "cuda")
    table = _junk_past_frontiers(table, lengths, page, k.shape[0])
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    vc = _page_constant(v)
    vcq, vcs = quantize_kv_vector(vc)
    sub_groups = -(-(hq // hkv) // 8)
    pools = {
        "bf16": (cpa.cuda_paged_decode_attention_mq_parts, port_attn.paged_mq_attention_reference,
                 ((k, v), (k, vc))),
        "int8": (cpa.cuda_paged_decode_attention_mq_parts_int8, port_attn.paged_mq_attention_int8_reference,
                 ((kq, ks, vq, vs), (kq, ks, vcq, vcs))),
    }
    for q_len in range(2, 18):
        q = _to_torch(_normal(rng, (len(lengths), q_len, hq, d)), torch.bfloat16).cuda()
        for fn, ref_fn, kinds in pools.values():
            for pool in kinds:
                before = fn.launches
                got = fn(q, *pool, table, lens, offsets)
                assert fn.launches == before + sub_groups, (q_len, fn.launches - before)
                assert got[0].shape == (len(lengths), q_len, hkv, hq // hkv, d)
                _assert_parts_close(got, ref_fn(q, *pool, table, lens, offsets), MQ_MMA_TOL)
                for a, b in zip(got, fn(q, *pool, table, lens, offsets)):
                    assert torch.equal(a, b), q_len
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[q.device]).item()


@pytest.mark.cuda
def test_redesigned_kernels_run_on_the_tensor_cores():
    """The built libraries' SASS: B10's kernel (bf16 and f32 x, vector and
    byte-wise loads) and the multi-query kernel of B7/B8 (bf16 and int8
    pools, D 16, 32, 64, 96, 128 and 256, over the page table and over
    contiguous rows) issue HMMA (mma.sync) instructions in every
    instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import subprocess
    from pathlib import Path

    cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
    # instantiations by a substring of their name: the multi-query kernel
    # under each address policy (the page table, and since the contiguous
    # verify the contiguous rows)
    for lib, kernel, counts in (
        ("int4_matmul", "int4_i32_mma_kernel", {"": 4}),
        ("paged_attention", "mq_mma_kernel", {"PagedRows": 12, "ContiguousRows": 12}),
    ):
        _kernels.library(lib)
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_kernels.library_path(lib))],
            capture_output=True, text=True, check=True,
        ).stdout
        functions = [f for f in sass.split("Function : ")[1:] if kernel in f.splitlines()[0]]
        names = [f.splitlines()[0] for f in functions]
        assert len(functions) == sum(counts.values()), (kernel, names)
        for policy, count in counts.items():
            assert sum(policy in name for name in names) == count, (kernel, policy, names)
        for body in functions:
            assert "HMMA" in body, body.splitlines()[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("page", [48, 128])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (32, 32, 96), (12, 2, 128), (8, 1, 256), (32, 2, 128)])
def test_paged_parts_kernels_on_the_tile_body_on_the_card(dtype, tol, page, hq, hkv, d):
    """B4 and B5 on the one-launch tile body: D 64, 96, 128 and 256, G 1,
    6 and 8 (G 16 through two sub-groups), pages of 48 (each position
    looked up) and 128 (a tile in one page), junk table entries past every
    frontier, an empty row and a one-position row, lengths on and off
    multiples of 32 and 64. Each call is one launch per sub-group and
    matches the plain version (the empty row exactly (0, -inf, 0)); two
    calls give the same bits and leave the tickets zero; the stacked
    ``layer=`` form and B7/B8 at Q 1 (lengths cut to the causal limit)
    equal the per-layer call bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(21)
    lengths = [0, 1, 32, 64, 97, 300, 1100]
    offsets = torch.tensor([0, 0, 20, 63, 97, 250, 1100], dtype=torch.int32, device="cuda")
    q, k, v, table, lens = _paged_inputs(rng, dtype, len(lengths), hq, hkv, d, page, lengths, "cuda")
    table = _junk_past_frontiers(table, lengths, page, k.shape[0])
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    sub_groups = -(-(hq // hkv) // 8)
    cases = (
        (cpa.cuda_paged_decode_attention_parts, port_attn.paged_decode_attention_parts_reference,
         cpa.cuda_paged_decode_attention_mq_parts, (k, v)),
        (cpa.cuda_paged_decode_attention_parts_int8, port_attn.paged_decode_attention_parts_int8_reference,
         cpa.cuda_paged_decode_attention_mq_parts_int8, (kq, ks, vq, vs)),
    )
    cut = torch.clamp(torch.minimum(lens, offsets + 1), min=0)
    for fn, ref_fn, mq_fn, pool in cases:
        before = fn.launches
        got = fn(q, *pool, table, lens)
        assert fn.launches == before + sub_groups
        assert got[0].shape == (len(lengths), hkv, hq // hkv, d) and got[0].dtype == torch.float32
        _assert_parts_close(got, ref_fn(q, *pool, table, lens), tol)
        for a, b in zip(got, fn(q, *pool, table, lens)):
            assert torch.equal(a, b)
        stacked = tuple(torch.stack([p, torch.zeros_like(p)]) for p in pool)
        for a, b in zip(fn(q, *stacked, table, lens, layer=0), got):
            assert torch.equal(a, b)
        one = mq_fn(q[:, None], *pool, table, lens, offsets)
        for a, b in zip(one, fn(q, *pool, table, cut)):
            assert torch.equal(a[:, 0], b)
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[q.device]).item()


@pytest.mark.cuda
def test_paged_parts_kernels_refuse_a_misaligned_pool_on_the_card():
    """B4/B5 copy K/V rows (int8 codes) 16 bytes at a time by cp.async: a
    pool view that does not start on a 16-byte boundary raises before any
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(22)
    q, k, v, table, lens = _paged_inputs(rng, torch.bfloat16, 2, 12, 2, 128, 128, [5, 200], "cuda")
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")[1:].view(k.shape)
    shifted.copy_(k)
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    codes = torch.empty(kq.numel() + 4, dtype=torch.int8, device="cuda")[4:].view(kq.shape)
    codes.copy_(kq)
    before = (cpa.cuda_paged_decode_attention_parts.launches,
              cpa.cuda_paged_decode_attention_parts_int8.launches)
    with pytest.raises(ValueError, match="16-byte"):
        cpa.cuda_paged_decode_attention_parts(q, shifted, v, table, lens)
    with pytest.raises(ValueError, match="16-byte"):
        cpa.cuda_paged_decode_attention_parts_int8(q, codes, ks, vq, vs, table, lens)
    assert before == (cpa.cuda_paged_decode_attention_parts.launches,
                      cpa.cuda_paged_decode_attention_parts_int8.launches)


@pytest.mark.cuda
def test_one_decode_tile_body_serves_every_single_query_decode():
    """The built libraries' SASS: the parts kernels B4/B5 and the
    write-through decode B6 are instantiations of ``decode_tile_kernel``
    (bf16 and f32 q; bf16/f32 and int8 pools for the parts; D 16, 32, 64,
    96, 128 and 256), as B2/B3 are in the attention library; the older split
    body is gone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import subprocess
    from pathlib import Path

    cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
    counts = {}
    for lib in ("attention", "paged_attention"):
        _kernels.library(lib)
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_kernels.library_path(lib))],
            capture_output=True, text=True, check=True,
        ).stdout
        names = [f.splitlines()[0] for f in sass.split("Function : ")[1:]]
        assert not any("decode_partial_kernel" in n for n in names), lib
        counts[lib] = sum("decode_tile_kernel" in n for n in names)
    # B2/B3: 2 q dtypes × (cache, int8) × 6 head dims; B6: 2 × 6; B4/B5: 2 × 2 × 6
    assert counts == {"attention": 24, "paged_attention": 12 + 24}, counts


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (12, 2, 128), (14, 2, 96), (8, 1, 256), (32, 2, 128),
                                      *TINY_LM_HEADS, *TINY_D16_HEADS])
def test_contiguous_mq_kernels_on_the_card(hq, hkv, d):
    """B7/B8's bodies over contiguous rows (the contiguous session's
    verify) against their plain version: bf16 caches with a bf16 q (the
    tensor-core kernel, one launch per sub-group up to Q 64, within the
    bf16 tolerance: the output rounds to bf16 once more), f32 with an f32
    q (the CUDA-core kernel, chunks of 9, to 1e-4), and int8 codes with
    either q; Q 1 to 13 over four rows whose candidates sit at the cache's
    start, middle and end. Two calls give the same bits; the tickets stay
    zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa

    rng = np.random.default_rng(21)
    b, t = 4, 320
    sub_groups = -(-(hq // hkv) // 8)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        k = _to_torch(_normal(rng, (b, hkv, t, d)), dtype).cuda()
        v = _to_torch(_normal(rng, (b, hkv, t, d)), dtype).cuda()
        kq, ks = quantize_kv_vector(k)
        vq, vs = quantize_kv_vector(v)
        caches = {
            "plain": (cpa.cuda_contiguous_mq_attention, port_attn.contiguous_mq_attention_reference, (k, v)),
            "int8": (cpa.cuda_contiguous_mq_attention_int8, port_attn.contiguous_mq_attention_int8_reference,
                     (kq, ks, vq, vs)),
        }
        for q_len in range(1, 14):
            q = _to_torch(_normal(rng, (b, q_len, hq, d)), dtype).cuda()
            offsets = torch.tensor([0, 1, 150, t - q_len], dtype=torch.int32, device="cuda")
            lengths = offsets + q_len
            chunks = 1 if dtype == torch.bfloat16 else -(-q_len // 9)
            for fn, ref_fn, cache in caches.values():
                before = fn.launches
                got = fn(q, *cache, lengths, offsets)
                assert fn.launches == before + chunks * sub_groups, (q_len, fn.launches - before)
                assert got.shape == q.shape and got.dtype == dtype
                want = ref_fn(q, *cache, lengths, offsets)
                torch.testing.assert_close(got.float(), want.float(), **tol)
                assert torch.equal(got, fn(q, *cache, lengths, offsets)), q_len
    torch.cuda.synchronize()
    assert not torch.any(_kernels._TICKETS[q.device]).item()


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_row_sharded_int4_leaf_sums_to_the_whole_product_on_the_card(tp):
    """qwen2:1.5b's ``w_down`` (8960 → 1536) cut by rows over tp shards the
    way ``shard_model`` cuts it (each shard's rows repacked as halves of
    its own): B9 on every shard's slice of x, summed in f32, equals B9's
    plain version on the whole leaf within the bf16 tolerance, and each
    shard equals its own plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import slice_leaf
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    rng = np.random.default_rng(12)
    in_dim, out_dim = 8960, 1536
    w = _to_torch(_normal(rng, (in_dim, out_dim)) / np.sqrt(in_dim), torch.float32).cuda()
    x = _to_torch(_normal(rng, (1, in_dim)), torch.bfloat16).cuda()
    leaf = quantize_tensor_int4(w)
    whole = port_quant.int4_matmul_reference(x, leaf["q4"], leaf["s"]).float()
    rows = in_dim // tp
    total = torch.zeros_like(whole)
    for t in range(tp):
        part = slice_leaf(leaf, -2, t * rows, (t + 1) * rows)
        xs = x[:, t * rows : (t + 1) * rows].contiguous()
        out = cuda_quant.cuda_int4_matmul(xs, part["q4"], part["s"])
        torch.testing.assert_close(
            out.float(), port_quant.int4_matmul_reference(xs, part["q4"], part["s"]).float(), **BF16_TOL
        )
        total += out.float()
    torch.cuda.synchronize()
    torch.testing.assert_close(total, whole, **BF16_TOL)
