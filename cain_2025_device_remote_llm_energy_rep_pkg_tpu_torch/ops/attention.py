"""Plain PyTorch attention: the versions the CUDA kernels are held against.

Counterpart of the JAX package's ``ops/attention.py``, and of the
references in its ``ops/pallas_paged_attention.py``. Each function here
states in full what one kernel of ``csrc/*.cu`` computes; the CPU tests
hold these against the JAX references and Pallas kernels, and
``chip_smoke.py`` holds the kernels against these on the card.

Layouts (the JAX package's, so the bridge is a plain copy):
  q (prefill): [B, S, Hq, D]     q (decode): [B, Hq, D]
  k/v cache:   [B, Hkv, T, D]    lengths:    [B] int32 (valid cache prefix)
  int8 cache:  codes [B, Hkv, T, D] int8, scales [B, Hkv, T] f32
  page pool:   [P, Hkv, page, D] (int8: codes, scales [P, Hkv, page] f32),
               read through page_table [B, Jmax] int32
"""

from __future__ import annotations

import math

import torch


def _group_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """[..., Hq, D] → [..., Hkv, G, D] where G = Hq // Hkv."""
    *lead, hq, d = q.shape
    return q.reshape(*lead, n_kv_heads, hq // n_kv_heads, d)


def _masked_softmax(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    scores = torch.where(valid, scores, float("-inf"))
    probs = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    return probs / torch.sum(probs, dim=-1, keepdim=True)


def prefill_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full self-attention over a prompt. q:[B,S,Hq,D] k,v:[B,S,Hkv,D]."""
    b, s, hq, d = q.shape
    qg = _group_heads(q, k.shape[2]).to(torch.float32)  # [B,S,Hkv,G,D]
    scores = torch.einsum(
        "bskgd,btkd->bkgst", qg, k.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    valid = (pos[None, :] <= pos[:, None]) if causal else torch.ones(
        s, s, dtype=torch.bool, device=q.device
    )
    probs = _masked_softmax(scores, valid)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(torch.float32))
    return out.reshape(b, s, hq, d).to(q.dtype)


def prefill_attention_cached(
    q: torch.Tensor,  # [B,S,Hq,D]
    k_cache: torch.Tensor,  # [B,Hkv,T,D]
    v_cache: torch.Tensor,
    offset: int,
) -> torch.Tensor:
    """S queries at cache positions ``offset..offset+S-1`` attend the cache
    causally by absolute position (``kpos <= qpos``), which also masks the
    unwritten suffix. The chunk's own K/V must already be in the cache.
    Plain version of ``cuda_prefill_attention``."""
    b, s, hq, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    qg = _group_heads(q, hkv).to(torch.float32)  # [B,S,Hkv,G,D]
    scores = torch.einsum(
        "bskgd,bktd->bkgst", qg, k_cache.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    qpos = offset + torch.arange(s, device=q.device)
    kpos = torch.arange(t, device=q.device)
    probs = _masked_softmax(scores, kpos[None, :] <= qpos[:, None])
    out = torch.einsum("bkgst,bktd->bskgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, s, hq, d).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # [B,Hq,D]
    k_cache: torch.Tensor,  # [B,Hkv,T,D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """One decode step against the KV cache; positions >= length are
    masked out. Plain version of ``cuda_decode_attention``."""
    b, hq, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    qg = _group_heads(q, hkv).to(torch.float32)  # [B,Hkv,G,D]
    scores = torch.einsum(
        "bkgd,bktd->bkgt", qg, k_cache.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    valid = (
        torch.arange(t, device=q.device)[None, :]
        < lengths.to(q.device)[:, None]
    )[:, None, None, :]
    probs = _masked_softmax(scores, valid)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_cache.to(torch.float32))
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_int8_reference(
    q: torch.Tensor,  # [B,Hq,D]
    k_q: torch.Tensor,  # [B,Hkv,T,D] int8
    k_s: torch.Tensor,  # [B,Hkv,T] f32
    v_q: torch.Tensor,  # [B,Hkv,T,D] int8
    v_s: torch.Tensor,  # [B,Hkv,T] f32
    lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Decode over an int8 cache without building a dequantized cache:
    K's per-position scale multiplies the score column it produced, and
    V's scale folds into the probability row before ``p·v`` (the math of
    the JAX package's ``pallas_decode_attention_int8``). Plain version of
    ``cuda_decode_attention_int8``."""
    b, hq, d = q.shape
    hkv, t = k_q.shape[1], k_q.shape[2]
    qg = _group_heads(q, hkv).to(torch.float32)  # [B,Hkv,G,D]
    scores = (
        torch.einsum("bkgd,bktd->bkgt", qg, k_q.to(torch.float32))
        * (1.0 / math.sqrt(d))
        * k_s.to(torch.float32)[:, :, None, :]
    )
    valid = (
        torch.arange(t, device=q.device)[None, :]
        < lengths.to(q.device)[:, None]
    )[:, None, None, :]
    probs = _masked_softmax(scores, valid) * v_s.to(torch.float32)[:, :, None, :]
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_q.to(torch.float32))
    return out.reshape(b, hq, d).to(q.dtype)


# -- paged pools ----------------------------------------------------------------
# pool [P, Hkv, page, D] (int8: codes plus f32 scales [P, Hkv, page]),
# page_table [B, Jmax] int32, lengths [B] int32 (cached tokens per row).


def _gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Pages named by the table, as a contiguous [B, Hkv, Jmax·page, ...]
    cache (the materialised gather the kernels avoid). Table entries are
    clipped to the pool, as the kernels clip them."""
    n_pool, hkv, page = pool.shape[:3]
    b, jmax = page_table.shape
    table = torch.clamp(page_table.to(torch.int64), 0, n_pool - 1)
    g = pool[table]  # [B, Jmax, Hkv, page, ...]
    return g.transpose(1, 2).reshape(b, hkv, jmax * page, *pool.shape[3:])


def _dense_parts(q, kf, vf, limits, k_scale=None, v_scale=None):
    """Unnormalised softmax parts of Q query positions ``q [B,Q,Hq,D]``
    against dense f32 ``kf/vf [B,Hkv,T,D]``, query j of row b seeing
    positions ``t < limits[b, j]``: ``(acc [B,Q,Hkv,G,D], m [B,Q,Hkv,G],
    l [B,Q,Hkv,G])`` with ``acc = Σ e^{s-m}·v`` and ``l = Σ e^{s-m}``.
    Optional int8 scales [B,Hkv,T] multiply the score column (K) and fold
    into the probabilities after ``l`` is taken (V). A query with no
    visible position gives exactly ``(0, -inf, 0)``."""
    d = q.shape[-1]
    _, hkv, t, _ = kf.shape
    qg = _group_heads(q, hkv).to(torch.float32)  # [B,Q,Hkv,G,D]
    scores = torch.einsum("bskgd,bktd->bskgt", qg, kf) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        scores = scores * k_scale[:, None, :, None, :]
    valid = torch.arange(t, device=q.device) < limits.to(q.device)[..., None]  # [B,Q,T]
    scores = torch.where(valid[:, :, None, None, :], scores, float("-inf"))
    m = torch.amax(scores, dim=-1)  # -inf for a query with no visible token
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None])  # exp(-inf) = 0 masks columns
    l = torch.sum(p, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, None, :, None, :]
    acc = torch.einsum("bskgt,bktd->bskgd", p, vf)
    return acc, m, l


def _single_query(parts):
    """The Q = 1 parts of :func:`_dense_parts` without their Q axis."""
    return tuple(x[:, 0] for x in parts)


def _mq_limits(lengths: torch.Tensor, offsets: torch.Tensor, q_len: int) -> torch.Tensor:
    """[B, Q] visible-token limits of a multi-query block: query j of row
    b sees cached tokens ``kpos < min(lengths[b], offsets[b] + j + 1)``
    (the JAX package's ``_mq_limit``)."""
    j = torch.arange(q_len, device=lengths.device)
    return torch.minimum(
        lengths.to(torch.int64)[:, None], offsets.to(lengths.device, torch.int64)[:, None] + j + 1
    )


def paged_decode_attention_parts_reference(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
):
    """Unnormalised flash parts over each row's cached pages, read through
    the table: the math of the JAX package's
    ``xla_paged_decode_attention_parts``. Plain version of
    ``cuda_paged_decode_attention_parts``."""
    kf = _gather_pages(k_pool, page_table).to(torch.float32)
    vf = _gather_pages(v_pool, page_table).to(torch.float32)
    return _single_query(_dense_parts(q[:, None], kf, vf, lengths[:, None]))


def paged_decode_attention_parts_int8_reference(
    q: torch.Tensor,  # [B,Hq,D]
    k_q: torch.Tensor,  # [P,Hkv,page,D] int8
    k_s: torch.Tensor,  # [P,Hkv,page] f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
):
    """The parts over an int8 pool: the JAX gather variant's contract, with
    the scales folded as its Pallas kernel folds them (K's scale on the
    score column, V's into the probabilities), so no dequantized page
    exists. Plain version of ``cuda_paged_decode_attention_parts_int8``."""
    return _single_query(_int8_pages_parts(q[:, None], k_q, k_s, v_q, v_s, page_table, lengths[:, None]))


def _int8_pages_parts(q, k_q, k_s, v_q, v_s, page_table, limits):
    return _dense_parts(
        q,
        _gather_pages(k_q, page_table).to(torch.float32),
        _gather_pages(v_q, page_table).to(torch.float32),
        limits,
        _gather_pages(k_s, page_table).to(torch.float32),
        _gather_pages(v_s, page_table).to(torch.float32),
    )


def paged_mq_attention_reference(
    q: torch.Tensor,  # [B,Q,Hq,D]: Q candidate positions per row
    k_pool: torch.Tensor,  # [P,Hkv,page,D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32: cached tokens (candidates excluded)
    offsets: torch.Tensor,  # [B] int32: absolute position of query 0
):
    """Multi-query unnormalised parts over each row's cached pages:
    ``(acc [B,Q,Hkv,G,D], m [B,Q,Hkv,G], l [B,Q,Hkv,G])``, query j masked
    by the causal cut ``kpos < min(lengths[b], offsets[b] + j + 1)`` (the
    JAX package's ``paged_mq_attention_reference``). At Q = 1 with every
    cached token visible it is :func:`paged_decode_attention_parts_reference`.
    Plain version of ``cuda_paged_decode_attention_mq_parts``."""
    kf = _gather_pages(k_pool, page_table).to(torch.float32)
    vf = _gather_pages(v_pool, page_table).to(torch.float32)
    return _dense_parts(q, kf, vf, _mq_limits(lengths, offsets, q.shape[1]))


def paged_mq_attention_int8_reference(
    q: torch.Tensor,  # [B,Q,Hq,D]
    k_q: torch.Tensor,  # [P,Hkv,page,D] int8
    k_s: torch.Tensor,  # [P,Hkv,page] f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
    offsets: torch.Tensor,  # [B] int32
):
    """:func:`paged_mq_attention_reference` over an int8 pool, the scales
    folded as :func:`paged_decode_attention_parts_int8_reference` folds
    them. Plain version of ``cuda_paged_decode_attention_mq_parts_int8``."""
    return _int8_pages_parts(
        q, k_q, k_s, v_q, v_s, page_table, _mq_limits(lengths, offsets, q.shape[1])
    )


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Normalised paged decode: gather the pages through the clipped table
    into a contiguous cache, then plain masked attention in f32 (the JAX
    package's ``paged_decode_attention_reference``), ``[B,Hq,D]`` in q's
    dtype; a row with no token gives NaN (0/0), as the JAX kernel does.
    Plain version of ``cuda_paged_decode_attention`` (B6)."""
    k = _gather_pages(k_pool, page_table)
    v = _gather_pages(v_pool, page_table)
    return decode_attention_reference(q, k, v, lengths)
