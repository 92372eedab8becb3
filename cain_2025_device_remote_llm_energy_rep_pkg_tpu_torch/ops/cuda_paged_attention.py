"""Wrappers of the Hopper paged-attention kernels (``csrc/paged_attention.cu``).

Counterparts of the JAX package's ``pallas_paged_decode_attention`` (the
write-through decode: normalised ``[B,Hq,D]`` in q's dtype, over a
bf16/f32 pool), and of ``pallas_paged_decode_attention_parts{,_int8}``,
in their per-layer form:
pool ``[P,Hkv,page,D]``, ``page_table [B,Jmax] int32``, ``lengths [B]
int32`` (cached tokens), returning the unnormalised ``(acc [B,Hkv,G,D] f32,
m [B,Hkv,G] f32, l [B,Hkv,G] f32)``; and of their multi-query twins
``pallas_paged_decode_attention_mq_parts{,_int8}`` (the speculative
verify): ``q [B,Q,Hq,D]`` with ``offsets [B] int32``, parts per query
position. The stacked ``layer=`` form serves paths that are not ported
yet and is refused.

A tensor on the CPU goes to the plain version in ``ops/attention.py``; a
CUDA tensor launches the kernel or raises. Each wrapper counts its
launches in an integer ``launches`` attribute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import (
    paged_decode_attention_parts_int8_reference,
    paged_decode_attention_reference,
    paged_decode_attention_parts_reference,
    paged_mq_attention_int8_reference,
    paged_mq_attention_reference,
)
from .cuda_attention import _TARGET_BLOCKS, _check_inputs, _require, _stream

Parts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_LIB = "paged_attention"
# Positions per split: at least this many (8 per warp of the block).
_MIN_SPLIT_POSITIONS = 32


def _paged_split(b: int, hkv: int, jmax: int, page: int) -> "tuple[int, int]":
    """(n_split, split_len): at most one page per split, and enough splits
    that B·Hkv·n_split blocks cover the card's 132 SMs about twice. Rows
    differ in length, so the longest row's work must spread over many
    blocks; the splits past a shorter row's length exit at once."""
    t = jmax * page
    n = max(jmax, -(-_TARGET_BLOCKS // (b * hkv)))
    split_len = max(_MIN_SPLIT_POSITIONS, -(-t // n))
    return -(-t // split_len), split_len


def _refuse_stacked(name: str, layer) -> None:
    if layer is not None:
        raise ValueError(
            f"{name}: the stacked layer= form is not ported; pass the "
            "per-layer pool [P,Hkv,page,D]"
        )


def _check_single_query(name, q, k, v, scales, page_table, lengths) -> int:
    """The checks of a single-query launch over per-layer pools; returns
    the dtype code."""
    code = _check_inputs(name, q, k, v, page_table, lengths, *scales)
    b, hq, d = q.shape
    n_pool, hkv, page, _ = k.shape
    _require(k.shape == v.shape == (n_pool, hkv, page, d), f"{name}: pools must be [P,Hkv,page,D]")
    _require(hq % hkv == 0, f"{name}: Hq must be a multiple of Hkv")
    group_max = _kernels.library(_LIB).paged_group_max()
    _require(hq // hkv <= group_max, f"{name}: more than {group_max} query heads per kv head")
    _require(
        page_table.dim() == 2 and page_table.shape[0] == b and page_table.dtype == torch.int32,
        f"{name}: page_table must be int32 [B,Jmax]",
    )
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32, f"{name}: lengths must be int32 [B]")
    return code


def _launch_parts(name, q, k, v, k_scale, v_scale, page_table, lengths) -> Parts:
    scales = [x for x in (k_scale, v_scale) if x is not None]
    code = _check_single_query(name, q, k, v, scales, page_table, lengths)
    b, hq, d = q.shape
    n_pool, hkv, page, _ = k.shape
    jmax = page_table.shape[1]
    group = hq // hkv
    n_split, split_len = _paged_split(b, hkv, jmax, page)
    dev = q.device
    part_acc = torch.empty((b * hkv, n_split, group, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b * hkv, n_split, group, 2), dtype=torch.float32, device=dev)
    acc = torch.empty((b, hkv, group, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hkv, group), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, group), dtype=torch.float32, device=dev)
    err = _kernels.library(_LIB).paged_parts(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, hq, hkv, n_pool, page, jmax, d, n_split, split_len, _stream(q),
    )
    _kernels.check(err, name, _LIB)
    return acc, m, l


def cuda_paged_decode_attention(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32: tokens to attend (the current one included)
) -> torch.Tensor:
    """Normalised flash-decode attention over each row's first
    ``lengths[b]`` tokens, read through the table: ``[B,Hq,D]`` in q's
    dtype. Table entries are clipped to the pool; entries past a row's
    frontier are never read."""
    name = "cuda_paged_decode_attention"
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, page_table, lengths)
    _require(k_pool.dtype == v_pool.dtype == q.dtype, f"{name}: pools must be in q's dtype")
    code = _check_single_query(name, q, k_pool, v_pool, (), page_table, lengths)
    b, hq, d = q.shape
    n_pool, hkv, page, _ = k_pool.shape
    jmax = page_table.shape[1]
    n_split, split_len = _paged_split(b, hkv, jmax, page)
    part_acc = torch.empty((b * hkv, n_split, hq // hkv, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b * hkv, n_split, hq // hkv, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = _kernels.library(_LIB).paged_decode(
        code, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, hq, hkv, n_pool, page, jmax, d, n_split, split_len, _stream(q),
    )
    _kernels.check(err, name, _LIB)
    cuda_paged_decode_attention.launches += 1
    return out


def cuda_paged_decode_attention_parts(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32: cached tokens (the current one excluded)
    *,
    layer: Optional[int] = None,
) -> Parts:
    """Unnormalised flash-decode parts over each row's cached pages."""
    name = "cuda_paged_decode_attention_parts"
    _refuse_stacked(name, layer)
    if q.device.type == "cpu":
        return paged_decode_attention_parts_reference(q, k_pool, v_pool, page_table, lengths)
    _require(k_pool.dtype == v_pool.dtype == q.dtype, f"{name}: pools must be in q's dtype")
    out = _launch_parts(name, q, k_pool, v_pool, None, None, page_table, lengths)
    cuda_paged_decode_attention_parts.launches += 1
    return out


def cuda_paged_decode_attention_parts_int8(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D] int8 codes
    k_scale: torch.Tensor,  # [P,Hkv,page] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
    *,
    layer: Optional[int] = None,
) -> Parts:
    """The parts over an int8 pool: scales fold into the scores (K) and
    the probabilities (V); no dequantized page is built."""
    name = "cuda_paged_decode_attention_parts_int8"
    _refuse_stacked(name, layer)
    if q.device.type == "cpu":
        return paged_decode_attention_parts_int8_reference(
            q, k_pool, k_scale, v_pool, v_scale, page_table, lengths
        )
    _require(k_pool.dtype == v_pool.dtype == torch.int8, f"{name}: codes must be int8")
    _require(
        k_scale.dtype == v_scale.dtype == torch.float32
        and k_scale.shape == v_scale.shape == k_pool.shape[:3],
        f"{name}: scales must be float32 [P,Hkv,page]",
    )
    out = _launch_parts(name, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths)
    cuda_paged_decode_attention_parts_int8.launches += 1
    return out


def _launch_mq_parts(name, q, k, v, k_scale, v_scale, page_table, lengths, offsets) -> Parts:
    """The multi-query launch. Q = 1 runs B4/B5's launch with each row's
    lengths cut to its causal limit, so the two kernels never differ in
    summation order; Q over the kernel's limit raises."""
    b, q_len, hq, d = q.shape
    q_max = _kernels.library(_LIB).paged_mq_query_max()
    _require(1 <= q_len <= q_max, f"{name}: {q_len} query positions per row, at most {q_max}")
    _require(offsets.shape == (b,) and offsets.dtype == torch.int32, f"{name}: offsets must be int32 [B]")
    if q_len == 1:
        _require(lengths.shape == (b,) and lengths.dtype == torch.int32, f"{name}: lengths must be int32 [B]")
        limit = torch.clamp(torch.minimum(lengths, offsets + 1), min=0)
        acc, m, l = _launch_parts(name, q[:, 0], k, v, k_scale, v_scale, page_table, limit)
        return acc[:, None], m[:, None], l[:, None]
    scales = [x for x in (k_scale, v_scale) if x is not None]
    code = _check_inputs(name, q, k, v, page_table, lengths, offsets, *scales)
    n_pool, hkv, page, _ = k.shape
    _require(k.shape == v.shape == (n_pool, hkv, page, d), f"{name}: pools must be [P,Hkv,page,D]")
    _require(hq % hkv == 0, f"{name}: Hq must be a multiple of Hkv")
    group_max = _kernels.library(_LIB).paged_group_max()
    _require(hq // hkv <= group_max, f"{name}: more than {group_max} query heads per kv head")
    _require(
        page_table.dim() == 2 and page_table.shape[0] == b and page_table.dtype == torch.int32,
        f"{name}: page_table must be int32 [B,Jmax]",
    )
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32, f"{name}: lengths must be int32 [B]")
    jmax = page_table.shape[1]
    group = hq // hkv
    rows = q_len * group
    n_split, split_len = _paged_split(b, hkv, jmax, page)
    dev = q.device
    part_acc = torch.empty((b * hkv, n_split, rows, d), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b * hkv, n_split, rows, 2), dtype=torch.float32, device=dev)
    acc = torch.empty((b, q_len, hkv, group, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, q_len, hkv, group), dtype=torch.float32, device=dev)
    l = torch.empty((b, q_len, hkv, group), dtype=torch.float32, device=dev)
    err = _kernels.library(_LIB).paged_mq_parts(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), offsets.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, q_len, hq, hkv, n_pool, page, jmax, d, n_split, split_len, _stream(q),
    )
    _kernels.check(err, name, _LIB)
    return acc, m, l


def cuda_paged_decode_attention_mq_parts(
    q: torch.Tensor,  # [B,Q,Hq,D]: Q candidate positions per row
    k_pool: torch.Tensor,  # [P,Hkv,page,D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32: cached tokens (candidates excluded)
    offsets: torch.Tensor,  # [B] int32: absolute position of query 0
    *,
    layer: Optional[int] = None,
) -> Parts:
    """Multi-query unnormalised parts over each row's cached pages, query
    j cut at ``kpos < min(lengths[b], offsets[b] + j + 1)``: ``(acc
    [B,Q,Hkv,G,D], m [B,Q,Hkv,G], l [B,Q,Hkv,G])``."""
    name = "cuda_paged_decode_attention_mq_parts"
    _refuse_stacked(name, layer)
    if q.device.type == "cpu":
        return paged_mq_attention_reference(q, k_pool, v_pool, page_table, lengths, offsets)
    _require(k_pool.dtype == v_pool.dtype == q.dtype, f"{name}: pools must be in q's dtype")
    out = _launch_mq_parts(name, q, k_pool, v_pool, None, None, page_table, lengths, offsets)
    cuda_paged_decode_attention_mq_parts.launches += 1
    return out


def cuda_paged_decode_attention_mq_parts_int8(
    q: torch.Tensor,  # [B,Q,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D] int8 codes
    k_scale: torch.Tensor,  # [P,Hkv,page] f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
    offsets: torch.Tensor,  # [B] int32
    *,
    layer: Optional[int] = None,
) -> Parts:
    """The multi-query parts over an int8 pool, scales folded as in
    :func:`cuda_paged_decode_attention_parts_int8`."""
    name = "cuda_paged_decode_attention_mq_parts_int8"
    _refuse_stacked(name, layer)
    if q.device.type == "cpu":
        return paged_mq_attention_int8_reference(
            q, k_pool, k_scale, v_pool, v_scale, page_table, lengths, offsets
        )
    _require(k_pool.dtype == v_pool.dtype == torch.int8, f"{name}: codes must be int8")
    _require(
        k_scale.dtype == v_scale.dtype == torch.float32
        and k_scale.shape == v_scale.shape == k_pool.shape[:3],
        f"{name}: scales must be float32 [P,Hkv,page]",
    )
    out = _launch_mq_parts(name, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, offsets)
    cuda_paged_decode_attention_mq_parts_int8.launches += 1
    return out


cuda_paged_decode_attention.launches = 0
cuda_paged_decode_attention_parts.launches = 0
cuda_paged_decode_attention_parts_int8.launches = 0
cuda_paged_decode_attention_mq_parts.launches = 0
cuda_paged_decode_attention_mq_parts_int8.launches = 0

# Every kernel wrapper of this module, for code that resets or reads counts.
KERNELS = (
    cuda_paged_decode_attention,
    cuda_paged_decode_attention_parts,
    cuda_paged_decode_attention_parts_int8,
    cuda_paged_decode_attention_mq_parts,
    cuda_paged_decode_attention_mq_parts_int8,
)
