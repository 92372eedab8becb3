"""Wrappers of the Hopper paged-attention kernels (``csrc/paged_attention.cu``).

Counterparts of the JAX package's ``pallas_paged_decode_attention`` (the
write-through decode: normalised ``[B,Hq,D]`` in q's dtype, over a
bf16/f32 pool), and of ``pallas_paged_decode_attention_parts{,_int8}``:
pool ``[P,Hkv,page,D]``, ``page_table [B,Jmax] int32``, ``lengths [B]
int32`` (cached tokens), returning the unnormalised ``(acc [B,Hkv,G,D]
f32, m [B,Hkv,G] f32, l [B,Hkv,G] f32)``; and of their multi-query twins
``pallas_paged_decode_attention_mq_parts{,_int8}`` (the speculative
verify): ``q [B,Q,Hq,D]`` with ``offsets [B] int32``, parts per query
position. The four parts wrappers also take the stacked ``layer=`` form:
a whole ``[L,P,Hkv,page,D]`` pool (scales ``[L,P,Hkv,page]``) and a layer
index, read through a zero-copy view of that layer.

A tensor on the CPU goes to the plain version in ``ops/attention.py``; a
CUDA tensor launches the kernel or raises. The single-query kernels (the
write-through decode and both parts kernels) run one body,
``decode_tile_kernel``, through the page table in one launch: the grid is
sized here from B·Hkv and ``Jmax·page`` (:func:`decode_grid`,
:func:`parts_grid`), each block sizes its row's splits from
``lengths[b]`` on the device, and the last split of a (row, kv head)
merges them through a ticket, into the normalised output or into the
unnormalised parts. Each wrapper counts its launches (one per kernel
launch) in an integer ``launches`` attribute. No kernel's cap reaches a
caller: a group of more query heads per kv head than a kernel holds is
cut into sub-groups (``tile_groups``), and a verify block of more query
positions than the multi-query kernel for q's dtype holds (64 in bf16, 9
in f32) into chunks (:func:`chunk_queries`).
"""

from __future__ import annotations

import operator
from typing import Optional, Tuple, Union

import torch

from . import _kernels
from .attention import (
    paged_decode_attention_parts_int8_reference,
    paged_decode_attention_reference,
    paged_decode_attention_parts_reference,
    paged_mq_attention_int8_reference,
    paged_mq_attention_reference,
)
from .cuda_attention import (
    _DECODE_MAX_SPLITS,
    _DECODE_MIN_SPLIT,
    _DTYPE_CODES,
    _TARGET_BLOCKS,
    _check_inputs,
    _require,
    _require_aligned,
    _stream,
    decode_grid,
    tile_groups,
)

Parts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Layer = Optional[Union[int, torch.Tensor]]
_LIB = "paged_attention"
# Positions per split of the f32-q multi-query kernel: at least this many
# (8 per warp of its block).
_MIN_SPLIT_POSITIONS = 32
# The tensor-core multi-query kernel (B7/B8 with a bf16 q, ``mq_mma_kernel``):
# score rows per block (a q-tile is 64 // G query positions), positions per
# split at least, and splits per (q-tile, row, kv head) at most
# (kMqMmaRows, kMqMinSplit and kMqMaxSplits of ``csrc/paged_attention.cu``).
MQ_ROWS = 64
_MQ_MIN_SPLIT = 64
_MQ_MAX_SPLITS = 32
# Blocks in all of the parts kernels' grid (B4/B5), at most (parts_grid).
_PARTS_MAX_BLOCKS = 4096


def _paged_split(b: int, hkv: int, jmax: int, page: int) -> "tuple[int, int]":
    """(n_split, split_len) of the f32-q multi-query kernel
    (``mq_partial_kernel``, the only kernel whose splits the host sizes):
    at most one page per split, and enough splits that B·Hkv·n_split
    blocks cover the card's 132 SMs about twice. Rows differ in length, so
    the longest row's work must spread over many blocks; the splits past a
    shorter row's length exit at once."""
    t = jmax * page
    n = max(jmax, -(-_TARGET_BLOCKS // (b * hkv)))
    split_len = max(_MIN_SPLIT_POSITIONS, -(-t // n))
    return -(-t // split_len), split_len


def parts_grid(batch: int, hkv: int, capacity: int) -> int:
    """Blocks per (row, kv head) of the parts kernels' grid (B4/B5): as
    many as a row as long as the table holds (``capacity`` = Jmax·page)
    needs to split into the body's shortest splits (64 positions, two
    tiles), at most 128, and at most 4,096 blocks in all. The batch's rows
    differ in length (the engine pads a batch with copies of its first
    row), and the longest row holds the launch: each block sizes its row's
    splits from ``lengths[b]`` on the device, and blocks past them exit at
    once. Past 4,096 blocks those exits cost more than the finer splits
    save (``scripts/torch_parts_grid_sweep.py``: phi3's 256 (row, kv head)
    pairs run fastest at 8–16 blocks each, the engine batch's 64 at 64)."""
    finest = -(-max(capacity, 1) // _DECODE_MIN_SPLIT)
    return max(1, min(_DECODE_MAX_SPLITS, finest, _PARTS_MAX_BLOCKS // max(1, batch * hkv)))


def mq_q_tiles(q_len: int, group: int) -> int:
    """Q-tiles of a verify block: 64 // G query positions each."""
    return -(-q_len // (MQ_ROWS // group))


def mq_grid(batch: int, hkv: int, q_tiles: int, capacity: int) -> int:
    """Splits per (q-tile, row, kv head) of the tensor-core multi-query
    grid: enough that the blocks cover the card about twice, none starting
    past the capacity (``Jmax·page``), at most 32. Each block sizes its
    q-tile's splits from the q-tile's frontier on the device (at least 64
    positions a split, in whole tiles); blocks past them exit at once."""
    pairs = max(1, batch * hkv * q_tiles)
    n = min(_MQ_MAX_SPLITS, -(-_TARGET_BLOCKS // pairs))
    return max(1, min(n, -(-max(capacity, 1) // _MQ_MIN_SPLIT)))


def _select_layer(name: str, layer: Layer, *pools: torch.Tensor) -> "tuple[torch.Tensor, ...]":
    """The stacked ``layer=`` form: each of ``pools`` (codes ``[L,P,Hkv,
    page,D]``, scales ``[L,P,Hkv,page]``) viewed at ``layer``, a Python int
    or a 0-d integer tensor. On a contiguous stacked pool the view is
    contiguous and copies nothing. Without a layer the pools are the
    per-layer ones and pass through."""
    if layer is None:
        return pools
    if isinstance(layer, torch.Tensor):
        _require(
            layer.dim() == 0 and not layer.is_floating_point() and not layer.is_complex(),
            f"{name}: layer must be an int or a 0-d integer tensor",
        )
        layer = int(layer.item())
    layer = operator.index(layer)
    _require(pools[0].dim() == 5, f"{name}: with layer= the pools must be stacked [L,P,Hkv,page,D]")
    n_layers = pools[0].shape[0]
    _require(0 <= layer < n_layers, f"{name}: layer {layer} outside [0, {n_layers})")
    return tuple(p.select(0, layer) for p in pools)


def chunk_queries(run, q: torch.Tensor, offsets: torch.Tensor, q_max: int) -> Parts:
    """The multi-query parts of ``q [B,Q,Hq,D]`` from ``run(q_chunk,
    offsets_chunk)`` on chunks of at most ``q_max`` query positions: chunk
    ``j0`` gets ``q[:, j0:j0+c]`` and ``offsets + j0`` (lengths unchanged),
    and the chunks' ``(acc, m, l)`` are concatenated along Q. Query j's
    parts depend only on its own limit ``min(lengths, offsets + j + 1)``,
    so the result is the one-launch result."""
    q_len = q.shape[1]
    if q_len <= q_max:
        return run(q, offsets)
    parts = [run(q[:, j0 : j0 + q_max], offsets + j0) for j0 in range(0, q_len, q_max)]
    return tuple(torch.cat(xs, dim=1) for xs in zip(*parts))


def _check_single_query(name, q, k, v, scales, page_table, lengths) -> int:
    """The checks of a single-query launch over per-layer pools; returns
    the dtype code."""
    code = _check_inputs(name, q, k, v, page_table, lengths, *scales)
    b, hq, d = q.shape
    n_pool, hkv, page, _ = k.shape
    _require(k.shape == v.shape == (n_pool, hkv, page, d), f"{name}: pools must be [P,Hkv,page,D]")
    _require(hq % hkv == 0, f"{name}: Hq must be a multiple of Hkv")
    _require(
        page_table.dim() == 2 and page_table.shape[0] == b and page_table.dtype == torch.int32,
        f"{name}: page_table must be int32 [B,Jmax]",
    )
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32, f"{name}: lengths must be int32 [B]")
    return code


def _launch_parts(name, wrapper, q, k, v, k_scale, v_scale, page_table, lengths) -> Parts:
    """B4/B5: one launch of the parts kernel per sub-group of at most 8
    query heads; the codes (and K/V rows) arrive by 16-byte ``cp.async``,
    so the pools must start on a 16-byte boundary."""
    scales = [x for x in (k_scale, v_scale) if x is not None]
    code = _check_single_query(name, q, k, v, scales, page_table, lengths)
    _require_aligned(name, k, v)
    b, _, d = q.shape
    n_pool, hkv, page, _ = k.shape
    jmax = page_table.shape[1]
    n_grid = parts_grid(b, hkv, jmax * page)
    dev = q.device
    tickets = _kernels.tickets(dev, b * hkv)
    lib = _kernels.library(_LIB)

    def launch(qs: torch.Tensor) -> Parts:
        hq = qs.shape[1]
        group = hq // hkv
        part_acc = torch.empty((b * hkv, n_grid, group, d), dtype=torch.float32, device=dev)
        part_ml = torch.empty((b * hkv, n_grid, group, 2), dtype=torch.float32, device=dev)
        acc = torch.empty((b, hkv, group, d), dtype=torch.float32, device=dev)
        m = torch.empty((b, hkv, group), dtype=torch.float32, device=dev)
        l = torch.empty((b, hkv, group), dtype=torch.float32, device=dev)
        err = lib.paged_parts(
            code, qs.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            tickets.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, hq, hkv, n_pool, page, jmax, d, n_grid, _stream(qs),
        )
        _kernels.check(err, name, _LIB)
        wrapper.launches += 1
        return acc, m, l

    return tile_groups(launch, q, hkv, lib.paged_group_max())


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
    frontier are never read. One launch: B2's body through the table,
    its grid sized from B·Hkv and ``Jmax·page`` (:func:`decode_grid`),
    one ticket per (row, kv head)."""
    name = "cuda_paged_decode_attention"
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, page_table, lengths)
    _require(k_pool.dtype == v_pool.dtype == q.dtype, f"{name}: pools must be in q's dtype")
    code = _check_single_query(name, q, k_pool, v_pool, (), page_table, lengths)
    b, _, d = q.shape
    n_pool, hkv, page, _ = k_pool.shape
    _require_aligned(name, k_pool, v_pool)
    jmax = page_table.shape[1]
    n_grid = decode_grid(b, hkv, jmax * page)
    tickets = _kernels.tickets(q.device, b * hkv)
    lib = _kernels.library(_LIB)

    def launch(qs: torch.Tensor) -> torch.Tensor:
        hq = qs.shape[1]
        part_acc = torch.empty((b * hkv, n_grid, hq // hkv, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * hkv, n_grid, hq // hkv, 2), dtype=torch.float32, device=q.device)
        out = torch.empty_like(qs)
        err = lib.paged_decode(
            code, qs.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), b, hq, hkv, n_pool, page, jmax, d, n_grid, _stream(qs),
        )
        _kernels.check(err, name, _LIB)
        cuda_paged_decode_attention.launches += 1
        return out

    return tile_groups(launch, q, hkv, lib.paged_group_max())


def cuda_paged_decode_attention_parts(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D] — or [L,P,Hkv,page,D] with layer
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32: cached tokens (the current one excluded)
    *,
    layer: Layer = None,  # an int or 0-d integer tensor: stacked pools
) -> Parts:
    """Unnormalised flash-decode parts over each row's cached pages:
    ``(acc [B,Hkv,G,D], m [B,Hkv,G], l [B,Hkv,G])`` in f32, m in natural
    units; a row with no cached token gives exactly ``(0, -inf, 0)``.
    Table entries are clipped to the pool; entries past a row's frontier
    are never read. One launch per sub-group of at most 8 query heads:
    the write-through decode's body (:func:`cuda_paged_decode_attention`),
    whose last split writes the parts without normalising."""
    name = "cuda_paged_decode_attention_parts"
    k_pool, v_pool = _select_layer(name, layer, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_decode_attention_parts_reference(q, k_pool, v_pool, page_table, lengths)
    _require(k_pool.dtype == v_pool.dtype == q.dtype, f"{name}: pools must be in q's dtype")
    return _launch_parts(name, cuda_paged_decode_attention_parts, q, k_pool, v_pool, None, None,
                         page_table, lengths)


def _check_int8_pool(name, k_pool, k_scale, v_pool, v_scale) -> None:
    _require(k_pool.dtype == v_pool.dtype == torch.int8, f"{name}: codes must be int8")
    _require(
        k_scale.dtype == v_scale.dtype == torch.float32
        and k_scale.shape == v_scale.shape == k_pool.shape[:3],
        f"{name}: scales must be float32 [P,Hkv,page]",
    )


def cuda_paged_decode_attention_parts_int8(
    q: torch.Tensor,  # [B,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D] int8 codes — or [L,P,...] with layer
    k_scale: torch.Tensor,  # [P,Hkv,page] f32 — or [L,P,Hkv,page]
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
    *,
    layer: Layer = None,
) -> Parts:
    """The parts over an int8 pool: scales fold into the scores (K) and
    the probabilities (V); no dequantized page is built."""
    name = "cuda_paged_decode_attention_parts_int8"
    k_pool, k_scale, v_pool, v_scale = _select_layer(name, layer, k_pool, k_scale, v_pool, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_parts_int8_reference(
            q, k_pool, k_scale, v_pool, v_scale, page_table, lengths
        )
    _check_int8_pool(name, k_pool, k_scale, v_pool, v_scale)
    return _launch_parts(name, cuda_paged_decode_attention_parts_int8, q, k_pool, v_pool,
                         k_scale, v_scale, page_table, lengths)


def _launch_mq_chunk(name, wrapper, q, k, v, k_scale, v_scale, page_table, lengths, offsets) -> Parts:
    """One multi-query launch of at most ``paged_mq_query_max`` query
    positions. Q = 1 runs B4/B5's launch with each row's lengths cut to
    its causal limit, so the two kernels never differ in summation order;
    a bf16 q runs the tensor-core kernel (its splits merged by the last
    to arrive), an f32 q the CUDA-core kernel."""
    b, q_len, hq, d = q.shape
    if q_len == 1:
        limit = torch.clamp(torch.minimum(lengths, offsets + 1), min=0)
        acc, m, l = _launch_parts(name, wrapper, q[:, 0], k, v, k_scale, v_scale, page_table, limit)
        return acc[:, None], m[:, None], l[:, None]
    scales = [x for x in (k_scale, v_scale) if x is not None]
    code = _check_inputs(name, q, k, v, page_table, lengths, offsets, *scales)
    n_pool, hkv, page, _ = k.shape
    _require(k.shape == v.shape == (n_pool, hkv, page, d), f"{name}: pools must be [P,Hkv,page,D]")
    _require(hq % hkv == 0, f"{name}: Hq must be a multiple of Hkv")
    _require(
        page_table.dim() == 2 and page_table.shape[0] == b and page_table.dtype == torch.int32,
        f"{name}: page_table must be int32 [B,Jmax]",
    )
    jmax = page_table.shape[1]
    dev = q.device
    lib = _kernels.library(_LIB)
    mma = q.dtype == torch.bfloat16
    if mma:
        _require_aligned(name, q, k, v)
    else:
        n_split, split_len = _paged_split(b, hkv, jmax, page)

    def launch(qs: torch.Tensor) -> Parts:
        hq_s = qs.shape[2]
        group = hq_s // hkv
        rows = q_len * group
        acc = torch.empty((b, q_len, hkv, group, d), dtype=torch.float32, device=dev)
        m = torch.empty((b, q_len, hkv, group), dtype=torch.float32, device=dev)
        l = torch.empty((b, q_len, hkv, group), dtype=torch.float32, device=dev)
        pool = (qs.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if k_scale is None else k_scale.data_ptr(),
                None if v_scale is None else v_scale.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), offsets.data_ptr())
        if mma:
            q_tiles = mq_q_tiles(q_len, group)
            n_grid = mq_grid(b, hkv, q_tiles, jmax * page)
            part_acc = torch.empty((b * hkv, n_grid, rows, d), dtype=torch.float32, device=dev)
            part_ml = torch.empty((b * hkv, n_grid, rows, 2), dtype=torch.float32, device=dev)
            tickets = _kernels.tickets(dev, b * hkv * q_tiles)
            err = lib.paged_mq_mma_parts(
                *pool, part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                b, q_len, hq_s, hkv, n_pool, page, jmax, d, n_grid, _stream(qs),
            )
        else:
            part_acc = torch.empty((b * hkv, n_split, rows, d), dtype=torch.float32, device=dev)
            part_ml = torch.empty((b * hkv, n_split, rows, 2), dtype=torch.float32, device=dev)
            err = lib.paged_mq_parts(
                code, *pool, part_acc.data_ptr(), part_ml.data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                b, q_len, hq_s, hkv, n_pool, page, jmax, d, n_split, split_len, _stream(qs),
            )
        _kernels.check(err, name, _LIB)
        wrapper.launches += 1
        return acc, m, l

    return tile_groups(launch, q, hkv, lib.paged_group_max())


def _launch_mq_parts(name, wrapper, q, k, v, k_scale, v_scale, page_table, lengths, offsets) -> Parts:
    """The multi-query launches: a block of more query positions than the
    kernel for q's dtype holds goes in chunks (:func:`chunk_queries`)."""
    b, q_len, _, _ = q.shape
    _require(q_len >= 1, f"{name}: no query position")
    _require(offsets.shape == (b,) and offsets.dtype == torch.int32, f"{name}: offsets must be int32 [B]")
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32, f"{name}: lengths must be int32 [B]")
    _require(q.dtype in _DTYPE_CODES, f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    return chunk_queries(
        lambda qc, oc: _launch_mq_chunk(name, wrapper, qc.contiguous(), k, v, k_scale, v_scale,
                                        page_table, lengths, oc),
        q, offsets, _kernels.library(_LIB).paged_mq_query_max(_DTYPE_CODES[q.dtype]),
    )


def cuda_paged_decode_attention_mq_parts(
    q: torch.Tensor,  # [B,Q,Hq,D]: Q candidate positions per row
    k_pool: torch.Tensor,  # [P,Hkv,page,D] — or [L,P,Hkv,page,D] with layer
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32: cached tokens (candidates excluded)
    offsets: torch.Tensor,  # [B] int32: absolute position of query 0
    *,
    layer: Layer = None,
) -> Parts:
    """Multi-query unnormalised parts over each row's cached pages, query
    j cut at ``kpos < min(lengths[b], offsets[b] + j + 1)``: ``(acc
    [B,Q,Hkv,G,D], m [B,Q,Hkv,G], l [B,Q,Hkv,G])``."""
    name = "cuda_paged_decode_attention_mq_parts"
    k_pool, v_pool = _select_layer(name, layer, k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_mq_attention_reference(q, k_pool, v_pool, page_table, lengths, offsets)
    _require(k_pool.dtype == v_pool.dtype == q.dtype, f"{name}: pools must be in q's dtype")
    return _launch_mq_parts(name, cuda_paged_decode_attention_mq_parts, q, k_pool, v_pool, None,
                            None, page_table, lengths, offsets)


def cuda_paged_decode_attention_mq_parts_int8(
    q: torch.Tensor,  # [B,Q,Hq,D]
    k_pool: torch.Tensor,  # [P,Hkv,page,D] int8 codes — or [L,P,...] with layer
    k_scale: torch.Tensor,  # [P,Hkv,page] f32 — or [L,P,Hkv,page]
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    page_table: torch.Tensor,  # [B,Jmax] int32
    lengths: torch.Tensor,  # [B] int32
    offsets: torch.Tensor,  # [B] int32
    *,
    layer: Layer = None,
) -> Parts:
    """The multi-query parts over an int8 pool, scales folded as in
    :func:`cuda_paged_decode_attention_parts_int8`."""
    name = "cuda_paged_decode_attention_mq_parts_int8"
    k_pool, k_scale, v_pool, v_scale = _select_layer(name, layer, k_pool, k_scale, v_pool, v_scale)
    if q.device.type == "cpu":
        return paged_mq_attention_int8_reference(
            q, k_pool, k_scale, v_pool, v_scale, page_table, lengths, offsets
        )
    _check_int8_pool(name, k_pool, k_scale, v_pool, v_scale)
    return _launch_mq_parts(name, cuda_paged_decode_attention_mq_parts_int8, q, k_pool, v_pool,
                            k_scale, v_scale, page_table, lengths, offsets)


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
