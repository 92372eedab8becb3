"""Wrappers of the Hopper attention kernels (``csrc/attention.cu``).

Counterpart of the JAX package's ``ops/pallas_attention.py``, with its
signatures and layouts. A tensor on the CPU goes to the plain version in
``ops/attention.py`` (that is how the CPU tests run); a CUDA tensor
launches the kernel or raises — there is no fallback. Each wrapper counts
its launches in an integer ``launches`` attribute (one per kernel launch),
so a run can show that its main path went through the kernels. A kernel's
cap on the query heads per kv head never reaches a caller: the wrappers
cut a larger group into sub-groups (:func:`tile_groups`).
"""

from __future__ import annotations

import torch

from . import _kernels
from .attention import (
    decode_attention_int8_reference,
    decode_attention_reference,
    prefill_attention_cached,
)

HEAD_DIMS = (64, 96, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The split kernels size their grids so that the blocks cover the card's
# 132 SMs about twice.
_TARGET_BLOCKS = 264
# The one-launch decode body (``decode_tile_kernel`` of B2, B3 and B6):
# positions per split at least, and splits per (row, kv head) at most
# (kDcMinSplit and kDcMaxSplits of ``csrc/decode_common.cuh``).
_DECODE_MIN_SPLIT = 64
_DECODE_MAX_SPLITS = 128


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_inputs(name: str, q: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Device, dtype and layout checks shared by the wrappers; returns the
    dtype code the C interface takes."""
    _require(q.device.type == "cuda", f"{name}: tensors must be on the CPU or a CUDA device, got {q.device}")
    _require(q.dtype in _DTYPE_CODES, f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    for t in (q, *tensors):
        _require(t.device == q.device, f"{name}: all tensors must be on {q.device}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
    _require(q.shape[-1] in HEAD_DIMS, f"{name}: head dim {q.shape[-1]} not in {HEAD_DIMS}")
    return _DTYPE_CODES[q.dtype]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels of ``attention.cu`` copy K/V rows (and prefill's q rows)
    16 bytes at a time: the data must start on a 16-byte boundary."""
    for t in tensors:
        _require(t.data_ptr() % 16 == 0, f"{name}: q, k and v must start on a 16-byte boundary")


def decode_grid(batch: int, hkv: int, capacity: int) -> int:
    """Blocks per (row, kv head) of the one-launch decode grid (B2, B3 over
    a cache of ``capacity`` = T positions, B6 over ``Jmax·page``): enough
    that ``B·Hkv·n`` blocks cover the card about twice, none starting past
    the capacity. Each block sizes its row's splits from ``lengths[b]`` on
    the device; blocks past a row's splits exit at once."""
    pairs = max(1, batch * hkv)
    n = min(_DECODE_MAX_SPLITS, -(-_TARGET_BLOCKS // pairs))
    return max(1, min(n, -(-max(capacity, 1) // _DECODE_MIN_SPLIT)))


def tile_groups(run, q: torch.Tensor, hkv: int, group_max: int):
    """Run ``run`` on sub-groups of at most ``group_max`` of the G = Hq / Hkv
    query heads of each kv head, against the same cache or pool, and
    stitch the results along G. ``q [..., Hq, D]``; ``run(q_sub)`` takes
    ``q_sub [..., Hkv·c, D]`` and returns either attention in q_sub's
    shape or parts ``(acc [..., Hkv, c, D], m [..., Hkv, c], l [..., Hkv,
    c])``. Every head's softmax is its own, so the result is the one-launch
    result."""
    *lead, hq, d = q.shape
    group = hq // hkv
    if group <= group_max:
        return run(q)
    qg = q.reshape(*lead, hkv, group, d)
    outs = [
        run(qg[..., g0 : g0 + group_max, :].reshape(*lead, -1, d).contiguous())
        for g0 in range(0, group, group_max)
    ]
    if isinstance(outs[0], tuple):  # (acc, m, l): G is acc's axis -2, m's and l's -1
        return tuple(torch.cat(xs, dim=-2 if i == 0 else -1) for i, xs in enumerate(zip(*outs)))
    return torch.cat([o.reshape(*lead, hkv, -1, d) for o in outs], dim=-2).reshape(q.shape)


def cuda_prefill_attention(
    q: torch.Tensor,  # [B,S,Hq,D]
    k_cache: torch.Tensor,  # [B,Hkv,T,D]
    v_cache: torch.Tensor,
    offset: int,  # cache position of q[:, 0]
) -> torch.Tensor:
    """Blockwise-causal flash prefill of S queries against a cache that
    already holds the chunk's own K/V; mask ``kpos <= offset + i``."""
    offset = int(offset)
    if q.device.type == "cpu":
        return prefill_attention_cached(q, k_cache, v_cache, offset)
    name = "cuda_prefill_attention"
    code = _check_inputs(name, q, k_cache, v_cache)
    b, s, hq, d = q.shape
    _, hkv, t, _ = k_cache.shape
    _require(
        k_cache.shape == v_cache.shape == (b, hkv, t, d) and k_cache.dtype == v_cache.dtype == q.dtype,
        f"{name}: caches must be [B,Hkv,T,D] in q's dtype",
    )
    _require(hq % hkv == 0, f"{name}: Hq must be a multiple of Hkv")
    _require(0 <= offset and offset + s <= t, f"{name}: offset + S exceeds the cache")
    _require_aligned(name, q, k_cache, v_cache)
    lib = _kernels.library()

    def launch(qs: torch.Tensor) -> torch.Tensor:
        hq_s = qs.shape[2]
        n_split = lib.attn_prefill_splits(code, b, s, hq_s, hkv, d, offset)
        part_o = part_ml = None
        if n_split > 1:  # the key range split over blocks, then a merge launch
            rows = lib.attn_prefill_rows()
            n_tiles = -(-s // (rows // (hq_s // hkv))) * b * hkv
            part_o = torch.empty((n_tiles, n_split, rows, d), dtype=torch.float32, device=q.device)
            part_ml = torch.empty((n_tiles, n_split, rows, 2), dtype=torch.float32, device=q.device)
        out = torch.empty_like(qs)
        err = lib.attn_prefill(
            code, qs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (part_o, part_ml)),
            b, s, hq_s, hkv, t, d, offset, n_split, _stream(q),
        )
        _kernels.check(err, name)
        cuda_prefill_attention.launches += 1
        return out

    return tile_groups(launch, q, hkv, lib.attn_prefill_rows())


def _launch_decode(name, wrapper, q, k, v, k_scale, v_scale, lengths) -> torch.Tensor:
    code = _check_inputs(name, q, k, v, lengths, *(x for x in (k_scale, v_scale) if x is not None))
    b, hq, d = q.shape
    _, hkv, t, _ = k.shape
    _require(k.shape == v.shape == (b, hkv, t, d), f"{name}: caches must be [B,Hkv,T,D]")
    _require(hq % hkv == 0, f"{name}: Hq must be a multiple of Hkv")
    _require(lengths.shape == (b,) and lengths.dtype == torch.int32, f"{name}: lengths must be int32 [B]")
    _require_aligned(name, k, v)
    lib = _kernels.library()
    n_grid = decode_grid(b, hkv, t)
    tickets = _kernels.tickets(q.device, b * hkv)

    def launch(qs: torch.Tensor) -> torch.Tensor:
        group = qs.shape[1] // hkv
        part_acc = torch.empty((b * hkv, n_grid, group, d), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b * hkv, n_grid, group, 2), dtype=torch.float32, device=q.device)
        out = torch.empty_like(qs)
        err = lib.attn_decode(
            code, qs.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            lengths.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), b, qs.shape[1], hkv, t, d, n_grid, _stream(q),
        )
        _kernels.check(err, name)
        wrapper.launches += 1
        return out

    return tile_groups(launch, q, hkv, lib.attn_decode_group_max())


def cuda_decode_attention(
    q: torch.Tensor,  # [B,Hq,D]
    k_cache: torch.Tensor,  # [B,Hkv,T,D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Flash-decode attention over the valid prefix ``t < lengths[b]``."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths)
    name = "cuda_decode_attention"
    _require(k_cache.dtype == v_cache.dtype == q.dtype, f"{name}: caches must be in q's dtype")
    return _launch_decode(name, cuda_decode_attention, q, k_cache, v_cache, None, None, lengths)


def cuda_decode_attention_int8(
    q: torch.Tensor,  # [B,Hq,D]
    k_q: torch.Tensor,  # [B,Hkv,T,D] int8
    k_s: torch.Tensor,  # [B,Hkv,T] f32
    v_q: torch.Tensor,  # [B,Hkv,T,D] int8
    v_s: torch.Tensor,  # [B,Hkv,T] f32
    lengths: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Flash-decode attention over an int8 cache: scales fold into the
    scores (K) and probabilities (V); no dequantized cache is built."""
    if q.device.type == "cpu":
        return decode_attention_int8_reference(q, k_q, k_s, v_q, v_s, lengths)
    name = "cuda_decode_attention_int8"
    _require(k_q.dtype == v_q.dtype == torch.int8, f"{name}: codes must be int8")
    _require(
        k_s.dtype == v_s.dtype == torch.float32 and k_s.shape == v_s.shape == k_q.shape[:3],
        f"{name}: scales must be float32 [B,Hkv,T]",
    )
    return _launch_decode(name, cuda_decode_attention_int8, q, k_q, v_q, k_s, v_s, lengths)


cuda_prefill_attention.launches = 0
cuda_decode_attention.launches = 0
cuda_decode_attention_int8.launches = 0

# Every kernel wrapper of this module, for code that resets or reads counts.
KERNELS = (cuda_prefill_attention, cuda_decode_attention, cuda_decode_attention_int8)
