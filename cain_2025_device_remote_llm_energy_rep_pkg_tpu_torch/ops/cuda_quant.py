"""Wrappers of the Hopper int4 weight matmul kernels (``csrc/int4_matmul.cu``).

Counterparts of the JAX package's ``int4_matmul`` (halves layout, ``q4
[IN/2, OUT] int8``) and ``int4_matmul_i32`` (``q32 [IN/8, OUT] int32``),
with their signatures: ``x [M, IN]`` bf16 or f32 with 1 <= M <= 8, scale
``[1, OUT]`` f32, result ``[M, OUT]`` in ``x.dtype``; and of the w4a8
probe's ``w4a8_matmul`` (same weights, x quantized per row to int8 codes
inside the kernel, int32 sums, f32 result). The contracts are stated in
``ops/quant.py``.

A tensor on the CPU goes to the plain version in ``ops/quant.py``; a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
an integer ``launches`` attribute.
"""

from __future__ import annotations

import torch

from . import _kernels
from .cuda_attention import _DTYPE_CODES, _require, _stream
from .quant import (
    MAX_KERNEL_ROWS,
    int4_matmul_i32_reference,
    int4_matmul_reference,
    w4a8_matmul_reference,
)

_LIB = "int4_matmul"
_TILE_COLS = 128  # output columns per block (B9, B10, B11: 8 lane groups × 16)

# B9 and B10 (int4_mma_kernel, int4_i32_mma_kernel): at most one block per
# SM of the card's 132 unless the column tiles alone are more, in splits of
# 256 to 2,048 weight rows (two k-steps for each of the 8 warps at least;
# at most the x slice the kernels stage in shared memory, which they
# refuse past), in whole k-steps. A packed row is 2 weight rows in the
# halves layout (B9, k-steps of 8 packed rows) and 8 in the int32-lane
# layout (B10, k-steps of 4). More, shorter splits were slower at every
# shape swept (scripts/torch_int4_split_sweep.py): each adds a partial to
# write and merge, and the weights' load latency does not shrink with the
# spread.
_MMA_TARGET_BLOCKS = 132
_MMA_MIN_SPLIT_WEIGHT_ROWS = 256
_MMA_MAX_SPLIT_WEIGHT_ROWS = 2048
_MMA_STEP_ROWS = {2: 8, 8: 4}  # packed rows per k-step, by weight rows per packed row
_MMA_VALUES = 8 * _TILE_COLS  # sums per block (128 columns × 8 rows): a split's partial


def _mma_split(k_rows: int, out_dim: int, per_row: int = 2,
               step: "int | None" = None) -> "tuple[int, int]":
    """B9's (``per_row`` 2) or B10's (``per_row`` 8) (n_split, split_rows)
    in packed rows: the packed rows cut into equal splits of whole k-steps
    (``step`` packed rows, by default the kernel's; the last split may be
    shorter), split only where the column tiles leave SMs of the card
    idle."""
    step = step or _MMA_STEP_ROWS[per_row]
    tiles = -(-out_dim // _TILE_COLS)
    want = max(1, _MMA_TARGET_BLOCKS // tiles)
    rows = max(-(-k_rows // want), _MMA_MIN_SPLIT_WEIGHT_ROWS // per_row)
    rows = min(-(-rows // step) * step, _MMA_MAX_SPLIT_WEIGHT_ROWS // per_row)
    return -(-k_rows // rows), rows


def _tickets_needed(out_dim: int, n_split: int) -> int:
    """B9's, B10's and B11's tickets: one per column tile where the packed
    rows are split (the last split of a tile to finish merges), none
    otherwise."""
    return -(-out_dim // _TILE_COLS) if n_split > 1 else 0


def _check(name: str, x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
           per_row: int, code_dtype: torch.dtype) -> None:
    """The shape contract, on every device."""
    _require(x.dim() == 2 and packed.dim() == 2, f"{name}: x must be [M, IN] and the codes 2-D")
    m, in_dim = x.shape
    k_rows, out_dim = packed.shape
    _require(1 <= m <= MAX_KERNEL_ROWS, f"{name}: x has {m} rows, the kernel takes 1 to {MAX_KERNEL_ROWS}")
    _require(in_dim == per_row * k_rows, f"{name}: x in-dim {in_dim} != {per_row} * packed rows {k_rows}")
    _require(packed.dtype == code_dtype, f"{name}: codes must be {code_dtype}, got {packed.dtype}")
    _require(scale.numel() == out_dim, f"{name}: scale must hold one value per output column")


def _check_cuda(name: str, x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> None:
    """Device, dtype and layout checks before a launch."""
    _require(x.device.type == "cuda", f"{name}: tensors must be on the CPU or a CUDA device, got {x.device}")
    _require(x.dtype in _DTYPE_CODES, f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    _require(scale.dtype == torch.float32, f"{name}: scale must be float32, got {scale.dtype}")
    for t in (x, packed, scale):
        _require(t.device == x.device, f"{name}: all tensors must be on {x.device}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")


def _launch_mma(name: str, x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                split: "tuple[int, int] | None" = None) -> torch.Tensor:
    """B9's (int8 halves codes) or B10's (int32 lanes) one launch;
    ``split`` = (n_split, split_rows) in place of :func:`_mma_split`'s,
    for sweeps of the rule."""
    _check_cuda(name, x, packed, scale)
    m, in_dim = x.shape
    k_rows, out_dim = packed.shape
    per_row = in_dim // k_rows
    n_split, split_rows = split or _mma_split(k_rows, out_dim, per_row)
    dev = x.device
    out = torch.empty((m, out_dim), dtype=x.dtype, device=dev)
    n_tickets = _tickets_needed(out_dim, n_split)
    partial = tickets = None
    if n_tickets:  # split partials in the kernel's own layout
        partial = torch.empty((n_split, n_tickets, _MMA_VALUES), dtype=torch.float32, device=dev)
        tickets = _kernels.tickets(dev, n_tickets)
    entry = _kernels.library(_LIB).int4_matmul if per_row == 2 else _kernels.library(_LIB).int4_matmul_i32
    err = entry(
        _DTYPE_CODES[x.dtype], x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (partial, tickets)), out.data_ptr(),
        m, in_dim, k_rows, out_dim, n_split, split_rows, _stream(x),
    )
    _kernels.check(err, name, _LIB)
    return out


def cuda_int4_matmul(
    x: torch.Tensor,  # [M, IN] bf16/f32, M <= 8
    packed: torch.Tensor,  # [IN/2, OUT] int8, halves layout
    scale: torch.Tensor,  # [1, OUT] f32
) -> torch.Tensor:
    """``x @ (unpack(packed) · scale)`` on the tensor cores, the nibbles
    turned into bf16 in registers; one launch."""
    name = "cuda_int4_matmul"
    _check(name, x, packed, scale, 2, torch.int8)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale)
    out = _launch_mma(name, x, packed, scale)
    cuda_int4_matmul.launches += 1
    return out


def cuda_int4_matmul_i32(
    x: torch.Tensor,  # [M, IN] bf16/f32, M <= 8
    packed32: torch.Tensor,  # [IN/8, OUT] int32, 8 nibbles per lane
    scale: torch.Tensor,  # [1, OUT] f32
) -> torch.Tensor:
    """The same product over int32 lanes of 8 k-consecutive nibbles, on
    the tensor cores through B9's parts; one launch."""
    name = "cuda_int4_matmul_i32"
    _check(name, x, packed32, scale, 8, torch.int32)
    if x.device.type == "cpu":
        return int4_matmul_i32_reference(x, packed32, scale)
    out = _launch_mma(name, x, packed32, scale)
    cuda_int4_matmul_i32.launches += 1
    return out


# The w4a8 probe's packed-row blocks: IN/2 must be a multiple of this, as
# its JAX wrapper demands.
W4A8_BLOCK_ROWS = 128
# B11 (w4a8_mma_kernel): B9's rule in B11's 16-row k-steps. Every block
# reads all of x for its rows' max, yet the sweep (scripts/
# torch_int4_split_sweep.py --layout w4a8, NVIDIA H100 80GB HBM3, 700.00 W,
# M 1 and 8) found B9's rule best or within 4% of the best split at every
# shape. At M 8: the probe's (1536 -> 8960) one split of 768 rows
# 0.01621 ms (256 rows 0.01618, 16 rows 0.06622); llama3.1:8b's w_gate two
# splits of 1,024 0.02831 (one of 2,048 0.02909, 256 rows 0.04064);
# qwen2's wk six of 128 0.01172 (1,024 rows 0.01427). Shorter splits
# re-read x and add partials; longer ones leave SMs idle.
_W4A8_STEP_ROWS = 16


def _w4a8_split(k_rows: int, out_dim: int) -> "tuple[int, int]":
    """B11's (n_split, split_rows) in packed rows: B9's rule in whole
    16-row k-steps (128 to 1,024 packed rows a split)."""
    return _mma_split(k_rows, out_dim, step=_W4A8_STEP_ROWS)


def _launch_w4a8(name: str, x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 split: "tuple[int, int] | None" = None) -> torch.Tensor:
    """B11's one launch, x quantized inside it; ``split`` = (n_split,
    split_rows) in place of :func:`_w4a8_split`'s, for sweeps of the
    rule."""
    _check_cuda(name, x, packed, scale)
    m, in_dim = x.shape
    k_rows, out_dim = packed.shape
    n_split, split_rows = split or _w4a8_split(k_rows, out_dim)
    dev = x.device
    out = torch.empty((m, out_dim), dtype=torch.float32, device=dev)
    n_tickets = _tickets_needed(out_dim, n_split)
    partial = tickets = None
    if n_tickets:  # split partials (int32) in the kernel's own layout
        partial = torch.empty((n_split, n_tickets, _MMA_VALUES), dtype=torch.int32, device=dev)
        tickets = _kernels.tickets(dev, n_tickets)
    err = _kernels.library(_LIB).w4a8_matmul(
        _DTYPE_CODES[x.dtype], x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (partial, tickets)), out.data_ptr(),
        m, in_dim, k_rows, out_dim, n_split, split_rows, _stream(x),
    )
    _kernels.check(err, name, _LIB)
    return out


def cuda_w4a8_matmul(
    x: torch.Tensor,  # [M, IN] bf16/f32, M <= 8
    packed: torch.Tensor,  # [IN/2, OUT] int8, halves layout
    scale: torch.Tensor,  # [1, OUT] f32
) -> torch.Tensor:
    """The w4a8 product, f32 ``[M, OUT]``, in one launch: x quantized per
    row inside the kernel, int8 codes times int4 nibbles summed in int32 on
    the tensor cores, and both scales applied in its epilogue."""
    name = "cuda_w4a8_matmul"
    _check(name, x, packed, scale, 2, torch.int8)
    _require(
        packed.shape[0] % W4A8_BLOCK_ROWS == 0,
        f"{name}: IN/2 = {packed.shape[0]} is not a multiple of {W4A8_BLOCK_ROWS}",
    )
    if x.device.type == "cpu":
        return w4a8_matmul_reference(x, packed, scale)
    out = _launch_w4a8(name, x, packed, scale)
    cuda_w4a8_matmul.launches += 1
    return out


cuda_int4_matmul.launches = 0
cuda_int4_matmul_i32.launches = 0
cuda_w4a8_matmul.launches = 0

# Every kernel wrapper of this module, for code that resets or reads counts.
KERNELS = (cuda_int4_matmul, cuda_int4_matmul_i32, cuda_w4a8_matmul)
