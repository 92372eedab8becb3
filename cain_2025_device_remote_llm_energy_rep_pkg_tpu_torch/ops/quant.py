"""Plain PyTorch versions of the int4 weight matmuls (kernels B9, B10, B11).

Counterparts of the JAX package's ``ops/pallas_quant.py`` contract, which
the Hopper kernels of ``csrc/int4_matmul.cu`` keep too:

- ``x`` is rounded to bf16 before the product, even when it is float32;
- the 4-bit weights are exact (|w| <= 7);
- the products are summed in float32;
- the per-output-channel scale is applied once, after the k-sum;
- the result is cast once to ``x.dtype``.

Two packings of the input-feature axis (``models/quantize.py``):

- halves, ``q4 [IN/2, OUT] int8``: packed row i holds weight row i in its
  low nibble and row i + IN/2 in its high nibble;
- int32 lanes, ``q32 [IN/8, OUT] int32``: nibble p of lane k is weight
  row 8k + p.

B11, the w4a8 product of the JAX package's ``scripts/w4a8_probe.py``, has
a contract of its own (:func:`w4a8_matmul_reference`): ``x`` is quantized
per row to int8 codes, the products of codes and nibbles are summed in
int32 (exactly), and both scales are applied at the end.

These run on any device; the wrappers in ``ops/cuda_quant.py`` call them
for CPU tensors only, and ``chip_smoke.py`` holds the kernels against them
on the card.
"""

from __future__ import annotations

import torch

# Rows of x (B·S) up to which a decode-shaped matmul takes the kernel route.
MAX_KERNEL_ROWS = 8


def int4_matmul_supported(m: int, in_half: int, out_dim: int) -> bool:
    """The JAX package's routing gate for the halves layout, kept so that
    the port rounds ``x`` to bf16 on exactly the matmuls where it does.
    The Hopper kernel itself takes any even IN, any OUT and 1 <= M <= 8."""
    return m <= MAX_KERNEL_ROWS and in_half % 32 == 0 and out_dim % 128 == 0


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Halves-packed ``[..., IN/2, OUT] int8`` → codes ``[..., IN, OUT]``
    int8 in [-8, 7]. Arithmetic shifts on int8 sign-extend each nibble."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    return torch.cat([lo, hi], dim=-2)


def unpack_int4_i32(packed: torch.Tensor) -> torch.Tensor:
    """int32-lane ``[..., IN/8, OUT]`` → codes ``[..., IN, OUT]`` int32;
    nibble p of a lane is sign-extended by ``(w << (28 - 4p)) >> 28``."""
    planes = [
        torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 28 - 4 * p), 28)
        for p in range(8)
    ]
    q = torch.stack(planes, dim=-2)  # [..., IN/8, 8, OUT]
    return q.reshape(*packed.shape[:-2], packed.shape[-2] * 8, packed.shape[-1])


def _matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xb = x.to(torch.bfloat16).to(torch.float32)
    acc = torch.matmul(xb, codes.to(torch.float32))
    return (acc * scale.to(torch.float32)).to(x.dtype)


def int4_matmul_reference(
    x: torch.Tensor,  # [M, IN] bf16 or f32
    packed: torch.Tensor,  # [IN/2, OUT] int8, halves layout
    scale: torch.Tensor,  # [1, OUT] f32
) -> torch.Tensor:
    """``x @ (unpack(packed) · scale)`` → ``[M, OUT]`` in ``x.dtype``."""
    return _matmul(x, unpack_int4(packed), scale)


def int4_matmul_i32_reference(
    x: torch.Tensor,  # [M, IN]
    packed32: torch.Tensor,  # [IN/8, OUT] int32, 8 nibbles per lane
    scale: torch.Tensor,  # [1, OUT] f32
) -> torch.Tensor:
    """The same product over int32 lanes of 8 k-consecutive nibbles."""
    return _matmul(x, unpack_int4_i32(packed32), scale)


def quantize_activations_rowwise(x: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """``x [M, IN]`` → ``(xq int8 [M, IN], sx f32 [M, 1])``, the w4a8
    probe's math: ``sx = max|x| / 127`` per row (the max taken in x's
    dtype, then widened), ``xq = clip(round(x / sx), -127, 127)`` with
    ``x / sx`` in f32 and ties rounded to even. Both divisions are by a
    tensor: a CUDA tensor divided by a Python scalar is multiplied by the
    scalar's reciprocal, which the probe's eager call does not do."""
    amax = torch.amax(torch.abs(x), dim=1, keepdim=True).to(torch.float32)
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return xq, sx


def w4a8_matmul_reference(
    x: torch.Tensor,  # [M, IN] bf16 or f32
    packed: torch.Tensor,  # [IN/2, OUT] int8, halves layout
    scale: torch.Tensor,  # [1, OUT] f32
) -> torch.Tensor:
    """The w4a8 product, f32 ``[M, OUT]``: codes of x (low nibbles times
    ``xq[:, :IN/2]``, high nibbles times ``xq[:, IN/2:]``) summed in int32,
    then ``acc * scale * sx`` in that order. The integer sum runs as a
    float64 matmul, which is exact for these magnitudes and, unlike an
    int32 matmul, runs on CUDA too."""
    xq, sx = quantize_activations_rowwise(x)
    acc = torch.matmul(xq.to(torch.float64), unpack_int4(packed).to(torch.float64))
    return acc.to(torch.int32).to(torch.float32) * scale.to(torch.float32) * sx
