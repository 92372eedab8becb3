"""The logic the one-launch kernels B4/B5 (paged decode parts), B6
(write-through paged decode), B9 (int4 matmul, halves layout), B10 (int4
matmul, int32 lanes), B11 (the w4a8 matmul) and B7/B8 (multi-query paged
verify) rest on, pinned on the CPU, where the kernels cannot run:

- B9's nibble → bf16 conversion (each nibble, biased by 8, ORed into the
  mantissa of 128.0, then 136 subtracted), emulated in numpy bit for bit,
  is exact over every byte;
- B9's fragment order (the k pair of an mma register is the low and high
  nibble of one packed byte, x staged in the same order; a lane's 16-byte
  load feeds eight mmas), emulated in torch through the PTX layouts of
  ``mma.sync.m16n8k16``, gives ``int4_matmul_reference`` bit for bit;
- B10's fragment order (a quad's four lanes on four consecutive packed
  rows of the same 4 columns, one byte a k pair, x staged in natural k
  order), emulated the same way, gives ``int4_matmul_i32_reference`` bit
  for bit;
- B11's quantization inside the kernel (the row's max, then each code by
  IEEE division, ties to even, 0/0 to 0), emulated in numpy, gives
  ``quantize_activations_rowwise``'s codes and scales bit for bit; its s8
  fragment order (the k quads of an ``mma.sync.m16n8k32`` register are
  four packed rows' low or high nibbles ×16 of one column, the codes
  staged in the same order, 16 divided out at the end), emulated through
  the PTX layout, gives ``w4a8_matmul_reference`` bit for bit;
- B7's tiling (q-tiles of 64 // G positions, splits sized from each
  q-tile's frontier, an online softmax per split in log2 units, the last
  split merging into natural units), emulated in torch, gives
  ``paged_mq_attention_reference``;
- B4/B5's body (``decode_tile_kernel`` through the page table: splits
  sized from each row's length, tiles of 32 positions with a per-tile
  max, the four warps' sums, the last split merging into unnormalised
  parts), emulated in torch, gives the JAX package's Pallas parts kernels
  (interpret mode);
- the wrappers' grid, split and ticket rules, as pure functions, at the
  shapes ``chip_smoke.py`` drives.

The kernels themselves are held against their plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu.ops import pallas_paged_attention as jpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import (
    quantize_kv_vector,
    quantize_tensor_int4,
    quantize_tensor_int4_i32,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import _kernels, cuda_attention, cuda_quant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_paged_attention as cpa
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.attention import (
    paged_mq_attention_int8_reference,
    paged_mq_attention_reference,
)
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.quant import (
    int4_matmul_i32_reference,
    int4_matmul_reference,
    quantize_activations_rowwise,
    w4a8_matmul_reference,
)
from test_torch_runner import one_torch_thread  # noqa: F401  (one intra-op thread a module)

MAGIC = 0x43084308  # bf16x2 {136.0, 136.0}; 0x4300 is 128.0, whose ulp is 1


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm``: byte n of the result is byte ``sel``'s
    nibble n of the 8 bytes of (y:x)."""
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 0x7] << (8 * n)
    return out


def _bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _nibbles_bf16x2(w, c):
    """The kernel's ``nibbles_bf16x2<c>(w, w >> 4)`` on uint32 words:
    (low half, high half) as float32, the subtraction of 136 done on the
    bf16 values (exact when the result is, which the first test checks)."""
    w = w.astype(np.uint32)
    sel = c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12)
    biased = (_byte_perm(w, w >> np.uint32(4), sel) & np.uint32(0x000F000F)) ^ np.uint32(MAGIC)
    lo = _bf16_bits_to_f32((biased & 0xFFFF).astype(np.uint16)) - np.float32(136.0)
    hi = _bf16_bits_to_f32((biased >> 16).astype(np.uint16)) - np.float32(136.0)
    return lo, hi


def test_nibble_to_bf16_magic_conversion_is_exact_for_every_code():
    """Every byte, in each of the four byte slots of a word: the low and
    high halves are exactly the sign-extended low and high nibbles, the
    biased values 128 + (v + 8) are exact bf16 numbers (so 136 subtracts
    exactly), and a zero byte gives exactly 0."""
    codes = np.arange(256, dtype=np.uint32)
    lo_want = ((codes & 0xF) ^ 8).astype(np.int32) - 8
    hi_want = ((codes >> 4) ^ 8).astype(np.int32) - 8
    assert sorted(set(lo_want.tolist())) == list(range(-8, 8))
    for c in range(4):
        # byte c of each word is the code; the other bytes are noise
        noise = np.random.default_rng(c).integers(0, 256, (3, 256), dtype=np.uint32)
        others = [n for n in range(4) if n != c]
        words = codes << np.uint32(8 * c)
        for j, n in enumerate(others):
            words |= noise[j] << np.uint32(8 * n)
        lo, hi = _nibbles_bf16x2(words, c)
        assert np.array_equal(lo, lo_want.astype(np.float32))
        assert np.array_equal(hi, hi_want.astype(np.float32))
    biased = 128 + np.arange(16)  # 128 + (v + 8) for v in -8..7
    bits = (0x4300 | np.arange(16)).astype(np.uint16)
    assert np.array_equal(_bf16_bits_to_f32(bits), biased.astype(np.float32))
    zero_lo, zero_hi = _nibbles_bf16x2(np.zeros(1, dtype=np.uint32), 0)
    assert zero_lo[0] == 0.0 and zero_hi[0] == 0.0


def _emulate_b9(x, packed, scale):
    """B9's arithmetic in f32, through its fragment layout: per column
    tile and k-step, every lane's A registers (from its two 16-byte loads
    of packed rows 8s + t and 8s + t + 4, columns 16g..16g+15) and B
    registers (x staged as bf16 pairs (x[m, i], x[m, K + i])) are placed
    into the 16×16 A and 16×8 B matrices as ``mma.sync.m16n8k16`` reads
    them, C = A·B, and C's fragments go back to output columns and rows
    as the kernel's epilogue writes them."""
    m_rows, _ = x.shape
    k_rows, out_dim = packed.shape
    xb = x.to(torch.bfloat16).float()
    steps = -(-k_rows // 8)
    # staged x: xs[m, i] = (x[m, i], x[m, K + i]); rows m >= M and i >= K are 0
    xs_lo = torch.zeros(8, steps * 8)
    xs_hi = torch.zeros(8, steps * 8)
    xs_lo[:m_rows, :k_rows] = xb[:, :k_rows]
    xs_hi[:m_rows, :k_rows] = xb[:, k_rows:]
    pk = packed.numpy().view(np.uint8).astype(np.uint32)
    tiles = -(-out_dim // 128)
    out = torch.zeros(m_rows, tiles * 128)
    for tile in range(tiles):
        acc = torch.zeros(32, 8, 4)  # [lane, mma u, c]
        for s in range(steps):
            a = torch.zeros(8, 16, 16)  # [mma u, A row, k]
            b = torch.zeros(16, 8)  # [k, n]
            for lane in range(32):
                g, t = lane // 4, lane % 4
                col = tile * 128 + 16 * g
                chunks = []
                for r in (8 * s + t, 8 * s + t + 4):  # packed rows j = t, t + 4
                    chunk = np.zeros(16, dtype=np.uint32)
                    if r < k_rows:
                        row = pk[r, col : min(col + 16, out_dim)]
                        chunk[: len(row)] = row
                    chunks.append(chunk.reshape(4, 4))  # [word q, byte]
                words = [(ch[:, 0] | ch[:, 1] << 8 | ch[:, 2] << 16 | ch[:, 3] << 24) for ch in chunks]
                for u in range(8):
                    q, e = u // 2, u % 2
                    regs = [
                        _nibbles_bf16x2(words[0][q : q + 1], 2 * e),  # A row g, k 2t, 2t+1
                        _nibbles_bf16x2(words[0][q : q + 1], 2 * e + 1),  # A row g + 8
                        _nibbles_bf16x2(words[1][q : q + 1], 2 * e),  # A row g, k 2t+8, 2t+9
                        _nibbles_bf16x2(words[1][q : q + 1], 2 * e + 1),  # A row g + 8
                    ]
                    for reg, (row, k0) in zip(regs, ((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8), (g + 8, 2 * t + 8))):
                        a[u, row, k0] = float(reg[0][0])
                        a[u, row, k0 + 1] = float(reg[1][0])
                b[2 * t, g] = xs_lo[g, 8 * s + t]
                b[2 * t + 1, g] = xs_hi[g, 8 * s + t]
                b[2 * t + 8, g] = xs_lo[g, 8 * s + t + 4]
                b[2 * t + 9, g] = xs_hi[g, 8 * s + t + 4]
            c = torch.matmul(a, b)  # [u, 16, 8]
            for lane in range(32):
                g, t = lane // 4, lane % 4
                acc[lane, :, 0] += c[:, g, 2 * t]
                acc[lane, :, 1] += c[:, g, 2 * t + 1]
                acc[lane, :, 2] += c[:, g + 8, 2 * t]
                acc[lane, :, 3] += c[:, g + 8, 2 * t + 1]
        # value c of (lane, mma u): column 16g + 2u + c // 2, row 2t + c % 2
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for u in range(8):
                for ci in range(4):
                    m = 2 * t + ci % 2
                    if m < m_rows:
                        out[m, tile * 128 + 16 * g + 2 * u + ci // 2] = acc[lane, u, ci]
    return out[:, :out_dim] * scale.float()


@pytest.mark.parametrize("m,in_dim,out_dim", [(3, 64, 40), (8, 96, 200), (1, 20, 7)])
def test_b9_fragment_order_equals_the_plain_version_bit_for_bit(m, in_dim, out_dim):
    """The emulation against ``int4_matmul_reference`` in f32, bit for bit.
    x holds small dyadic values (exact in bf16; every product and partial
    sum is exact in f32), so any summation order gives the same bits and
    the comparison checks only which weight meets which x. OUT 40, 200
    and 7 leave a ragged column tile; K 10 a ragged k-step."""
    rng = np.random.default_rng(in_dim + out_dim)
    w = torch.from_numpy((rng.standard_normal((in_dim, out_dim)) / np.sqrt(in_dim)).astype(np.float32))
    leaf = quantize_tensor_int4(w)
    x = torch.from_numpy(rng.integers(-16, 17, (m, in_dim)).astype(np.float32) / 8)
    want = int4_matmul_reference(x, leaf["q4"], leaf["s"])
    got = _emulate_b9(x, leaf["q4"], leaf["s"])
    assert torch.equal(got, want)


def _emulate_b10(x, packed32, scale):
    """B10's arithmetic in f32, through its fragment layout, split by the
    wrapper's rule: per split, column tile and k-step s, lane (g, t) holds
    packed row 4s + t at columns 32i + 4g .. 32i + 4g + 3 (load i); mma
    u = 2i + p takes columns 32i + 4g + 2p (A row g) and + 1 (A row g +
    8), byte 2e of each word as k pair slot t and byte 2e + 1 as slot t +
    4 of its e-th mma; B is x staged in natural k order (word j of a row
    = x pair 2j, 2j + 1), the lane reading words 4(4s + t) + 2e (b0) and
    + 1 (b1). The mmas run as ``mma.sync.m16n8k16`` reads its fragments,
    and C goes back to columns and rows as the kernel's epilogue writes
    it; the splits' partials are added in split order."""
    m_rows, in_dim = x.shape
    k_rows, out_dim = packed32.shape
    xb = x.to(torch.bfloat16).float()
    n_split, split_rows = cuda_quant._mma_split(k_rows, out_dim, 8)
    tiles = -(-out_dim // 128)
    words_all = packed32.numpy().view(np.uint32)
    total = torch.zeros(m_rows, tiles * 128)
    for sp in range(n_split):
        r0 = sp * split_rows
        n_rows = min(split_rows, k_rows - r0)
        steps = -(-n_rows // 4)
        w = np.zeros((steps * 4, tiles * 128), dtype=np.uint32)  # zero past the rows and OUT
        w[:n_rows, :out_dim] = words_all[r0 : r0 + n_rows]
        # nib[j] = (low, high) nibble of byte j of every word, as bf16 values in f32
        nib = [tuple(torch.from_numpy(h.copy()) for h in _nibbles_bf16x2(w, j)) for j in range(4)]
        xs = torch.zeros(8, steps * 32)  # staged x: weight rows 8·r0 ..
        xs[:m_rows, : 8 * n_rows] = xb[:, 8 * r0 : 8 * (r0 + n_rows)]
        # A [steps, tiles, u, e, 16, 16], B [steps, e, 16, 8]
        a = torch.zeros(steps, tiles, 8, 2, 16, 16)
        b = torch.zeros(steps, 2, 16, 8)
        s_idx = torch.arange(steps)
        for g in range(8):
            for t in range(4):
                rows = 4 * s_idx + t
                for e in range(2):
                    # x words 4(4s + t) + 2e and + 1: weight rows 8(4s + t) + 4e + 0..3
                    kx = 8 * rows + 4 * e
                    b[:, e, 2 * t, g] = xs[g, kx]
                    b[:, e, 2 * t + 1, g] = xs[g, kx + 1]
                    b[:, e, 2 * t + 8, g] = xs[g, kx + 2]
                    b[:, e, 2 * t + 9, g] = xs[g, kx + 3]
                for i in range(4):
                    for p in range(2):
                        u = 2 * i + p
                        cols = torch.arange(tiles) * 128 + 32 * i + 4 * g + 2 * p
                        for e in range(2):
                            for arow, c_off in ((g, 0), (g + 8, 1)):
                                rr, cc = rows[:, None], (cols + c_off)[None, :]
                                lo, hi = nib[2 * e]
                                a[:, :, u, e, arow, 2 * t] = lo[rr, cc]
                                a[:, :, u, e, arow, 2 * t + 1] = hi[rr, cc]
                                lo, hi = nib[2 * e + 1]
                                a[:, :, u, e, arow, 2 * t + 8] = lo[rr, cc]
                                a[:, :, u, e, arow, 2 * t + 9] = hi[rr, cc]
        c = torch.einsum("stuerk,sekn->turn", a, b)  # [tiles, u, 16, 8], summed over steps and e
        part = torch.zeros(m_rows, tiles * 128)
        for g in range(8):
            for t in range(4):
                for u in range(8):
                    for ci in range(4):
                        m = 2 * t + ci % 2
                        if m < m_rows:
                            col = torch.arange(tiles) * 128 + 32 * (u // 2) + 4 * g + 2 * (u % 2) + ci // 2
                            part[m, col] = c[:, u, g + 8 * (ci // 2), m]
        total = total + part
    return total[:, :out_dim] * scale.float()


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("in_dim,out_dim", [(1536, 256), (64, 7), (16, 200)])
def test_b10_fragment_order_equals_the_plain_version_bit_for_bit(m, in_dim, out_dim):
    """The emulation against ``int4_matmul_i32_reference`` in f32, bit for
    bit, on dyadic x (exact in bf16; every product and partial sum exact
    in f32, so only which weight meets which x can differ). qwen2's wk
    (1536 → 256) splits into 6, each ragged past its rows at no step
    boundary; OUT 7 and 200 leave a ragged column tile; IN 16 is 2
    packed rows, half a k-step."""
    rng = np.random.default_rng(in_dim * 7 + out_dim + m)
    w = torch.from_numpy((rng.standard_normal((in_dim, out_dim)) / np.sqrt(in_dim)).astype(np.float32))
    leaf = quantize_tensor_int4_i32(w)
    x = torch.from_numpy(rng.integers(-16, 17, (m, in_dim)).astype(np.float32) / 8)
    want = int4_matmul_i32_reference(x, leaf["q32"], leaf["s"])
    got = _emulate_b10(x, leaf["q32"], leaf["s"])
    assert torch.equal(got, want)


# (label, IN, OUT, splits) of chip_smoke.py's B9 rows.
INT4_SHAPES = [
    ("qwen2 w_gate/w_up", 1536, 8960, 1),
    ("qwen2 wq/wo", 1536, 1536, 6),
    ("qwen2 wk/wv", 1536, 256, 6),
    ("qwen2 w_down", 8960, 1536, 11),
    ("llama w_gate/w_up", 4096, 14336, 2),
    ("llama w_down", 14336, 4096, 7),
    ("llama wq/wo", 4096, 4096, 4),
    ("llama wk/wv", 4096, 1024, 16),
    ("odd", 96, 200, 1),
]


@pytest.mark.parametrize("label,in_dim,out_dim,splits", INT4_SHAPES, ids=[s[0] for s in INT4_SHAPES])
def test_b9_split_and_ticket_rule_at_the_chip_shapes(label, in_dim, out_dim, splits):
    """B9's splits: whole 8-row k-steps, at least 128 rows, within the
    kernel's 1,024-row x slice, covering the packed rows with no empty
    split, and no more (column tile, split) blocks than one per SM of the
    card's 132 unless the tiles alone are more or the x slice forces
    more; one ticket per column tile where split, none otherwise."""
    k_rows = in_dim // 2
    tiles = -(-out_dim // 128)
    n_split, rows = cuda_quant._mma_split(k_rows, out_dim)
    assert n_split == splits
    assert rows % 8 == 0 and 128 <= rows <= 1024
    assert (n_split - 1) * rows < k_rows <= n_split * rows
    assert n_split * tiles <= max(132, tiles) or rows == 1024
    assert cuda_quant._tickets_needed(out_dim, n_split) == (tiles if n_split > 1 else 0)


@pytest.mark.parametrize("label,in_dim,out_dim,splits", INT4_SHAPES, ids=[s[0] for s in INT4_SHAPES])
def test_b10_split_and_ticket_rule_at_the_chip_shapes(label, in_dim, out_dim, splits):
    """B10's splits are B9's rule in weight rows: a packed int32 row is 8
    weight rows, a k-step 4 packed rows (32 weight rows), and a split
    holds 256 to 2,048 weight rows (the kernel's x slice; it refuses
    more), so at every chip shape B10 splits as B9 does, within 32 weight
    rows of B9's split; one ticket per column tile where split."""
    k_rows = in_dim // 8
    tiles = -(-out_dim // 128)
    n_split, rows = cuda_quant._mma_split(k_rows, out_dim, 8)
    assert n_split == splits
    weight_rows = 8 * rows
    assert rows % 4 == 0 and 256 <= weight_rows <= 2048
    assert (n_split - 1) * rows < k_rows <= n_split * rows
    assert n_split * tiles <= max(132, tiles) or weight_rows == 2048
    b9_split, b9_rows = cuda_quant._mma_split(in_dim // 2, out_dim)
    assert n_split == b9_split and abs(weight_rows - 2 * b9_rows) < 32
    assert cuda_quant._tickets_needed(out_dim, n_split) == (tiles if n_split > 1 else 0)


def _emulate_w4a8_codes(x):
    """B11's quantization of ``x [M, IN]`` (bf16 or f32) in numpy, in the
    kernel's order: each warp's max of |x[m]| over the row widened to f32
    (exact in any order; a NaN kept), sx = amax / 127 by f32 IEEE division,
    then each code: x / sx by f32 IEEE division, rounded to the nearest
    integer with ties to even (``__float2int_rn``, which saturates), a NaN
    (0/0 in a zero row) made 0, and clamped to ±127 as an integer.
    Returns (codes int8 [M, IN], sx f32 [M, 1])."""
    xf = x.float().numpy()
    amax = np.abs(xf).max(axis=1)
    sx = amax / np.float32(127.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.rint(xf / sx[:, None])
    q = np.clip(np.where(np.isnan(q), 0, q), -(2.0**31), 2.0**31 - 1)
    return np.clip(q, -127, 127).astype(np.int8), sx[:, None].astype(np.float32)


def _w4a8_x(rng, m, in_dim, dtype, case):
    """x of one B11 case: normal rows, plus ``zero`` (row m // 2 all
    zeros), ``ties`` (a row of max 127, so sx = 1, and every other entry
    k + 0.5, exact in bf16), or ``one`` (a row with a single nonzero
    entry)."""
    x = torch.from_numpy(rng.standard_normal((m, in_dim)).astype(np.float32))
    if case == "zero":
        x[m // 2] = 0
    elif case == "ties":
        x[m - 1] = torch.arange(in_dim) % 16 - 7.5
        x[m - 1, 0] = 127
    elif case == "one":
        x[m - 1] = 0
        x[m - 1, in_dim // 3] = -0.37
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["normal", "zero", "ties", "one"])
def test_b11_quantization_equals_the_plain_codes_bit_for_bit(dtype, case):
    """The kernel's quantization, emulated in its order of operations,
    gives ``quantize_activations_rowwise``'s codes and scales bit for bit:
    bf16 and f32 x, ties at .5 rounded to even, and a zero row, whose 0/0
    codes are 0 (its output row is then exactly 0)."""
    rng = np.random.default_rng(len(case) + (dtype == torch.float32))
    x = _w4a8_x(rng, 8, 1536, dtype, case)
    codes, sx = _emulate_w4a8_codes(x)
    want_q, want_s = quantize_activations_rowwise(x)
    np.testing.assert_array_equal(codes, want_q.numpy())
    np.testing.assert_array_equal(sx, want_s.numpy())
    if case == "zero":
        assert not codes[4].any() and sx[4, 0] == 0
    if case == "ties":  # -7.5 .. 7.5 in steps of 1: ties to even
        row = codes[7, 1:16].astype(np.int32)
        np.testing.assert_array_equal(row, [-6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6, 6, 8])


def _le_words(b):
    """Little-endian uint32 words of the last axis's byte quads."""
    b = b.astype(np.uint32)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _s8_bytes(w):
    """The four bytes of uint32 words as int8, on a new last axis."""
    return np.stack([((w >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8) for i in range(4)],
                    axis=-1).view(np.int8)


def _emulate_b11(x, packed, scale, tile_chunk=16):
    """B11 in numpy through its fragment layout, split by the wrapper's
    rule. Codes as ``_emulate_w4a8_codes``, staged as the kernel stages
    them (word 4s + t of code row m: the low half's codes of packed rows
    16s + 4t .. +3; of row 8 + m the high half's; rows past M zero). Lane
    (g, t) of a k-step s holds packed rows 16s + 4t + j (j = 0..3) at
    columns 16g..16g+15 (word q: columns 4q..4q+3); ``__byte_perm`` turns
    the rows' words into one word per column (byte j from row j); mma u =
    2q + e takes {L(col 2e), L(col 2e + 1), H(col 2e), H(col 2e + 1)}, L =
    (w << 4) & 0xF0F0F0F0 and H = w & 0xF0F0F0F0, as its A registers and
    the code words (low, high) of row g as its B registers. The registers
    go into A [16×32] and B [32×8] as ``mma.sync.m16n8k32`` (s8) reads
    them (a0: A[g][4t + i], a1: A[g + 8][4t + i], a2: A[g][16 + 4t + i],
    a3: A[g + 8][16 + 4t + i]; b0: B[4t + i][g], b1: B[16 + 4t + i][g]), C
    = A·B is summed over the steps, and C's fragments (c0 C[g][2t], c1
    C[g][2t + 1], c2 C[g + 8][2t], c3 C[g + 8][2t + 1]) go to output column
    16g + 2u + c / 2 and row 2t + c % 2, as the epilogue writes them. The
    splits' sums are added, 16 divided out, then (acc · scale) · sx in f32."""
    m_rows, in_dim = x.shape
    k_rows, out_dim = packed.shape
    codes, sx = _emulate_w4a8_codes(x)
    xc = np.zeros((8, in_dim), dtype=np.int8)
    xc[:m_rows] = codes
    n_split, split_rows = cuda_quant._w4a8_split(k_rows, out_dim)
    tiles = -(-out_dim // 128)
    pk = np.zeros((k_rows, tiles * 128), dtype=np.uint8)
    pk[:, :out_dim] = packed.numpy().view(np.uint8)
    # the epilogue's map: value (u, c, g, t) -> (row, column in the tile, C row, C column)
    u, c, g, t = (a.ravel() for a in np.meshgrid(np.arange(8), np.arange(4), np.arange(8), np.arange(4),
                                                   indexing="ij"))
    out_row, out_col = 2 * t + c % 2, 16 * g + 2 * u + c // 2
    c_row, c_col = g + 8 * (c // 2), 2 * t + c % 2
    kept = out_row < m_rows
    acc16 = np.zeros((m_rows, tiles * 128), dtype=np.int64)
    for sp in range(n_split):
        r0 = sp * split_rows
        steps = min(split_rows, k_rows - r0) // 16
        n_rows = 16 * steps
        b = np.zeros((steps, 32, 8))  # [s, k, n]
        for half, base in ((0, r0), (1, k_rows + r0)):
            words = _le_words(xc[:, base : base + n_rows].view(np.uint8).reshape(8, 4 * steps, 4))
            for tt in range(4):
                # b{half} of lane (g, tt): word 4s + tt of code row g, byte i -> B[16·half + 4tt + i][g]
                b[:, 16 * half + 4 * tt : 16 * half + 4 * tt + 4, :] = (
                    _s8_bytes(words[:, tt::4]).transpose(1, 2, 0))
        for c0 in range(0, tiles, tile_chunk):
            nt = min(tile_chunk, tiles - c0)
            blk = pk[r0 : r0 + n_rows, 128 * c0 : 128 * (c0 + nt)]
            # [s, t, j, tile, g, q, byte]: row 16s + 4t + j, column 128·tile + 16g + 4q + byte
            w = _le_words(blk.reshape(steps, 4, 4, nt, 8, 4, 4))  # [s, t, j, tile, g, q]
            t01 = _byte_perm(w[:, :, 0], w[:, :, 1], 0x5140)
            t23 = _byte_perm(w[:, :, 2], w[:, :, 3], 0x5140)
            u01 = _byte_perm(w[:, :, 0], w[:, :, 1], 0x7362)
            u23 = _byte_perm(w[:, :, 2], w[:, :, 3], 0x7362)
            col = [_byte_perm(t01, t23, 0x5410), _byte_perm(t01, t23, 0x7632),
                   _byte_perm(u01, u23, 0x5410), _byte_perm(u01, u23, 0x7632)]  # [s, t, tile, g, q]
            # A as [tile, s, q, e, row half, g, k half, t, i]: u = 2q + e, row = 8·half + g, k = 16·half + 4t + i
            a = np.zeros((nt, steps, 4, 2, 2, 8, 2, 4, 4), dtype=np.int8)
            for e in range(2):
                for row_half in range(2):
                    src = col[2 * e + row_half]
                    for k_half, reg in ((0, (src << np.uint32(4)) & np.uint32(0xF0F0F0F0)),
                                        (1, src & np.uint32(0xF0F0F0F0))):
                        a[:, :, :, e, row_half, :, k_half] = _s8_bytes(reg).transpose(2, 0, 4, 3, 1, 5)
            a = a.reshape(nt, steps, 8, 16, 32).astype(np.float64)
            cm = np.matmul(a, b[None, :, None]).sum(axis=1)  # [tile, u, 16, 8]
            vals = cm[:, u, c_row, c_col].astype(np.int64)  # [tile, 1024]
            for i in range(nt):
                acc16[out_row[kept], 128 * (c0 + i) + out_col[kept]] += vals[i, kept]
    assert not (acc16 % 16).any()
    acc = (acc16[:, :out_dim] >> 4).astype(np.float32)
    return acc * scale.numpy().reshape(1, -1).astype(np.float32) * sx


def _w4a8_reference(x, packed, scale, cols=2048):
    """``w4a8_matmul_reference`` taken over column blocks (each output
    column is computed alone), so the CPU holds one block's float64 codes."""
    return torch.cat([w4a8_matmul_reference(x, packed[:, c : c + cols], scale[:, c : c + cols])
                      for c in range(0, packed.shape[1], cols)], dim=1)


@pytest.mark.parametrize(
    "m,in_dim,out_dim,case",
    [(8, 1536, 8960, "zero"), (8, 4096, 14336, "normal"), (1, 256, 7, "normal"), (3, 512, 130, "zero"),
     (3, 256, 640, "one")],
)
def test_b11_fragment_order_equals_the_plain_version_bit_for_bit(m, in_dim, out_dim, case):
    """The emulation against ``w4a8_matmul_reference`` bit for bit, on
    random packed bytes (every nibble, -8 included) and scales: the
    probe's shape with a zero row (one split), llama3.1:8b's w_gate (two
    splits of 1,024 packed rows), M 1 at OUT 7 and M 3 at OUT 130 (ragged
    column tiles) and 640."""
    rng = np.random.default_rng(m * 7 + in_dim + out_dim)
    packed = torch.from_numpy(rng.integers(0, 256, (in_dim // 2, out_dim), dtype=np.uint8).view(np.int8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.02, (1, out_dim)).astype(np.float32))
    x = _w4a8_x(rng, m, in_dim, torch.bfloat16, case)
    want = _w4a8_reference(x, packed, scale)
    got = _emulate_b11(x, packed, scale)
    np.testing.assert_array_equal(got, want.numpy())
    if case == "zero":
        assert not got[m // 2].any()


# (label, M, IN, OUT, splits) of chip_smoke.py's B11 rows: the probe's
# shape and llama3.1:8b's w_gate, and the M 1-8 rows at OUT 7 and 130.
W4A8_SHAPES = [
    ("probe (qwen2 w_gate)", 8, 1536, 8960, 1),
    ("llama w_gate/w_up", 8, 4096, 14336, 2),
    ("OUT 7", 1, 256, 7, 1),
    ("OUT 130", 8, 512, 130, 2),
]


@pytest.mark.parametrize("label,m,in_dim,out_dim,splits", W4A8_SHAPES, ids=[s[0] for s in W4A8_SHAPES])
def test_b11_split_and_ticket_rule_at_the_chip_shapes(label, m, in_dim, out_dim, splits):
    """B11's splits: B9's rule in whole 16-row k-steps, 128 to 1,024
    packed rows (the kernel's staged codes refuse more), covering the
    packed rows with no empty split; at least as few splits as B9 takes;
    one ticket per column tile where split, none otherwise."""
    k_rows = in_dim // 2
    tiles = -(-out_dim // 128)
    n_split, rows = cuda_quant._w4a8_split(k_rows, out_dim)
    assert n_split == splits
    assert rows % 16 == 0 and 128 <= rows <= 1024
    assert (n_split - 1) * rows < k_rows <= n_split * rows
    assert n_split * tiles <= max(132, tiles) or rows == 1024
    assert n_split <= cuda_quant._mma_split(k_rows, out_dim)[0]
    assert cuda_quant._tickets_needed(out_dim, n_split) == (tiles if n_split > 1 else 0)


# (label, B, Hkv, capacity, grid): B2's rows and B6's (capacity Jmax·page)
# at chip_smoke.py's shapes, with the grid the rule gave in the kernel's
# own C code before it moved to the wrapper (B2's bits depend on it).
DECODE_GRIDS = [
    ("B2 qwen2 length 200", 1, 2, 320, 5),
    ("B2 qwen2 length 2100", 1, 2, 3104, 49),
    ("B2 self-draft batch", 4, 2, 1280, 20),
    ("B2 phi3", 1, 32, 1024, 9),
    ("B2 gemma", 1, 1, 1024, 16),
    ("B6 write-through rows", 8, 2, 16 * 128, 17),
    ("B6 B 1", 1, 2, 16 * 128, 32),
    ("B6 B 16", 16, 2, 16 * 128, 9),
    ("B6 B 64", 64, 2, 16 * 128, 3),
    ("B6 page 48", 8, 2, 32 * 48, 17),
]


@pytest.mark.parametrize("label,b,hkv,capacity,grid", DECODE_GRIDS, ids=[g[0] for g in DECODE_GRIDS])
def test_decode_grid_and_tickets_at_the_chip_shapes(label, b, hkv, capacity, grid):
    """The one-launch decode grid: enough blocks per (row, kv head) that
    the grid covers the card about twice, at most 128, and none starting
    past the capacity (each at least 64 positions in); one ticket per
    (row, kv head)."""
    n = cuda_attention.decode_grid(b, hkv, capacity)
    assert n == grid
    assert 1 <= n <= 128 and (n - 1) * 64 < capacity
    assert n * b * hkv >= 264 or n == 128 or n == -(-capacity // 64)
    ticket_buf = _kernels.tickets(torch.device("cpu"), b * hkv)
    assert ticket_buf.dtype == torch.int32 and ticket_buf.numel() >= b * hkv
    assert not torch.any(ticket_buf)


# (label, B, Hkv, capacity, grid): B4/B5's rows at chip_smoke.py's shapes
# (the engine batch's table is the power of two over the pages its longest
# row needs; a session's, over twice that).
PARTS_GRIDS = [
    ("engine batch", 32, 2, 32 * 128, 64),
    ("engine batch, page 48", 32, 2, 64 * 48, 48),
    ("B 1", 1, 2, 16 * 128, 32),
    ("B 16", 16, 2, 16 * 128, 32),
    ("B 64", 64, 2, 16 * 128, 32),
    ("phi3", 8, 32, 16 * 128, 16),
    ("spec batch at Q 1", 8, 2, 32 * 128, 64),
]


@pytest.mark.parametrize("label,b,hkv,capacity,grid", PARTS_GRIDS, ids=[g[0] for g in PARTS_GRIDS])
def test_parts_grid_and_tickets_at_the_chip_shapes(label, b, hkv, capacity, grid):
    """The parts kernels' grid: enough blocks per (row, kv head) that a row
    as long as the table holds runs in the body's shortest splits (64
    positions), at most 128 and at most 4,096 blocks in all, none starting
    past the capacity; one ticket per (row, kv head)."""
    n = cpa.parts_grid(b, hkv, capacity)
    assert n == grid
    assert 1 <= n <= 128 and (n - 1) * 64 < capacity and n * b * hkv <= 4096
    assert n == 128 or n * 64 >= capacity or (n + 1) * b * hkv > 4096
    ticket_buf = _kernels.tickets(torch.device("cpu"), b * hkv)
    assert ticket_buf.numel() >= b * hkv and not torch.any(ticket_buf)


def _decode_splits(length, n_grid):
    """(splits used, positions per split) of a row of ``length`` positions,
    as each block of ``decode_tile_kernel`` computes them: at least 64
    positions a split, whole 32-position tiles, at most ``n_grid``
    splits; a row with no position has one split that reads nothing."""
    n_used = max(1, min(n_grid, -(-length // 64)))
    split_len = -(-(-(-max(length, 1) // n_used)) // 32) * 32
    return max(1, -(-length // split_len)), split_len


@pytest.mark.parametrize(
    "label,b,hkv,capacity,grid", DECODE_GRIDS + PARTS_GRIDS, ids=[g[0] for g in DECODE_GRIDS + PARTS_GRIDS]
)
def test_decode_splits_cover_every_length(label, b, hkv, capacity, grid):
    """The one-launch decode body's splits of a row, for every length up to
    the capacity, within the grid the wrapper gives (B2, B3 and B6:
    ``decode_grid``; B4/B5: ``parts_grid``): whole tiles, at least 64
    positions (but one), covering the row with no split empty; a row with
    no position runs one block; where the parts kernels' grid reaches the
    capacity, every row runs in splits of at most 64 positions."""
    parts = (label, b, hkv, capacity, grid) in PARTS_GRIDS
    n = (cpa.parts_grid if parts else cuda_attention.decode_grid)(b, hkv, capacity)
    for length in range(0, capacity + 1, 5):
        n_used, split_len = _decode_splits(length, n)
        assert 1 <= n_used <= n and split_len % 32 == 0
        if length == 0:
            assert n_used == 1
        else:
            assert (n_used - 1) * split_len < length <= n_used * split_len
            assert split_len >= min(64, -(-length // 32) * 32)
            assert split_len <= 64 or not parts or n * 64 < capacity


def _emulate_b4(q, k_pool, v_pool, table, lengths, k_scale=None, v_scale=None):
    """B4's (with scales, B5's) arithmetic in f32, block by block as
    ``decode_tile_kernel`` runs it under ``PagedRows`` and ``PartsOut``:
    the grid from :func:`parts_grid`, each row's splits from its length
    (:func:`_decode_splits`); per split, tiles of 32 positions read
    through the clipped table, the G heads' scores of a tile at once
    (times the K scale), one max per tile and head, ``alpha = exp(m_old -
    m_new)`` (0 on the first tile), ``l`` from the tile's probabilities,
    the V scale folded into p; warp w accumulates positions w, w + 4, ...
    of every tile, and the four warps' accumulators add in warp order. At
    D 16 each half-warp takes a position: half h of warp w accumulates
    positions w + 4·(2·i + h), and the upper half's sum joins the lower's
    (the shuffle) before the warps add.
    One split is written as is; several are merged by the last in split
    order into unnormalised parts (m in natural units). A row with no
    position reads nothing: (0, -inf, 0)."""
    b, hq, d = q.shape
    n_pool, hkv, page, _ = k_pool.shape
    group = hq // hkv
    jmax = table.shape[1]
    n_grid = cpa.parts_grid(b, hkv, jmax * page)
    scale = np.float32(1.0 / math.sqrt(d))
    acc = torch.zeros(b, hkv, group, d)
    m_out = torch.full((b, hkv, group), float("-inf"))
    l_out = torch.zeros(b, hkv, group)
    for bi in range(b):
        length = max(0, min(int(lengths[bi]), jmax * page))
        n_used, split_len = _decode_splits(length, n_grid)
        for h in range(hkv):
            qg = q[bi, h * group : (h + 1) * group].float()  # [G, D]
            parts = []
            for sp in range(n_used):
                t_begin = sp * split_len
                t_end = min(t_begin + split_len, length)
                m_run = torch.full((group,), float("-inf"))
                l_run = torch.zeros(group)
                warps = torch.zeros(4, 2, group, d)  # [warp, half-warp] (one half above D 16)
                for t0 in range(t_begin, t_end, 32):
                    pos = torch.arange(t0, min(t0 + 32, t_end))
                    pages = torch.clamp(table[bi, pos // page].long(), 0, n_pool - 1)
                    kk = k_pool[pages, h, pos % page].float()
                    vv = v_pool[pages, h, pos % page].float()
                    sc = (qg @ kk.T) * scale  # [G, positions]
                    if k_scale is not None:
                        sc = sc * k_scale[pages, h, pos % page][None, :]
                    m_new = torch.maximum(m_run, sc.max(dim=1).values)
                    alpha = torch.exp(m_run - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    l_run = l_run * alpha + p.sum(dim=1)
                    m_run = m_new
                    if v_scale is not None:
                        p = p * v_scale[pages, h, pos % page][None, :]
                    warps = warps * alpha[None, None, :, None]
                    for w in range(4):
                        if d >= 32:
                            warps[w, 0] += p[:, w::4] @ vv[w::4]
                        else:
                            for half in range(2):
                                sl = slice(w + 4 * half, None, 8)
                                warps[w, half] += p[:, sl] @ vv[sl]
                w_sum = warps[:, 0] + warps[:, 1]
                a = w_sum[0] + w_sum[1] + w_sum[2] + w_sum[3]
                parts.append((a, m_run, l_run))
            if n_used == 1:
                a, m_fin, l_fin = parts[0]
            else:
                m_fin = torch.stack([pm for _, pm, _ in parts]).max(dim=0).values
                a, l_fin = torch.zeros(group, d), torch.zeros(group)
                for pa, pm, pl in parts:
                    c = torch.exp(pm - m_fin)
                    l_fin = l_fin + c * pl
                    a = a + c[:, None] * pa
            acc[bi, h], m_out[bi, h], l_out[bi, h] = a, m_fin, l_fin
    return acc, m_out, l_out


def test_head_dims_match_every_kernel_switch():
    """``HEAD_DIMS`` (the wrappers' check) lists exactly the widths of every
    ``switch (d_head)`` in ``csrc/``: B1's, B2-B6's, B7's and B8's, 16
    included, so no width passes the check and fails in the kernel."""
    csrc = pathlib.Path(_kernels.__file__).resolve().parent.parent / "csrc"
    switches = []
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r"switch \(d_head\) \{(.*?)default:", text, re.S):
            widths = tuple(int(x) for x in re.findall(r"_CASE\((\d+)\)", m.group(1)))
            switches.append((path.name, widths))
    assert len(switches) == 4, switches
    for name, widths in switches:
        assert widths == cuda_attention.HEAD_DIMS, (name, widths)
    assert 16 in cuda_attention.HEAD_DIMS


def _lane_pad(x, d):
    """The JAX Pallas kernels take pools pre-padded to 128 lanes."""
    pad = (-d) % 128
    return x if not pad else jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


# (label, Hq, Hkv, D, page, lengths, int8 pool): an empty row and a
# one-position row in each; lengths on and off multiples of 32 and 64; rows
# of several splits; pages of 128 (a tile in one page) and 48 (each position
# looked up); every table with junk entries past each frontier.
B4_CASES = [
    ("qwen2 G 6", 12, 2, 128, 128, [0, 1, 32, 64, 96, 129, 700], False),
    ("qwen2 G 6, int8 pool", 12, 2, 128, 128, [0, 1, 32, 64, 96, 129, 700], True),
    ("qwen2 G 6, page 48", 12, 2, 128, 48, [0, 1, 47, 48, 64, 200, 500], False),
    ("qwen2 G 6, page 48, int8 pool", 12, 2, 128, 48, [0, 1, 47, 48, 64, 200, 500], True),
    ("phi3 D 96", 32, 32, 96, 128, [0, 1, 65, 300], False),
    ("phi3 D 96, int8 pool", 32, 32, 96, 128, [0, 1, 65, 300], True),
    ("gemma D 256", 8, 1, 256, 128, [0, 1, 128, 257, 600], False),
    ("gemma D 256, int8 pool", 8, 1, 256, 128, [0, 1, 128, 257, 600], True),
    ("tiny D 16", 4, 2, 16, 128, [0, 1, 9, 33, 64, 130, 700], False),
    ("tiny D 16, int8 pool", 4, 2, 16, 128, [0, 1, 9, 33, 64, 130, 700], True),
    ("tiny D 16, page 48", 4, 2, 16, 48, [0, 1, 47, 48, 71, 200], False),
]


@pytest.mark.parametrize("label,hq,hkv,d,page,lengths,int8", B4_CASES, ids=[c[0] for c in B4_CASES])
def test_b4_b5_tile_body_matches_the_pallas_parts_kernels(label, hq, hkv, d, page, lengths, int8):
    """The emulation of B4/B5's one-launch body against the JAX package's
    ``pallas_paged_decode_attention_parts`` (int8: ``..._parts_int8``) in
    interpret mode, in f32 within 1e-5 on acc, m and l (the per-tile max
    and the split merge sum in another order); a row with no cached token
    is exactly (0, -inf, 0) in both."""
    rng = np.random.default_rng(hq * 1000 + d + page)
    k, v, table, lens = _paged_rows(rng, len(lengths), hkv, d, page, lengths)
    q = torch.from_numpy(rng.standard_normal((len(lengths), hq, d)).astype(np.float32))
    if int8:
        kq, ks = quantize_kv_vector(k)
        vq, vs = quantize_kv_vector(v)
        want = jpa.pallas_paged_decode_attention_parts_int8(
            jnp.asarray(q.numpy()), _lane_pad(jnp.asarray(kq.numpy()), d), jnp.asarray(ks.numpy()),
            _lane_pad(jnp.asarray(vq.numpy()), d), jnp.asarray(vs.numpy()),
            jnp.asarray(table.numpy()), jnp.asarray(lens.numpy()), interpret=True,
        )
        got = _emulate_b4(q, kq.float(), vq.float(), table, lens, ks, vs)
    else:
        want = jpa.pallas_paged_decode_attention_parts(
            jnp.asarray(q.numpy()), _lane_pad(jnp.asarray(k.numpy()), d),
            _lane_pad(jnp.asarray(v.numpy()), d), jnp.asarray(table.numpy()),
            jnp.asarray(lens.numpy()), interpret=True,
        )
        got = _emulate_b4(q, k, v, table, lens)
    acc, m, l = got
    acc_w, m_w, l_w = (torch.from_numpy(np.array(x)) for x in want)
    assert acc_w.shape == acc.shape and m_w.shape == m.shape
    empty = lens == 0
    assert torch.all(acc[empty] == 0) and torch.all(torch.isneginf(m[empty])) and torch.all(l[empty] == 0)
    assert torch.all(acc_w[empty] == 0) and torch.all(torch.isneginf(m_w[empty])) and torch.all(l_w[empty] == 0)
    live = ~empty
    for a, w in ((acc, acc_w), (m, m_w), (l, l_w)):
        torch.testing.assert_close(a[live], w[live], atol=1e-5, rtol=1e-5)


def _mq_tile(d):
    """Positions per K/V tile of the tensor-core verify kernel: B1's, 64,
    or 32 at D 256."""
    return 64 if d <= 128 else 32


def _mq_splits(frontier, n_grid, tile):
    """(splits used, positions per split) of a q-tile whose last query sees
    ``frontier`` positions, as each block of ``mq_mma_kernel`` computes
    them: at least 64 positions a split, whole tiles, at most ``n_grid``
    splits; a q-tile that sees nothing has one split with nothing to
    read."""
    n_used = max(1, min(n_grid, -(-frontier // 64)))
    split_len = -(-(-(-max(frontier, 1) // n_used)) // tile) * tile
    return max(1, -(-frontier // split_len)), split_len


def _emulate_b7(q, k_pool, v_pool, table, lengths, offsets, k_scale=None, v_scale=None):
    """B7's (with scales, B8's) tiling in f32, block by block as the
    kernel runs it: q-tiles of 64 // G query positions (row r is query
    j0 + r // G, head h·G + r % G, seeing kpos < min(len, offset + j + 1));
    the grid's splits (:func:`mq_grid`) cut by each q-tile's own frontier
    (:func:`_mq_splits`); per split, tiles of ``_mq_tile(D)`` positions read
    through the clipped table, scores in log2 units with every score
    masked by its row's limit, the online softmax with a -inf max held at
    base 0; partials with m in natural units; one split written as is,
    several merged in split order. The K scale multiplies a score, the V
    scale folds into p after l takes it."""
    b, q_len, hq, d = q.shape
    n_pool, hkv, page, _ = k_pool.shape
    group = hq // hkv
    block_q = cpa.MQ_ROWS // group
    q_tiles = cpa.mq_q_tiles(q_len, group)
    kn = _mq_tile(d)
    jmax = table.shape[1]
    n_grid = cpa.mq_grid(b, hkv, q_tiles, jmax * page)
    scale_log2 = np.float32((1.0 / math.sqrt(d)) * 1.4426950408889634)
    ln2 = np.float32(0.69314718055994531)
    acc = torch.zeros(b, q_len, hkv, group, d)
    m_out = torch.full((b, q_len, hkv, group), float("-inf"))
    l_out = torch.zeros(b, q_len, hkv, group)
    for bi in range(b):
        length = max(0, min(int(lengths[bi]), jmax * page))
        off = int(offsets[bi])
        for h in range(hkv):
            for x in range(q_tiles):
                j0 = x * block_q
                n_rows = min(block_q, q_len - j0) * group
                r = torch.arange(n_rows)
                js, gs = j0 + r // group, r % group
                lim = torch.clamp(torch.minimum(torch.tensor(length), off + js + 1), min=0)
                frontier = max(0, min(length, off + j0 + n_rows // group))
                n_used, split_len = _mq_splits(frontier, n_grid, kn)
                qr = q[bi, js, h * group + gs].float()  # [R, D]
                parts = []
                for sp in range(n_used):
                    t_begin = sp * split_len
                    t_end = min(t_begin + split_len, frontier)
                    m_run = torch.full((n_rows,), float("-inf"))
                    l_run = torch.zeros(n_rows)
                    o = torch.zeros(n_rows, d)
                    for t0 in range(t_begin, t_end, kn):
                        pos = torch.arange(t0, t0 + kn)
                        ok = pos < t_end
                        pages = torch.clamp(table[bi, torch.clamp(pos // page, max=jmax - 1)].long(), 0, n_pool - 1)
                        kk = torch.where(ok[:, None], k_pool[pages, h, pos % page].float(), 0.0)
                        vv = torch.where(ok[:, None], v_pool[pages, h, pos % page].float(), 0.0)
                        sc = (qr @ kk.T) * scale_log2
                        if k_scale is not None:
                            sc = sc * torch.where(ok, k_scale[pages, h, pos % page], 0.0)[None, :]
                        sc = torch.where(pos[None, :] >= lim[:, None], float("-inf"), sc)
                        m_new = torch.maximum(m_run, sc.max(dim=1).values)
                        base = torch.where(m_new == float("-inf"), 0.0, m_new)
                        alpha = torch.exp2(m_run - base)
                        p = torch.exp2(sc - base[:, None])
                        l_run = l_run * alpha + p.sum(dim=1)
                        if v_scale is not None:
                            p = p * torch.where(ok, v_scale[pages, h, pos % page], 0.0)[None, :]
                        o = o * alpha[:, None] + p @ vv
                        m_run = m_new
                    parts.append((o, m_run * ln2, l_run))
                if n_used == 1:
                    o, m_nat, l_sum = parts[0]
                else:
                    mx = torch.stack([pm for _, pm, _ in parts]).max(dim=0).values
                    o, l_sum = torch.zeros(n_rows, d), torch.zeros(n_rows)
                    for po, pm, pl in parts:
                        c = torch.where(pm == float("-inf"), 0.0, torch.exp(pm - mx))
                        l_sum = l_sum + c * pl
                        o = o + c[:, None] * po
                    m_nat = mx
                acc[bi, js, h, gs] = o
                m_out[bi, js, h, gs] = m_nat
                l_out[bi, js, h, gs] = l_sum
    return acc, m_out, l_out


def _paged_rows(rng, b, hkv, d, page, lengths):
    """A shuffled pool of ``page``-position pages holding each row's
    tokens, its table (twice as wide as the longest row needs, junk past
    every frontier, inside and outside the pool)."""
    need = [-(-n // page) for n in lengths]
    jmax = 2 * max(max(need), 1)
    n_pool = sum(need) + 3
    perm = rng.permutation(n_pool)
    table = rng.integers(-n_pool, 2 * n_pool, (b, jmax)).astype(np.int32)
    pos = 0
    for r, k in enumerate(need):
        table[r, :k] = perm[pos : pos + k]
        pos += k
    k = torch.from_numpy(rng.standard_normal((n_pool, hkv, page, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n_pool, hkv, page, d)).astype(np.float32))
    return k, v, torch.from_numpy(table), torch.tensor(lengths, dtype=torch.int32)


# (label, Q, Hq, Hkv, D, page, lengths, offsets, int8 pool): an empty row, a
# first query that sees nothing (offset -1), offsets cutting inside rows,
# rows of several splits.
B7_TILING_CASES = [
    ("Q 5 G 6, cutting offsets", 5, 12, 2, 64, 16, [0, 1, 129, 300, 700], [0, -1, 100, 290, 700], False),
    ("Q 5 G 6, int8 pool", 5, 12, 2, 64, 16, [0, 1, 129, 300, 700], [0, -1, 100, 290, 700], True),
    ("Q 13 G 6, two q-tiles", 13, 12, 2, 64, 128, [0, 1, 129, 600], [0, -1, 120, 590], False),
    ("Q 9 G 8, 72 rows", 9, 8, 1, 128, 48, [0, 5, 129, 400], [0, -1, 125, 396], False),
    ("Q 5 G 1, D 256", 5, 4, 4, 256, 16, [0, 70, 300], [0, 66, 296], False),
]


@pytest.mark.parametrize(
    "label,q_len,hq,hkv,d,page,lengths,offs,int8", B7_TILING_CASES, ids=[c[0] for c in B7_TILING_CASES]
)
def test_b7_tiling_matches_the_plain_version(label, q_len, hq, hkv, d, page, lengths, offs, int8):
    """The emulation of B7's q-tiles, device-sized splits, log2-unit online
    softmax and split merge against ``paged_mq_attention_reference``
    (int8: ``..._int8_reference``) in f32, within 1e-5 (the exp2/log2
    units and the merge add a few ulp); a query that sees no token is
    exactly (0, -inf, 0) in both."""
    rng = np.random.default_rng(q_len * 100 + hq + d)
    k, v, table, lens = _paged_rows(rng, len(lengths), hkv, d, page, lengths)
    q = torch.from_numpy(rng.standard_normal((len(lengths), q_len, hq, d)).astype(np.float32))
    offsets = torch.tensor(offs, dtype=torch.int32)
    if int8:
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, k.shape[:3]).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, v.shape[:3]).astype(np.float32))
        k, v = torch.round(k * 40).clamp(-127, 127), torch.round(v * 40).clamp(-127, 127)
        want = paged_mq_attention_int8_reference(q, k.to(torch.int8), ks, v.to(torch.int8), vs,
                                                 table, lens, offsets)
        got = _emulate_b7(q, k, v, table, lens, offsets, ks, vs)
    else:
        want = paged_mq_attention_reference(q, k, v, table, lens, offsets)
        got = _emulate_b7(q, k, v, table, lens, offsets)
    acc, m, l = got
    acc_r, m_r, l_r = want
    empty = l_r == 0
    assert torch.any(empty) and torch.equal(l == 0, empty)
    assert torch.all(torch.isneginf(m[empty])) and torch.all(acc[empty] == 0)
    live = ~empty
    for a, b in ((m, m_r), (l, l_r), (acc / l[..., None], acc_r / l_r[..., None])):
        torch.testing.assert_close(a[live], b[live], atol=1e-5, rtol=1e-5)


def _study_prompt_tokens():
    return len("In 100 words, please give me information about photosynthesis") + 1


# (label, B, Hq, Hkv, D, Q, capacity Jmax·page, q-tiles, grid): chip_smoke.py's
# B7/B8 rows (a session's table is the power of two over twice the pages
# the longest row needs).
MQ_GRIDS = [
    ("spec batch Q 5", 8, 12, 2, 128, 5, 32 * 128, 1, 17),
    ("spec batch Q 10", 8, 12, 2, 128, 10, 32 * 128, 1, 17),
    ("spec batch Q 13", 8, 12, 2, 128, 13, 32 * 128, 2, 9),
    ("spec batch Q 17", 8, 12, 2, 128, 17, 32 * 128, 2, 9),
    ("one-row session", 1, 12, 2, 128, 5, 2 * 128, 1, 4),
    ("B 4 with an empty row", 4, 12, 2, 128, 5, 32 * 128, 1, 32),
    ("phi3", 4, 32, 32, 96, 5, 32 * 128, 1, 3),
    ("gemma", 4, 8, 1, 256, 5, 32 * 128, 1, 32),
]


@pytest.mark.parametrize("label,b,hq,hkv,d,q_len,capacity,q_tiles,grid", MQ_GRIDS, ids=[g[0] for g in MQ_GRIDS])
def test_mq_grid_and_splits_at_the_chip_shapes(label, b, hq, hkv, d, q_len, capacity, q_tiles, grid):
    """The tensor-core verify grid: q-tiles of 64 // G positions; enough
    splits per (q-tile, row, kv head) that the grid covers the card about
    twice, at most 32 and none starting past the capacity; one ticket per
    (row, kv head, q-tile). Each q-tile's splits, for every frontier up to
    the capacity: whole tiles, at least 64 positions (but one), within
    the grid, covering the frontier with none empty."""
    group = hq // hkv
    assert cpa.mq_q_tiles(q_len, group) == q_tiles == -(-q_len // (64 // group))
    n = cpa.mq_grid(b, hkv, q_tiles, capacity)
    assert n == grid
    assert 1 <= n <= 32 and (n - 1) * 64 < capacity
    assert n * b * hkv * q_tiles >= 264 or n == 32 or n == -(-capacity // 64)
    tile = _mq_tile(d)
    for frontier in range(0, capacity + 1, 7):
        n_used, split_len = _mq_splits(frontier, n, tile)
        assert 1 <= n_used <= n and split_len % tile == 0
        if frontier == 0:
            assert n_used == 1
        else:
            assert (n_used - 1) * split_len < frontier <= n_used * split_len
            assert split_len >= min(64, -(-frontier // tile) * tile)
    ticket_buf = _kernels.tickets(torch.device("cpu"), b * hkv * q_tiles)
    assert ticket_buf.numel() >= b * hkv * q_tiles and not torch.any(ticket_buf)
