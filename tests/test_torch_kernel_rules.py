"""The logic the one-launch kernels B6 (write-through paged decode) and B9
(int4 matmul, halves layout) rest on, pinned on the CPU, where the kernels
cannot run:

- B9's nibble → bf16 conversion (each nibble, biased by 8, ORed into the
  mantissa of 128.0, then 136 subtracted), emulated in numpy bit for bit,
  is exact over every byte;
- B9's fragment order (the k pair of an mma register is the low and high
  nibble of one packed byte, x staged in the same order; a lane's 16-byte
  load feeds eight mmas), emulated in torch through the PTX layouts of
  ``mma.sync.m16n8k16``, gives ``int4_matmul_reference`` bit for bit;
- the wrappers' grid, split and ticket rules, as pure functions, at the
  shapes ``chip_smoke.py`` drives.

The kernels themselves are held against their plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import quantize_tensor_int4
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import _kernels, cuda_attention, cuda_quant
from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops.quant import int4_matmul_reference

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
