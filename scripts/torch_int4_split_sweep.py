#!/usr/bin/env python3
"""B9's, B10's or B11's time against its split of the packed rows, on the
card: the int4 matmul kernels of ``csrc/int4_matmul.cu``
(``int4_mma_kernel``, halves layout, splits of 8 to 1,024 packed rows;
``int4_i32_mma_kernel``, int32 lanes, splits of 4 to 256 packed rows: 32
to 2,048 weight rows; ``w4a8_mma_kernel``, the w4a8 product over the
halves layout, splits of 16 to 1,024 packed rows) launched with each
split, and with the wrapper's own rule (``ops/cuda_quant.py::_mma_split``,
``_w4a8_split``), at qwen2:1.5b's and llama3.1:8b's projections (and, for
w4a8, llama3.1:8b's w_gate, the probe's second shape), M 1 and 8, bf16.
Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_int4_split_sweep.py [--layout halves|i32|w4a8]

Each split's output is held against the plain version (bf16 to 2e-2; w4a8
bit for bit) and timed with ``chip_smoke.py``'s timer (the L2 flushed
before each launch); ``torch.matmul`` on the dequantized bf16 weight is
timed beside them, and for w4a8 also B9 on the same weights
(``b9_ms``). Prints the card's ``nvidia-smi`` line, then one JSON line per
shape and M: ``ms`` maps split rows (packed) to {"blocks", "ms"}.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = (
    ("qwen2:1.5b wk/wv", 1536, 256),
    ("qwen2:1.5b wq/wo", 1536, 1536),
    ("qwen2:1.5b w_gate/w_up", 1536, 8960),
    ("qwen2:1.5b w_down", 8960, 1536),
    ("llama3.1:8b wk/wv", 4096, 1024),
    ("llama3.1:8b wq/wo", 4096, 4096),
)
# Packed rows per split, by layout: (halves) 16 to 2,048 weight rows in
# whole 8-row k-steps; (int32 lanes) 32 to 2,048 in whole 4-row k-steps;
# (w4a8) 32 to 2,048 weight rows in whole 16-row k-steps.
SPLIT_ROWS = {
    "halves": (8, 16, 32, 64, 128, 256, 512, 1024),
    "i32": (4, 8, 16, 32, 64, 128, 256),
    "w4a8": (16, 32, 64, 128, 256, 512, 1024),
}
W4A8_EXTRA_SHAPES = (("llama3.1:8b w_gate/w_up", 4096, 14336),)
BF16_ATOL = 2e-2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layout", choices=sorted(SPLIT_ROWS), default="halves",
                        help="halves: B9 (int8 codes); i32: B10 (int32 lanes); w4a8: B11")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_int4_split_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models import quantize as qmod
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant as cq
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import quant as qplain

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(2)
    layout = args.layout
    quantize, key, reference, name, per_row = {
        "halves": (qmod.quantize_tensor_int4, "q4", qplain.int4_matmul_reference, "cuda_int4_matmul", 2),
        "i32": (qmod.quantize_tensor_int4_i32, "q32", qplain.int4_matmul_i32_reference,
                "cuda_int4_matmul_i32", 8),
        "w4a8": (qmod.quantize_tensor_int4, "q4", qplain.w4a8_matmul_reference, "cuda_w4a8_matmul", 2),
    }[layout]
    sweep = SPLIT_ROWS[layout]
    shapes = SHAPES + (W4A8_EXTRA_SHAPES if layout == "w4a8" else ())
    for label, in_dim, out_dim in shapes:
        w = torch.randn((in_dim, out_dim), generator=gen, device="cuda") / math.sqrt(in_dim)
        leaf = quantize(w)
        codes, scale = leaf[key], leaf["s"]
        w_bf16 = qmod.maybe_dequant(leaf, torch.bfloat16)
        k_rows, tiles = codes.shape[0], -(-out_dim // 128)
        if layout == "w4a8":
            rule = cq._w4a8_split(k_rows, out_dim)
        else:
            rule = cq._mma_split(k_rows, out_dim, per_row)
        for m in (1, 8):
            x = torch.randn((m, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
            ref = reference(x, codes, scale).float()
            row = {"layout": layout, "shape": label, "M": m, "IN": in_dim, "OUT": out_dim,
                   "nvidia_smi": smi, "weight_rows_per_packed_row": per_row,
                   "rule": {"splits": rule[0], "rows": rule[1], "blocks": rule[0] * tiles}, "ms": {}}
            for rows in sorted({*sweep, rule[1]}):
                n_split = -(-k_rows // rows)
                if rows > sweep[0] and -(-k_rows // (rows // 2)) == 1:
                    continue  # half as many rows already make one split
                split = (n_split, rows)

                def call(split=split):
                    if layout == "w4a8":
                        return cq._launch_w4a8(name, x, codes, scale, split=split)
                    return cq._launch_mma(name, x, codes, scale, split=split)

                got = call().float()
                if layout == "w4a8":
                    assert torch.equal(got, ref), (label, m, rows)
                else:
                    err = (got - ref).abs().max().item()
                    assert err <= BF16_ATOL, (label, m, rows, err)
                row["ms"][rows] = {"blocks": n_split * tiles, "ms": timer.ms(call)}
            row["matmul_ms"] = timer.ms(lambda: torch.matmul(x, w_bf16))
            if layout == "w4a8":
                row["b9_ms"] = timer.ms(lambda: cq.cuda_int4_matmul(x, codes, scale))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
