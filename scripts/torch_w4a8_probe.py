#!/usr/bin/env python3
"""The w4a8 probe of the PyTorch port, on one CUDA card.

    python3 scripts/torch_w4a8_probe.py

The port-side copy of ``scripts/w4a8_probe.py``: does a w4a8 int4 matmul
(activations quantized per row to int8, int8 codes times int4 weights
summed in int32; kernel B11, ``cuda_w4a8_matmul``) beat the int4 matmul
that keeps the activations in bf16 (B9, ``cuda_int4_matmul``)? One
decode-shaped matmul, the original's: M 8, 1536 -> 8960 (qwen2:1.5b's MLP
gate), weights from a seeded ``torch.Generator`` through the port's
``quantize_tensor_int4``. Prints one JSON line each, as the original does
(after one line naming the card):

- ``{"w4a8_rel_err": e}``: max |w4a8 - x @ dequant(w)| / max |x @
  dequant(w)|, the f32 product of the dequantized weights;
- ``{"int4_bf16_kernel": {"us_per_call": t, ...}}`` (B9);
- ``{"w4a8_kernel": {"us_per_call": t, ...}}`` (B11, the activation
  quantization included, as the original times it: B11 quantizes x inside
  its one launch).

Times are CUDA-event means of one call with the L2 flushed before each
(``chip_smoke.py``'s ``Timer``), not the original's TPU slope method;
``bound_us`` is the call's bytes (packed weights, scales, x, out) over the
card's 3.35 TB/s. Raises without a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M = 8
IN_DIM, OUT_DIM = 1536, 8960
SEED = 0


def probe(torch) -> "list[dict]":
    """The probe's lines (error, then each kernel's time), on the card."""
    from chip_smoke import BF16_FLOPS, INT8_OPS, Timer, bound

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.models.quantize import (
        maybe_dequant,
        quantize_tensor_int4,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.ops import cuda_quant

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((IN_DIM, OUT_DIM), generator=gen, device="cuda") * 0.05
    leaf = quantize_tensor_int4(w)
    x = torch.randn((M, IN_DIM), generator=gen, device="cuda").to(torch.bfloat16)

    want = x.float() @ maybe_dequant(leaf, torch.float32)
    got = cuda_quant.cuda_w4a8_matmul(x, leaf["q4"], leaf["s"])
    lines = [{"w4a8_rel_err": ((got - want).abs().max() / (want.abs().max() + 1e-9)).item()}]
    nbytes = leaf["q4"].numel() + 4 * OUT_DIM + 2 * M * IN_DIM
    timer = Timer(torch)
    for name, fn, out_bytes, peak in (
        ("int4_bf16_kernel", cuda_quant.cuda_int4_matmul, 2 * M * OUT_DIM, BF16_FLOPS),
        ("w4a8_kernel", cuda_quant.cuda_w4a8_matmul, 4 * M * OUT_DIM, INT8_OPS),
    ):
        ms = timer.ms(lambda: fn(x, leaf["q4"], leaf["s"]))
        b_ms, _ = bound(nbytes + out_bytes, 2 * M * IN_DIM * OUT_DIM, peak)
        lines.append({name: {"us_per_call": ms * 1e3, "bound_us": b_ms * 1e3,
                             "M": M, "IN": IN_DIM, "OUT": OUT_DIM}})
    return lines


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch_w4a8_probe needs a CUDA device: its numbers are the card's")
    from chip_smoke import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
                      "torch": torch.__version__}), flush=True)
    for line in probe(torch):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
