#!/usr/bin/env python3
"""Time the paged parts kernels (B4/B5) at several grids, on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_parts_grid_sweep.py

At each B4/B5 row of ``scripts/torch_kernel_trees.py`` (the inputs of
``chip_smoke.py``'s ``paged_kernel_phase``, bf16 q, junk table entries) it
times one call with ``chip_smoke.Timer`` at grids of 2 to 128 blocks per
(row, kv head), none starting past the table's capacity (``Jmax·page``,
64 positions a split at least), beside the grid the wrapper's rule gives
(``cuda_paged_attention.parts_grid``) and the one-launch decode's rule
(``cuda_attention.decode_grid``, B6's). Each block sizes its row's splits
from ``lengths[b]``, so a larger grid gives the longer rows more and
shorter splits and adds blocks that exit at once. Prints the card's
``nvidia-smi`` line, then one JSON line per row: ``{"row", "capacity",
"rule", "decode_grid", "ms": {grid: ms}, "fastest"}``.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_parts_grid_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    smoke = importlib.import_module("chip_smoke")
    trees = importlib.import_module("torch_kernel_trees")
    pkg = smoke.PKG
    importlib.import_module(f"{pkg}.ops._kernels").build()
    ca = importlib.import_module(f"{pkg}.ops.cuda_attention")
    cpa = importlib.import_module(f"{pkg}.ops.cuda_paged_attention")
    quantize = importlib.import_module(f"{pkg}.models.quantize").quantize_kv_vector
    rows = [r for r in trees.make_rows(torch, smoke, quantize) if r[0][:2] in ("B4", "B5")]
    print(smoke.nvidia_smi_line(), flush=True)
    timer = smoke.Timer(torch)
    rule = cpa.parts_grid
    try:
        for label, kernel, args in rows:
            fn = getattr(cpa, kernel)
            q, k, table = args[0], args[1], args[-2]
            b, hkv, page = q.shape[0], k.shape[1], k.shape[2]
            capacity = table.shape[1] * page
            top = -(-capacity // 64)
            grids = sorted({g for g in (2, 4, 8, 16, 32, 64, 128) if g <= min(top, 128)}
                           | {rule(b, hkv, capacity), ca.decode_grid(b, hkv, capacity)})
            times = {}
            for n in grids:
                cpa.parts_grid = lambda *_, n=n: n  # noqa: E731
                times[n] = timer.ms(lambda: fn(*args))
            print(json.dumps({
                "row": label, "capacity": capacity, "rule": rule(b, hkv, capacity),
                "decode_grid": ca.decode_grid(b, hkv, capacity), "ms": times,
                "fastest": min(times, key=times.get),
            }), flush=True)
    finally:
        cpa.parts_grid = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
