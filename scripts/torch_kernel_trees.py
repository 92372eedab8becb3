#!/usr/bin/env python3
"""Time the single-query decode kernels and the w4a8 and int4 matmuls of
several checkouts on the same inputs, in turns, on one CUDA card.

Run from the repository root on a machine with one CUDA card, with each
other checkout unpacked inside this one (for example ``git archive
<commit> | tar -x -C chip_check/parent``):

    python3 scripts/torch_kernel_trees.py . chip_check/parent [--rounds 2] [--only B9 B11]

The inputs are made once, from seeds, with this checkout's
``chip_smoke.py`` helpers, and shared by every tree: B4 and B5 (the paged
parts) at ``paged_kernel_phase``'s rows (the engine batch in pages of 128
and of 48, qwen2:1.5b at B 1 / 16 / 64, phi3, gemma; junk table entries
past every frontier), B6 (the write-through decode) at the write-through
rows, and B2/B3 (the contiguous decode) at ``kernel_phase``'s decode
rows; all in bf16. Then, round by round, each tree's package is imported
from its own root (its kernels built into its own ``_build/``), every
kernel timed with ``chip_smoke.Timer`` (L2 flushed, the card spinning
ahead of each call) and the package dropped again. The trees' order is
reversed every other round (A B, B A, ...), so a drift of the card over
the call shows between rounds, not between trees. Prints the
``nvidia-smi`` line of the card, then one JSON line per (round, tree):
``{"round", "tree", "ms": {row label: ms}}``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def drop_package(pkg: str) -> None:
    for name in [m for m in sys.modules if m == pkg or m.startswith(pkg + ".")]:
        del sys.modules[name]


def load_tree(pkg: str, root: Path) -> dict:
    """The kernel wrapper modules of the checkout at ``root``, its kernels
    built."""
    drop_package(pkg)
    sys.path.insert(0, str(root))
    try:
        mods = {n: importlib.import_module(f"{pkg}.ops.{n}")
                for n in ("_kernels", "cuda_attention", "cuda_paged_attention", "cuda_quant")}
    finally:
        sys.path.remove(str(root))
    for mod in mods.values():
        assert Path(mod.__file__).resolve().is_relative_to(root), (mod.__file__, root)
    mods["_kernels"].build()
    return mods


def make_rows(torch, smoke, quantize_kv_vector, quantize_int4):
    """(label, kernel, args) of every timed row; kernel names the wrapper."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)

    def mixed(n, empty=False):
        lens = torch.randint(62, 1101, (n,), generator=gen, device="cuda").tolist()
        if empty:
            lens[3], lens[4] = 0, 1
        return lens

    shapes = [
        ("engine batch", 32, 12, 2, 128, smoke.batch_prompt_lengths(), smoke.PAGE),
        ("engine batch, page 48", 32, 12, 2, 128, smoke.batch_prompt_lengths(), 48),
        ("B 1", 1, 12, 2, 128, mixed(1), smoke.PAGE),
        ("B 16", 16, 12, 2, 128, mixed(16, empty=True), smoke.PAGE),
        ("B 64", 64, 12, 2, 128, mixed(64), smoke.PAGE),
        ("phi3", 8, 32, 32, 96, mixed(8), smoke.PAGE),
        ("gemma", 8, 8, 1, 256, mixed(8), smoke.PAGE),
    ]
    for label, b, hq, hkv, d, lengths, page in shapes:
        q, k, v, table, lens = smoke.paged_inputs(torch, gen, b, hq, hkv, d, lengths, torch.bfloat16,
                                                  page=page)
        table = smoke.with_junk(torch, gen, table, lens.tolist(), k.shape[0], page=page)
        kq, ks = quantize_kv_vector(k)
        vq, vs = quantize_kv_vector(v)
        rows.append((f"B4 {label}", "cuda_paged_decode_attention_parts", (q, k, v, table, lens)))
        rows.append((f"B5 {label}", "cuda_paged_decode_attention_parts_int8",
                     (q, kq, ks, vq, vs, table, lens)))
    gen = torch.Generator(device="cuda").manual_seed(5)
    for label, page in (("write-through rows", smoke.PAGE), ("write-through rows, page 48", 48)):
        lengths = smoke.write_through_lengths()
        q, k, v, table, lens = smoke.paged_inputs(torch, gen, 8, 12, 2, 128, lengths, torch.bfloat16,
                                                  page=page)
        table = smoke.with_junk(torch, gen, table, lengths, k.shape[0], page=page)
        rows.append((f"B6 {label}", "cuda_paged_decode_attention", (q, k, v, table, lens)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, lens, t in (("length 200", [200], 320), ("length 2100", [2100], 3104),
                           ("self-draft batch", smoke.SELFDRAFT_LENGTHS, 1280)):
        b = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((b, 12, 128), (b, 2, t, 128), (b, 2, t, 128)))
        kq, ks = quantize_kv_vector(k)
        vq, vs = quantize_kv_vector(v)
        rows.append((f"B2 {label}", "cuda_decode_attention", (q, k, v, lengths)))
        rows.append((f"B3 {label}", "cuda_decode_attention_int8", (q, kq, ks, vq, vs, lengths)))
    gen = torch.Generator(device="cuda").manual_seed(6)
    for label, in_dim, out_dim in smoke.W4A8_SHAPES:
        leaf = quantize_int4(torch.randn((in_dim, out_dim), generator=gen, device="cuda") / in_dim ** 0.5)
        x = torch.randn((8, in_dim), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append((f"B11 {label}", "cuda_w4a8_matmul", (x, leaf["q4"], leaf["s"])))
        rows.append((f"B9 {label}", "cuda_int4_matmul", (x, leaf["q4"], leaf["s"])))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkout roots, this one as '.'")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--only", nargs="+", help="keep rows whose label starts with one of these words")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_trees: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    pkg = smoke.PKG
    trees = [(t, Path(t).resolve()) for t in args.trees]
    for name, root in trees:
        if not (root / pkg / "csrc").is_dir():
            print(f"torch_kernel_trees: no {pkg}/csrc under {name}", file=sys.stderr)
            return 2
    sys.path.remove(str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False

    mods = load_tree(pkg, ROOT)
    quantize = importlib.import_module(f"{pkg}.models.quantize")
    rows = make_rows(torch, smoke, quantize.quantize_kv_vector, quantize.quantize_tensor_int4)
    if args.only:
        rows = [r for r in rows if r[0].split()[0] in args.only]
    del mods
    print(smoke.nvidia_smi_line(), flush=True)
    timer = smoke.Timer(torch)
    for rnd in range(args.rounds):
        for name, root in (trees if rnd % 2 == 0 else trees[::-1]):
            mods = load_tree(pkg, root)
            wrappers = {fn.__name__: fn for fn in mods["cuda_attention"].KERNELS
                        + mods["cuda_paged_attention"].KERNELS + mods["cuda_quant"].KERNELS}
            times = {}
            for label, kernel, row_args in rows:
                fn = wrappers[kernel]
                times[label] = timer.ms(lambda: fn(*row_args))
            torch.cuda.synchronize()
            print(json.dumps({"round": rnd, "tree": name, "ms": times}), flush=True)
            del mods, wrappers
    drop_package(pkg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
