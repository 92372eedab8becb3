#!/usr/bin/env python3
"""Count how often a ``torch.profiler`` trace of one kernel call loses its
device records, and whether ``chip_smoke.device_kernels`` reads through
the loss.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_profiler_loss.py [--traces 3000]

It builds the port's kernels, then traces B9 (``cuda_int4_matmul`` at
qwen2:1.5b's ``w_gate``, M 8, bf16) ``--traces`` times with one call in
each trace, and as many times bracketed as ``device_kernels`` brackets it
(two ``torch.cuda._sleep`` markers before the call, one after). It counts
the traces by the device kernels they show, in time order: ``K`` is the
call's kernel, ``M`` a marker, so a whole bare trace reads ``K`` and a
whole bracketed one ``MMKM``. Then it calls ``device_kernels`` as many
times on B9 and on the control (``b7_f32_control``: B7 with an f32 q at
Q 5, ``mq_partial_kernel`` and ``parts_merge_kernel``, two kernels) and
counts how many kernels each read gave, how many traces it took again,
and how many reads raised. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import tempfile
import time
from importlib import import_module
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def patterns(torch, fn, traces, bracket, marker):
    """Counter of the kernel patterns ``traces`` profiler traces of one
    call of ``fn`` show, and the indices of the traces that lost any."""
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    whole = "MMKM" if bracket else "K"
    seen, lossy = collections.Counter(), []
    for i in range(traces):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if bracket:
                mark()
                mark()
            fn()
            torch.cuda.synchronize()
            if bracket:
                mark()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        launched = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
        shown = "".join("M" if marker in e["name"] else "K" for e in launched)
        seen[shown] += 1
        if shown != whole:
            lossy.append(i)
    return dict(seen), lossy


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=3000)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_loss: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smoke = import_module("chip_smoke")
    pkg = smoke.PKG
    import_module(f"{pkg}.ops._kernels").build()
    cq = import_module(f"{pkg}.ops.cuda_quant")
    cpa = import_module(f"{pkg}.ops.cuda_paged_attention")
    qmod = import_module(f"{pkg}.models.quantize")

    gen = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn((1536, 8960), generator=gen, device="cuda") / math.sqrt(1536)
    leaf = qmod.quantize_tensor_int4(w)
    x = torch.randn((8, 1536), generator=gen, device="cuda").to(torch.bfloat16)

    def b9():
        return cq.cuda_int4_matmul(x, leaf["q4"], leaf["s"])

    control = smoke.b7_f32_control(torch, cpa)
    out = {"nvidia_smi": smoke.nvidia_smi_line(), "torch": torch.__version__, "traces": args.traces}
    for label, bracket in (("bare", False), ("bracketed", True)):
        t0 = time.perf_counter()
        seen, lossy = patterns(torch, b9, args.traces, bracket, smoke.MARKER_KERNEL)
        out[label] = {"patterns": seen, "lossy_traces": lossy, "seconds": time.perf_counter() - t0}

    retries = []
    smoke.emit = lambda obj: retries.append(obj)  # device_kernels reports a retaken trace here
    for label, fn in (("device_kernels_b9", b9), ("device_kernels_b7_f32_control", control)):
        counts, raised = collections.Counter(), 0
        retries.clear()
        t0 = time.perf_counter()
        for _ in range(args.traces):
            try:
                counts[len(smoke.device_kernels(torch, fn))] += 1
            except AssertionError:
                raised += 1
        out[label] = {"kernels_per_read": dict(counts), "retaken_traces": len(retries),
                      "raised": raised, "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
