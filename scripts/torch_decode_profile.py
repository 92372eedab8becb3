"""Where a decode step of the PyTorch port spends its time, on one CUDA card.

    python3 scripts/torch_decode_profile.py [--new-tokens 33] [--batch | --spec | --serve]
        [--quantize {int8,int4,int4-i32}] [--trace-dir DIR]

Drives ``TorchEngine.generate`` (the study's entry point) on full-width
qwen2:1.5b with ``--quantize`` weights (default int8), once with a bf16 KV
cache and once with an int8 one. With ``--batch`` it drives ``TorchEngine.generate_batch`` over the
paged pool instead (``paged_kv=True``, bf16 and int8 pools), on the 17
requests of ``chip_smoke.py``'s paged phases, each asking for
``--new-tokens``. For each: one warm run, one timed run without the
profiler (wall time per decode step), then one run under
``torch.profiler`` whose Chrome trace gives the device kernels. Prints one
JSON line per KV mode:

- ``wall_ms_per_step``: host clock, unprofiled, ``decode_s / steps``;
- ``device_ms_per_step``: summed kernel durations over the profiled
  request (prefill included, a few percent of it), per decode step; with
  ``--batch``, the difference between the profiled batch and the same
  batch with 9 new tokens, over the difference in decode steps, so the
  grouped prefill drops out;
- ``idle_share``: ``1 - device_ms_per_step / wall_ms_per_step``;
- ``kernels_per_step`` and ``launch_api_ms_per_step`` (host time in
  ``cudaLaunchKernel`` and its kin, profiled);
- the kernel time by category and the top kernels by device time.

With ``--serve`` it times the continuous scheduler's session step by
step (``SteppedDecodeSession.step`` wrapped: its wall, fenced by the
slice's ``.tolist()``, over the decode steps it ran, B4's launches / the
layers) in four arms on one bf16-pool engine: ``session``, the session
driven directly (4 rows); ``served_bare``, ``chip_smoke.py``'s
``serve_continuous`` traffic through an in-process ``GenerationServer``
with no polling thread beside it; ``served_smoke``, the same traffic
exactly as ``chip_smoke.py`` drives it (its 50 ms NVML and session
sampler, and the 10 ms wait for a full session before the high-tier
requests); and ``served_bare`` again. In each arm the first slice with 3
or more live rows runs under ``torch.profiler`` (left out of the wall
figures): device ms, kernels and launch-call ms a step, and the idle
share against the arm's median unprofiled step.

Exits 2 without a CUDA device: these are the card's numbers or none.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODEL = "qwen2:1.5b"
PROMPT = "In 100 words, please give me information about photosynthesis"
# Substrings of kernel names, first match wins.
CATEGORIES = (
    ("attention (port kernels)", (
        "parts_merge_kernel", "prefill_kernel",
        "mq_partial_kernel", "mq_mma_kernel", "decode_tile_kernel", "prefill_mma_kernel",
        "prefill_merge_kernel")),
    ("int4 matmul (port kernels)", ("int4_mma_kernel", "int4_i32_mma_kernel")),
    ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other"


def trace_totals(path: str) -> dict:
    """Kernel and launch-call totals of a Chrome trace, in microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    totals = {"busy_us": 0.0, "kernels": 0, "launch_us": 0.0,
              "by_cat": collections.Counter(), "by_name": collections.Counter(),
              "count_by_name": collections.Counter()}
    for e in events:
        if e.get("cat") == "kernel":
            totals["busy_us"] += e["dur"]
            totals["kernels"] += 1
            totals["by_cat"][category(e["name"])] += e["dur"]
            totals["by_name"][e["name"]] += e["dur"]
            totals["count_by_name"][e["name"]] += 1
        elif e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", ""):
            totals["launch_us"] += e["dur"]
    return totals


def trace_summary(totals: dict, steps: int, minus: "dict | None" = None) -> dict:
    """Per-step figures from ``totals``; with ``minus`` (a shorter run of
    the same requests), from the difference of the two, so that work both
    runs share (the prefill) drops out and ``steps`` is the difference of
    their decode steps."""
    def diff(key):
        if minus is None:
            return totals[key]
        if isinstance(totals[key], collections.Counter):
            out = collections.Counter(totals[key])
            out.subtract(minus[key])
            return out
        return totals[key] - minus[key]

    by_name, counts = diff("by_name"), diff("count_by_name")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_ms_per_step": diff("busy_us") / 1e3 / steps,
        "kernels_per_step": diff("kernels") / steps,
        "launch_api_ms_per_step": diff("launch_us") / 1e3 / steps,
        "by_category_ms_per_step": {k: v / 1e3 / steps for k, v in sorted(diff("by_cat").items())},
        "top_kernels": [
            {"name": n[:120], "ms_per_step": t / 1e3 / steps, "per_step": counts[n] / steps}
            for n, t in top
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new-tokens", type=int, default=33)
    ap.add_argument("--batch", action="store_true",
                    help="profile generate_batch over the paged pool (17 requests)")
    ap.add_argument("--spec", action="store_true",
                    help="profile verify rounds of the n-gram speculative session")
    ap.add_argument("--serve", action="store_true",
                    help="profile the continuous scheduler's session steps, served and not")
    ap.add_argument("--quantize", choices=("int8", "int4", "int4-i32"), default="int8",
                    help="the weights' mode")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the Chrome traces here (default: a temporary directory)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.backend import (
        GenerationRequest,
    )
    from cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch.engine.torch_engine import (
        TorchEngine,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    if args.serve:
        return profile_served_steps(args, torch, profile, ProfilerActivity, TorchEngine,
                                    GenerationRequest, smi)
    if args.spec:
        return profile_spec_rounds(args, torch, profile, ProfilerActivity, TorchEngine,
                                   GenerationRequest, smi)
    if args.batch:
        from chip_smoke import batch_requests

        requests = [
            dataclasses.replace(r, max_new_tokens=args.new_tokens)
            for r in batch_requests(GenerationRequest)
        ]
        run = lambda engine: engine.generate_batch(requests)  # noqa: E731
    else:
        requests = [GenerationRequest(MODEL, PROMPT, args.new_tokens, stop_at_eos=False)]
        run = lambda engine: [engine.generate(requests[0])]  # noqa: E731
    mode = "paged_batch" if args.batch else "solo"

    def profiled_run(engine, fn, path):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn(engine)
        prof.export_chrome_trace(path)
        return out, trace_totals(path)

    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        for kv in (None, "int8"):
            engine = TorchEngine(quantize=args.quantize, kv_quantize=kv, paged_kv=args.batch)
            run(engine)  # warm
            res = run(engine)
            # decode steps: the longest row's tokens after its first
            steps = max(r.generated_tokens for r in res) - 1
            t0 = time.perf_counter()
            profiled, totals = profiled_run(engine, run, os.path.join(
                trace_dir, f"{mode}_{args.quantize}_{kv or 'bf16'}_kv.json"))
            profiled_steps = max(r.generated_tokens for r in profiled) - 1
            minus = None
            if args.batch:
                # the same batch with 9 new tokens: its difference from the
                # long run is decode only
                short = [dataclasses.replace(r, max_new_tokens=9) for r in requests]
                short_res, minus = profiled_run(
                    engine, lambda e: e.generate_batch(short),
                    os.path.join(trace_dir, f"{mode}_{args.quantize}_{kv or 'bf16'}_kv_short.json"),
                )
                profiled_steps -= max(r.generated_tokens for r in short_res) - 1
            summary = trace_summary(totals, profiled_steps, minus)
            wall = res[0].decode_s / steps * 1e3
            print(json.dumps({
                "mode": mode, "rows": len(requests), "weights": args.quantize,
                "kv": kv or "bf16", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                "generated_tokens": sum(r.generated_tokens for r in res), "decode_steps": steps,
                "decode_tokens_per_s": sum(r.generated_tokens for r in res) / res[0].decode_s,
                "wall_ms_per_step": wall,
                "profiled_wall_ms_per_step": (
                    profiled[0].decode_s / (max(r.generated_tokens for r in profiled) - 1) * 1e3),
                "idle_share": 1.0 - summary["device_ms_per_step"] / wall,
                **summary,
                "profile_s": time.perf_counter() - t0,
            }), flush=True)
            del engine
            torch.cuda.empty_cache()
    return 0


def profile_spec_rounds(args, torch, profile, activity, TorchEngine, GenerationRequest, smi) -> int:
    """Per-round figures of the n-gram speculative session (see the module
    docstring), one JSON line per pool kind."""
    from chip_smoke import SPEC_K, spec_requests

    requests = spec_requests(GenerationRequest)
    warm_rounds, rounds = 2, 8
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        for kv in (None, "int8"):
            engine = TorchEngine(quantize=args.quantize, kv_quantize=kv, paged_kv=True,
                                 speculative={MODEL: ("ngram", SPEC_K)})
            session = engine.decode_open(requests)
            assert session.spec is not None

            def emitted():
                return sum(len(r.generated) for r in session.rows if r is not None)

            for _ in range(warm_rounds):
                session.step(1)
            torch.cuda.synchronize()
            before = emitted()
            t0 = time.perf_counter()
            for _ in range(rounds):
                session.step(1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / rounds * 1e3
            tokens = (emitted() - before) / rounds
            assert session.active == len(requests), "a row retired inside the timed rounds"
            path = os.path.join(trace_dir, f"spec_round_{args.quantize}_{kv or 'bf16'}_kv.json")
            with profile(activities=[activity.CPU, activity.CUDA]) as prof:
                for _ in range(rounds):
                    session.step(1)
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            totals = trace_totals(path)
            summary = trace_summary(totals, rounds)
            # the verify's multi-query kernel (B7 or B8), device ms a round
            verify_ms = sum(t for n, t in totals["by_name"].items()
                            if "mq_mma_kernel" in n or "mq_partial_kernel" in n) / 1e3 / rounds
            session.close()
            print(json.dumps({
                "mode": "spec_round", "rows": len(requests), "k": SPEC_K, "weights": args.quantize,
                "kv": kv or "bf16", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                "wall_ms_per_step": wall, "tokens_per_round": tokens,
                "decode_tokens_per_s": tokens / wall * 1e3,
                "idle_share": 1.0 - summary["device_ms_per_step"] / wall,
                "verify_kernel_ms_per_round": verify_ms,
                **summary,
            }), flush=True)
            del engine, session
            torch.cuda.empty_cache()
    return 0


def profile_served_steps(args, torch, profile, activity, TorchEngine, GenerationRequest,
                         smi) -> int:
    """Per-step figures of the continuous scheduler's session, served and
    not (see the module docstring), one JSON line per arm."""
    import statistics
    from importlib import import_module

    import chip_smoke as cs

    stepped = import_module(f"{cs.PKG}.engine.stepped")
    ca = import_module(f"{cs.PKG}.ops.cuda_attention")
    cpa = import_module(f"{cs.PKG}.ops.cuda_paged_attention")
    cq = import_module(f"{cs.PKG}.ops.cuda_quant")
    server_mod = import_module(f"{cs.PKG}.serve.server")
    client_mod = import_module(f"{cs.PKG}.serve.client")
    protocol = import_module(f"{cs.PKG}.serve.protocol")
    nvml = import_module(f"{cs.PKG}.profilers.nvml")
    kernels = ca.KERNELS + cpa.KERNELS + cq.KERNELS
    parts = cpa.cuda_paged_decode_attention_parts

    engine = TorchEngine(quantize=args.quantize, paged_kv=True)
    engine.load_model(MODEL)
    n_layers = engine._models[MODEL].cfg.n_layers
    reqs, gaps = cs.serve_traffic(GenerationRequest, protocol.parse_priority, cs.SERVE_REQUESTS,
                                  cs.SERVE_SEED)
    # warm: a batch, and a session with a chunked joiner (as chip_smoke.py)
    engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in reqs[:2]])
    sess = engine.decode_open([dataclasses.replace(reqs[0], max_new_tokens=4)], reserve_rows=2)
    pj = sess.join_begin(dataclasses.replace(reqs[1], max_new_tokens=4), cs.SERVE_CHUNK_TOKENS)
    while not sess.join_step(pj):
        pass
    sess.join_commit(pj)
    while sess.active:
        sess.step()
    sess.close()

    records = []
    state = {"arm": None, "profile": False}
    step = stepped.SteppedDecodeSession.step

    def recorded_step(self, max_steps=None):
        rows, n0 = self.active, parts.launches
        prof = None
        if state["profile"] and rows >= 3:
            state["profile"] = False
            prof = profile(activities=[activity.CPU, activity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            return step(self, max_steps)
        finally:
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
            records.append({"arm": state["arm"], "rows": rows, "slots": len(self.rows),
                            "steps": (parts.launches - n0) // n_layers, "wall_s": wall,
                            "prof": prof})

    def session_arm():
        rows = [dataclasses.replace(reqs[i], max_new_tokens=128, temperature=0.0,
                                    priority=protocol.DEFAULT_PRIORITY) for i in (1, 2, 3, 4)]
        session = engine.decode_open(rows, reserve_rows=4)
        while session.active:
            session.step()
        session.close()
        return {}

    def served_arm(smoke):
        results, _, _, wall, mean_w, live = cs.drive_server(
            torch, server_mod, client_mod, engine, kernels, reqs, gaps,
            streamed=cs.SERVE_STREAMED, cancelled=cs.SERVE_CANCELLED,
            dev=nvml.nvml_device() if smoke else None, when_full=cs.SERVE_HIGH if smoke else (),
            poll=smoke, scheduler="continuous", prefill_chunk_tokens=cs.SERVE_CHUNK_TOKENS,
        )
        tokens = sum(r.generated_tokens for r in results.values())
        ttft = [r.extras["sched"]["ttft_s"] for r in results.values()]
        return {"requests_done": len(results), "tokens_per_s": tokens / wall, "wall_s": wall,
                "ttft_p50_s": cs.percentile(ttft, 0.5), "max_live_rows": live, "nvml_mean_w": mean_w}

    arms = (("session", session_arm), ("served_bare", lambda: served_arm(False)),
            ("served_smoke", lambda: served_arm(True)), ("served_bare", lambda: served_arm(False)))
    stepped.SteppedDecodeSession.step = recorded_step
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        try:
            for turn, (arm, run) in enumerate(arms):
                state.update(arm=arm, profile=True)
                first = len(records)
                extra = run()
                mine = [r for r in records[first:] if r["steps"]]
                plain = [1e3 * r["wall_s"] / r["steps"] for r in mine if r["prof"] is None]
                by_rows = collections.defaultdict(list)
                for r in mine:
                    if r["prof"] is None:
                        by_rows[r["rows"]].append(1e3 * r["wall_s"] / r["steps"])
                line = {
                    "mode": "served_step", "arm": arm, "turn": turn, "weights": args.quantize,
                    "kv": "bf16", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                    "slices": len(mine), "steps": sum(r["steps"] for r in mine),
                    "slots": sorted({r["slots"] for r in mine}),
                    "wall_ms_per_step_median": statistics.median(plain),
                    "wall_ms_per_step_mean": statistics.fmean(plain),
                    "wall_ms_per_step_by_live_rows": {
                        k: statistics.median(v) for k, v in sorted(by_rows.items())},
                    **extra,
                }
                profiled = [r for r in mine if r["prof"] is not None]
                if profiled:
                    r = profiled[0]
                    path = os.path.join(trace_dir, f"served_step_{turn}_{arm}.json")
                    r["prof"].export_chrome_trace(path)
                    summary = trace_summary(trace_totals(path), r["steps"])
                    line.update(profiled_rows=r["rows"], profiled_steps=r["steps"],
                                profiled_wall_ms_per_step=1e3 * r["wall_s"] / r["steps"],
                                idle_share=1.0 - summary["device_ms_per_step"]
                                / line["wall_ms_per_step_median"], **summary)
                print(json.dumps(line), flush=True)
                for r in records[first:]:
                    r["prof"] = None
        finally:
            stepped.SteppedDecodeSession.step = step
    return 0


if __name__ == "__main__":
    sys.exit(main())
