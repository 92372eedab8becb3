#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per source,
all started together), holds each kernel against its plain PyTorch version
on the card and times both (with the library yardstick and the card's bound
beside them), then drives the port's paths on full-width qwen2:1.5b:
``TorchEngine.generate`` (the study's solo path) at int8 weights with a
bf16 and then an int8 KV cache (7 of 28 layers), ``TorchEngine.generate_batch`` over the
paged pool (17 requests) with a bf16 and then an int8 pool (at 7 of 28
layers), ``generate``
at int4 and at int4-i32 weights, one engine with per-model modes (qwen2 at
int8, 7 layers, and full-width llama3.1:8b at int4), an int4 paged batch
of 8 rows (7 layers),
the write-through paged decode (8 rows prefilled, written into a pool
with ``write_prefill`` and decoded through ``forward`` with the engine's
paged dispatch, whose attention is B6), and speculative sessions over the
paged pool (``decode_open`` and ``step``): an n-gram draft over 8 rows
with a bf16 and an int8 pool (7 layers), whose verify runs the multi-query kernels
B7/B8, ``generate_speculative`` and ``generate``'s routing, an n-gram
session at k 12 (its 13-position verify block runs B7 in one launch a
layer: two q-tiles of the tensor-core kernel), and a self-draft whose
draft steps run B2. The kernel rows also hold the stacked ``layer=`` form
of B4/B5/B7/B8 bit for bit against the per-layer call, and
``torch.profiler`` traces show that one call of B4/B5 (the paged parts,
at the batch's rows), of B6 (write-through decode), of B9 and B10 (int4
matmuls), of B11 (the w4a8 matmul, x quantized inside it) and of B7/B8
(the verify, at Q 5 and 13) each runs one device kernel, beside a control
of two (B7 with an f32 q). The w4a8 probe
(``scripts/torch_w4a8_probe.py``) drives B11 and B9. Last, the study's
measured run: the port's ``ExperimentController`` over ``LlmEnergyConfig``
(qwen2:1.5b at int8, on_device and the aliased remote, 100 words, two
repetitions) writes four rows, each with NVML's measured Joules beside
the modelled ones, after NVML's idle power is read for 2 s; then the study
from the command line (``runner.cli.main`` over two config files: the
study's 7 models at 100 words, one repetition, the table analysed, then
``recompute-energy``).
The serving phases run the port's
``GenerationServer`` in this process over HTTP on 127.0.0.1 at int8
weights (7 of 28 layers): ``serve_continuous`` (the continuous scheduler over the bf16
pool, 16 requests with seeded Poisson arrivals: joins in prefill chunks
through B1, streams, a cancelled stream, and two high-priority requests
that preempt rows to host memory and resume them; B4 decodes; every
greedy row replayed teacher-forced, its tokens' logits within
LOGIT_ATOL of each position's maximum), ``serve_continuous_int8_kv``
(B5), ``serve_window`` (``generate_batch``) and ``serve_serial``
(``generate`` and ``generate_stream`` on B2). Then the contiguous
layouts, the JAX package's defaults: ``engine_batch_contiguous``
(``generate_batch`` without ``paged_kv``, 7 layers: the 17 batch rows
over one bf16 cache, 8 over an int8 one; B2/B3 once a layer a step, every greedy
row replayed teacher-forced), ``serve_continuous_contiguous``
(``serve_continuous``'s traffic on the contiguous session, the
high-priority requests preempting rows with ``recompute``: their K/V
dropped and re-prefilled in join chunks, the redone tokens charged to
the wasted-energy ledger), ``serve_window_contiguous`` (8 requests,
int8 cache), and ``engine_lru`` (three study models at int8 under an
allocation budget that holds two: the least recently used is evicted
and its memory freed, a model with a live session is passed over, and
the evicted one reloads with the same tokens). Last,
``serve_cli_capstone`` starts ``python -m …_tpu_torch serve --backend
torch`` as a subprocess and runs the study as its HTTP client for both
locations, then stops the server with SIGTERM. Then the solo engine's
rest: ``engine_prefix_cache`` (+ ``_int8_kv``; 7 layers: a 2,048-token
turn, then that prompt plus 64 tokens run cold and with a prefix hit:
equal greedy tokens, B1 two launches a layer cold and one on a hit; then
a byte cap that evicts), ``engine_hf_checkpoint`` (a full-width checkpoint written under
HF's names, loaded through ``hf_checkpoints`` and the weight cache: every
leaf bit-equal to the install path's), ``serve_cli_hf`` (``serve --hf
... --prefix-cache 4`` in a subprocess: two prefix hits over three
requests) and ``study_duty_trace`` (two study rows, 7 layers, with NVML's
duty cycle and a ``torch.profiler`` trace naming the port's kernels; every
study row now carries the duty cycle). Then the rest of speculation: the
kernel rows of B7/B8's contiguous instantiations (the contiguous
session's verify, beside SDPA under the same per-query mask),
``engine_spec_contiguous_bf16_kv`` / ``_int8_kv`` (the 8 n-gram rows and
a joiner on the engine's default contiguous layout at 7 layers, B7/B8
over contiguous rows once a layer a round, the greedy share against the
plain contiguous session), ``spec_contiguous_entry_points`` (``generate``
routing a greedy and a sampled request there), ``engine_spec_adaptive``
(a 2-layer cross-model draft with no skill under a floor of 0.5: k 4 ->
2 -> 1, the fallback to plain decode, the draft's wasted Joules, tokens/s
before and after), ``engine_spec_join_preempt_paged`` / ``_contiguous``
(a greedy and a sampled joiner, and a row preempted by swap whose resumed
tokens equal an uninterrupted run's) and ``serve_cli_speculative_contiguous``
(``serve --speculative qwen2:1.5b=ngram:4 --spec-accept-floor 0.3``
without ``--paged-kv``, 8 requests, exit 0). Last, the shared prefix
store and live row migration: ``engine_prefix_share_paged`` (7 layers,
bf16 pool: a 2,048-token anchor joined in 256-token chunks, then three
joiners sharing whole pages, one diverging mid-page and one sharing BOS
alone; the aligned hits' tokens equal the cold joins', the other two are
held by their replay, B1 runs only over the tails, the pages the rows
hold with and without sharing), ``engine_prefix_share_spill`` (7 layers: a
one-node device budget spills a node that a later joiner restores, int8
pool; seed-only reuse on the contiguous session), ``serve_migrate`` and
``serve_migrate_evacuate`` (7 layers: an idle decode server refuses a
bundle; rows primed on a prefill server, seated through
``/api/migrate`` on the decode server once a row is live there, and
four live rows evacuated; every row's tokens equal one server's, the
counts read around the primes and seats and around the evacuation and
seats, and each transfer's charge read from the seating server's
``/metrics``) and
``serve_cli_prefix_share`` (``serve --prefix-share`` as a subprocess).
Last, the mixture-of-experts MLP on mixtral:8x7b at full width and
depth (32 layers, 8 experts of d_ff 14,336, top-2), after every earlier
engine has let go: ``mixtral_bf16_refused`` (the bf16 load, 93.4 GB,
refused before it allocates), ``mixtral_load_int8`` (46.7 GB, the
allocator's peak over the weights), ``moe_layer`` (one layer's dense
dispatch against an independent routed loop), ``engine_mixtral_int8``
(the study's ``generate``, bf16 KV cache), ``engine_mixtral_int8_kv``,
``engine_mixtral_paged_batch`` (4 rows over the paged pool) and, on a
fresh int4 engine, ``engine_mixtral_int4`` (B9 on the attention
weights); each request's tokens replayed teacher-forced through the plain
forward under the served routing.
Every launch count is set to 0 just before each path and read just after,
to check that the path ran through its kernels and no other. Each phase
prints one JSON line; the last line is the result the caller reads. Any failure raises,
prints no result line and exits non-zero. Without a CUDA device, or
without the port's package beside it, it exits 2 at once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PKG = "cain_2025_device_remote_llm_energy_rep_pkg_tpu_torch"
JAX_PKG = "cain_2025_device_remote_llm_energy_rep_pkg_tpu"
# Each kernel wrapper: (its CUDA source, the pallas_call it replaces).
KERNEL_INFO = {
    "cuda_prefill_attention": (f"{PKG}/csrc/attention.cu", f"{JAX_PKG}/ops/pallas_attention.py:451"),
    "cuda_decode_attention": (f"{PKG}/csrc/attention.cu", f"{JAX_PKG}/ops/pallas_attention.py:144"),
    "cuda_decode_attention_int8": (f"{PKG}/csrc/attention.cu", f"{JAX_PKG}/ops/pallas_attention.py:286"),
    "cuda_paged_decode_attention": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:705"),
    "cuda_paged_decode_attention_parts": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:826"),
    "cuda_paged_decode_attention_parts_int8": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:953"),
    "cuda_paged_decode_attention_mq_parts": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:531"),
    "cuda_paged_decode_attention_mq_parts_int8": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:531"),
    # B7/B8's bodies over contiguous rows (the contiguous verify, which the
    # JAX package attends in XLA under a per-row mask)
    "cuda_contiguous_mq_attention": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:531"),
    "cuda_contiguous_mq_attention_int8": (
        f"{PKG}/csrc/paged_attention.cu", f"{JAX_PKG}/ops/pallas_paged_attention.py:531"),
    "cuda_int4_matmul": (f"{PKG}/csrc/int4_matmul.cu", f"{JAX_PKG}/ops/pallas_quant.py:266"),
    "cuda_int4_matmul_i32": (f"{PKG}/csrc/int4_matmul.cu", f"{JAX_PKG}/ops/pallas_quant.py:199"),
    "cuda_w4a8_matmul": (f"{PKG}/csrc/int4_matmul.cu", "scripts/w4a8_probe.py:103"),
}
MODEL = "qwen2:1.5b"
LARGE_MODEL = "llama3.1:8b"  # the widest dense model of the study
# The head layouts of the study's 7B/8B models, (label, hq, hkv, d): the
# kernel phase checks B1/B2 at each, and each model below runs the
# full-width logits comparison.
WIDE_LAYOUTS = (
    ("qwen2:7b", 28, 4, 128),
    ("mistral:7b / llama3.1:8b", 32, 8, 128),
    ("gemma:7b", 16, 16, 256),
)
WIDE_MODELS = ("qwen2:7b", "mistral:7b", "gemma:7b")
# Dense matmuls of a layer (wq, wk, wv, wo, w_gate, w_up, w_down): each is
# one int4 kernel launch per decode forward of at most 8 rows.
MATMULS_PER_LAYER = 7
# (label, IN, OUT) of the int4 kernel rows, at M 1 and 8: the seven decode
# matmuls (four shapes each) of qwen2:1.5b and of llama3.1:8b; then one odd
# shape.
INT4_SHAPES = (
    ("qwen2:1.5b w_gate/w_up", 1536, 8960),
    ("qwen2:1.5b wq/wo", 1536, 1536),
    ("qwen2:1.5b wk/wv", 1536, 256),
    ("qwen2:1.5b w_down", 8960, 1536),
    ("llama3.1:8b w_gate/w_up", 4096, 14336),
    ("llama3.1:8b w_down", 14336, 4096),
    ("llama3.1:8b wq/wo", 4096, 4096),
    ("llama3.1:8b wk/wv", 4096, 1024),
)
INT4_ODD_SHAPE = ("odd", 3, 96, 200)  # (label, M, IN, OUT)
# (label, IN, OUT) of the w4a8 kernel rows, at the probe's M 8.
W4A8_SHAPES = (
    ("w4a8 probe (qwen2:1.5b w_gate)", 1536, 8960),
    ("llama3.1:8b w_gate/w_up", 4096, 14336),
)
# H100 SXM data-sheet peaks: HBM3 bytes/s, dense bf16 tensor-core FLOP/s
# and dense int8 tensor-core OP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
# Kernel vs plain version on the same inputs. bf16 outputs: both round one
# f32 result to bf16 once, so they differ by at most ~1 bf16 ulp of |out|
# <= 4 (0.0156) from f32 sums taken in another order. f32 runs: 1e-4.
BF16_ATOL = 2e-2
F32_ATOL = 1e-4
# The multi-query tensor-core kernel (B7/B8 with a bf16 q) rounds each p,
# the V scale folded in, to bf16 for the P·V product: a relative error of
# at most 2^-9 a term, so acc/l moves by at most about 2^-9 · max|v|,
# held within atol + rtol · |acc/l| at 5e-3.
MQ_MMA_ATOL = 5e-3
# Full-width logits, kernels vs plain versions injected into the same model
# (bf16 activations through 28 layers; logits are O(1)).
LOGIT_ATOL = 0.25
STUDY_WORDS = (100, 500)  # the study's response lengths, words
TOKENS_PER_WORD = 4 / 3
STUDY_PROMPT = "In {words} words, please give me information about photosynthesis"
PAGE = 128
# The paged batch: the study prompt and contexts of about 300, 700 and
# 1,100 tokens, four of each, plus one 2,112-token prompt that prefills in
# two chunks; 17 rows pad to a bucket of 32.
BATCH_CONTEXTS = (292, 300, 308, 316, 690, 700, 710, 720, 1086, 1094, 1100, 1108)
# The int4 paged batch: two each of the study prompt and the 300-, 700- and
# 1,100-token contexts; 8 rows, so decode takes the int4 kernel route.
INT4_BATCH_CONTEXTS = (300, 300, 700, 700, 1100, 1100)
LONG_PROMPT_TOKENS = 2112
# Speculative sessions: draft tokens per round (the verify block is k + 1
# query positions), the n-gram session's new tokens per row, and the
# self-draft session's rows and new tokens.
SPEC_K = 4
SPEC_NEW_TOKENS = 134
SELFDRAFT_ROWS = 4
SELFDRAFT_NEW_TOKENS = 64
# The self-draft's draft cache midway through its session (B2's batch):
# the study prompt and the 300-, 700- and 1,100-token contexts plus 32
# generated tokens.
SELFDRAFT_LENGTHS = [94, 332, 732, 1132]
# The long-k n-gram session: k = 12 makes a verify block of 13 query
# positions, which the tensor-core multi-query kernel takes in one launch
# (two q-tiles of 64 // G = 10 positions); a few greedy rows at a few
# rounds.
LONG_SPEC_K = 12
LONG_SPEC_ROWS = 4
LONG_SPEC_NEW_TOKENS = 40
# The contiguous speculating sessions: the 8 n-gram rows and a joiner of
# this many context tokens, after one slice; the weak cross-model draft
# of the adaptive phase (qwen2:1.5b's config at 2 layers, its own random
# weights) under its floor, and the slice it steps at; the floor of
# ``serve_cli_speculative_contiguous`` and its requests.
CONTIG_SPEC_JOINER_TOKENS = 500
WEAK_DRAFT = "qwen2:1.5b-2l"
WEAK_DRAFT_LAYERS = 2
WEAK_DRAFT_SEED = 17
ADAPTIVE_FLOOR = 0.5
ADAPTIVE_SLICE_STEPS = 8
CLI_SPEC_FLOOR = 0.3
CLI_SPEC_REQUESTS = 8
# The contiguous verify kernel returns attention in q's dtype: a bf16
# output rounds once more, by up to one bf16 ulp of |out| <= 4 (0.0156),
# on top of the tensor-core kernel's 5e-3 (the bf16 p of P·V).
CONTIG_MQ_BF16_ATOL = 2e-2
# The write-through phase's greedy decode steps (B6 launches n_layers ×
# this many times).
WRITE_THROUGH_STEPS = 64
# The solo phases of the int8 KV cache and the int4 layouts run
# qwen2:1.5b cut to this many of its 28 layers (full width): with the
# contiguous and LRU phases the whole script took 1,052.5 s, 88% of its
# limit, and these three phases about 170 s of it (PERF.md, PR 14). With
# the prefix-cache, checkpoint and duty-cycle phases (~220 s) the serving
# phases over an int8 cache and the contiguous session's traffic were cut
# to it too (``cut_registry``): before the cut the script reached the new
# phases at 879.3 s, and those phases took 115 s at full depth. With the
# rest of speculation's phases (~95 s; the whole script 1,030.8 s in its
# first run with them) the int8-pool paged batch and n-gram session and
# the bf16 contiguous batch were cut to it too (~40 s at full depth), and
# so are the join/preempt phases of speculating sessions. With the shared
# prefix store's and migration's phases (76 s alone, their spill and
# migration phases at this depth; the script took 1,016.1 s without
# them) the bf16 pool's serving phases (``serve_continuous`` with its
# greedy replay, ``serve_window``, ``serve_serial``: ~147 s at full depth)
# were cut to it too: the script then took 1,014.5 s, and 1,255.6 s to
# fail in its migration phase on a card whose host ran every phase
# 1.2-1.3x slower. So the solo bf16-KV phase with its logits check, the
# paged bf16-pool batch with the write-through decode, the bf16-pool
# n-gram session, the contiguous layout's speculating sessions and the
# solo prefix cache (~115 s at full depth) were cut to it too. With
# mixtral:8x7b's phases (72 s alone) the shared prefix store's paged phase
# (17.2 s at full depth; ``serve_cli_prefix_share`` runs the store at full
# depth) and the study's two traced rows (86.0 s; the ``study`` phase runs
# the study's own engine at full depth) were cut to it too; then, after
# the script took 1,012.7 s on a host 1.1-1.2x slower than PR 17's, the
# int4 paged batch (12.9 s at full depth; llama3.1:8b's and mixtral's int4
# phases run B9 at full depth) and the qwen2:1.5b half of the mixed-mode
# engine (the study runs it at full depth). The study's own rows stay at
# full depth: at 7 layers a row lasts ~1.8 s, too short for NVML's
# sampled and counted watts to agree within STUDY_POWER_AGREEMENT.
SOLO_CUT_LAYERS = 7


def cut_registry():
    """qwen2:1.5b at full width, cut to SOLO_CUT_LAYERS layers."""
    from importlib import import_module

    cfg = import_module(f"{PKG}.models.config").get_model_config(MODEL)
    return {MODEL: dataclasses.replace(cfg, n_layers=SOLO_CUT_LAYERS)}
# B2/B3 at a contiguous session's widths: the serving session's 4 rows
# over its cache (a 1,024-token prompt bucket + 128 generated), and 16
# and 64 rows over the widest cache the study's rows make (a 2,112-token
# prompt allocation + the 1,000-word answer's 2,048 bucket), the rows'
# lengths spread up to 2,112 + 1,334 tokens, one of them the whole
# cache (a frozen row at its last position reads every slot of its own).
SESSION_DECODE_SHAPES = (
    ("qwen2:1.5b session 4 rows", [60, 400, 700, 1100], 1152),
    ("qwen2:1.5b session 16 rows", [100 + (3446 - 100) * i // 14 for i in range(15)] + [4160], 4160),
    ("qwen2:1.5b session 64 rows", [100 + (3446 - 100) * i // 62 for i in range(63)] + [4160], 4160),
)
# The contiguous batch's rows compared with their solo generate over
# their first this many tokens (the share is printed, not gated).
CONTIG_SOLO_TOKENS = 32
CONTIG_INT8_ROWS = 8  # the int8-KV contiguous batch: the first rows of batch_requests
# The LRU guard's phase: three study models at int8, the least recently
# used of the first two evicted to make room for the third.
LRU_MODELS = ("qwen2:1.5b", "gemma:2b", "phi3:3.8b")
LRU_NEW_TOKENS = 16
LRU_FREED_SHARE = 0.9  # memory_allocated must fall by this share of the evicted weights


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each launch
    (on the engine path every attention call follows ~50 MB of one layer's
    weights, and every int4 matmul reads weights no earlier call left in
    L2). Before each launch the card spins (``torch.cuda._sleep``) for
    twice the host's time to enqueue one call, so the events time the
    device's work and not the host's wrapper and launch calls."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cycles = 10_000_000
        torch.cuda._sleep(cycles)  # warm
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = cycles / start.elapsed_time(end)

    def ms(self, fn, min_iters=5, max_iters=100, budget_s=0.3) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0  # enqueue only
        torch.cuda.synchronize()
        one = max(time.perf_counter() - t0, 1e-6)
        iters = int(min(max_iters, max(min_iters, budget_s / one)))
        lead = int(self.cycles_per_ms * (2 * host * 1e3 + 0.05))
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(lead)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(bytes_moved: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, ca, plain, timer):
    """Every kernel against its plain version at the main path's shapes
    (and phi3/gemma head dims), in bf16 with timings and in f32 for a
    tight check. Returns the first row of each kernel for the summary."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    from importlib import import_module

    quantize_kv_vector = import_module(f"{PKG}.models.quantize").quantize_kv_vector
    summary = {}

    def record(row):
        emit({"phase": "kernel", **row})
        summary.setdefault(row["name"], row)

    # (label, hq, hkv, d, the rows' lengths, capacity T)
    decode_shapes = [
        ("qwen2:1.5b", 12, 2, 128, [200], 320),
        ("qwen2:1.5b", 12, 2, 128, [2100], 3104),
        ("qwen2:1.5b self-draft batch", 12, 2, 128, SELFDRAFT_LENGTHS, 1280),
        ("phi3:3.8b", 32, 32, 96, [1000], 1024),
        ("gemma:2b", 8, 1, 256, [1000], 1024),
    ]
    # The study's wide layouts as its rows give them to B1/B2: 100 words
    # decode over ~200 positions of a 320-slot cache, 1,000 words over
    # ~1,400 of 2,112; prompts of 53-73 tokens prefill at S 64 or 128.
    for label, hq, hkv, d in WIDE_LAYOUTS:
        decode_shapes += [(label, hq, hkv, d, [200], 320), (label, hq, hkv, d, [1400], 2112)]
    decode_shapes += [(label, 12, 2, 128, lens, t) for label, lens, t in SESSION_DECODE_SHAPES]
    # (label, batch, hq, hkv, d, S, capacity T, offset)
    prefill_shapes = [
        ("qwen2:1.5b", 1, 12, 2, 128, 64, 320, 0),
        ("qwen2:1.5b", 1, 12, 2, 128, 2048, 3104, 0),
        ("qwen2:1.5b", 1, 12, 2, 128, 32, 3104, 2048),  # chunked-prefill tail
        ("phi3:3.8b", 1, 32, 32, 96, 128, 1024, 0),
        ("gemma:2b", 1, 8, 1, 256, 128, 1024, 0),
        ("qwen2:1.5b", 16, 12, 2, 128, 512, 512, 0),  # a grouped batch prefill
    ]
    for label, hq, hkv, d in WIDE_LAYOUTS:
        prefill_shapes += [(label, 1, hq, hkv, d, 64, 320, 0), (label, 1, hq, hkv, d, 128, 2176, 0)]
    for label, b, hq, hkv, d, s, t, offset in prefill_shapes:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(b, s, hq, d, dtype=dtype)
            k = rnd(b, hkv, t, d, dtype=dtype)
            v = rnd(b, hkv, t, d, dtype=dtype)
            out = ca.cuda_prefill_attention(q, k, v, offset)
            ref = plain.prefill_attention_cached(q, k, v, offset)
            torch.cuda.synchronize()
            errs[dtype] = (out.float() - ref.float()).abs().max().item()
        assert errs[torch.float32] <= F32_ATOL, (label, "prefill f32", errs)
        assert errs[torch.bfloat16] <= BF16_ATOL, (label, "prefill bf16", errs)
        ms = timer.ms(lambda: ca.cuda_prefill_attention(q, k, v, offset))
        plain_ms = timer.ms(lambda: plain.prefill_attention_cached(q, k, v, offset), max_iters=20)
        qt = q.transpose(1, 2)
        kv_len = offset + s
        if offset == 0:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, k[:, :, :s], v[:, :, :s], is_causal=True, enable_gqa=True)
        else:
            mask = torch.arange(kv_len, device="cuda")[None, :] <= (
                offset + torch.arange(s, device="cuda")[:, None])
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, k[:, :, :kv_len], v[:, :, :kv_len], attn_mask=mask, enable_gqa=True)
        library_ms = timer.ms(lib)
        pairs = b * sum(offset + i + 1 for i in range(s))
        b_ms, b_by = bound(b * (2 * s * hq * d * 2 + 2 * hkv * kv_len * d * 2), 4 * hq * d * pairs)
        record({
            "name": "cuda_prefill_attention", "shape": label, "B": b, "S": s, "T": t, "offset": offset,
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        })

    for label, hq, hkv, d, lens, t in decode_shapes:
        b = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for name in ("cuda_decode_attention", "cuda_decode_attention_int8"):
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                q = rnd(b, hq, d, dtype=dtype)
                k = rnd(b, hkv, t, d, dtype=dtype)
                v = rnd(b, hkv, t, d, dtype=dtype)
                if name == "cuda_decode_attention":
                    args = (q, k, v, lengths)
                    fn, ref_fn = ca.cuda_decode_attention, plain.decode_attention_reference
                else:
                    kq, ks = quantize_kv_vector(k)
                    vq, vs = quantize_kv_vector(v)
                    args = (q, kq, ks, vq, vs, lengths)
                    fn, ref_fn = ca.cuda_decode_attention_int8, plain.decode_attention_int8_reference
                fn.launches = 0
                out = fn(*args)
                per_call = fn.launches
                ref = ref_fn(*args)
                torch.cuda.synchronize()
                errs[dtype] = (out.float() - ref.float()).abs().max().item()
            assert errs[torch.float32] <= F32_ATOL, (label, name, "f32", errs)
            assert errs[torch.bfloat16] <= BF16_ATOL, (label, name, "bf16", errs)
            assert per_call == 1, (label, name, per_call, "launches a call")
            ms = timer.ms(lambda: fn(*args))
            plain_ms = timer.ms(lambda: ref_fn(*args), max_iters=20)
            if name == "cuda_decode_attention":
                if b == 1:
                    length = lens[0]
                    library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                        q[:, :, None], k[:, :, :length], v[:, :, :length], enable_gqa=True))
                else:
                    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
                    library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
                kv_bytes = 2 * hkv * sum(lens) * d * 2
            else:
                library_ms = None  # no single PyTorch call reads int8 codes + scales
                kv_bytes = 2 * hkv * sum(lens) * (d + 4)
            b_ms, b_by = bound(2 * b * hq * d * 2 + kv_bytes + 4 * b, 4 * hq * d * sum(lens))
            record({
                "name": name, "shape": label, "B": b, "length": lens[0] if b == 1 else lens, "T": t,
                "launches_per_call": per_call,
                "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            })
    return summary


def int4_kernel_phase(torch, cq, qplain, qmod, timer, control):
    """B9 and B10 against their plain versions at the main path's shapes
    (weights at the model's 1/sqrt(IN) scale, so outputs are O(1)), f32 to
    F32_ATOL and bf16 to BF16_ATOL, timed in bf16 beside torch.matmul on
    the dequantized bf16 weight (made once, outside the timing); B10 runs
    on the same weights as B9, and B9 is timed again beside it. A second
    call of each gives the same bits; at qwen2's w_gate, M 8, one call of
    B9 and one of B10 each run one device kernel (``control``, two device
    kernels, is the profiler's control); and a CUDA x of 9 rows must raise. Returns
    the first row of each kernel (qwen2's w_gate at M 1) for the
    summary."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    kernels = {
        "cuda_int4_matmul": (cq.cuda_int4_matmul, qplain.int4_matmul_reference,
                             qmod.quantize_tensor_int4, "q4"),
        "cuda_int4_matmul_i32": (cq.cuda_int4_matmul_i32, qplain.int4_matmul_i32_reference,
                                 qmod.quantize_tensor_int4_i32, "q32"),
    }
    cases = [(label, m, i, o) for label, i, o in INT4_SHAPES for m in (1, 8)] + [INT4_ODD_SHAPE]
    summary = {}
    for label, m, in_dim, out_dim in cases:
        w = torch.randn((in_dim, out_dim), generator=gen, device="cuda") / math.sqrt(in_dim)
        leaves = {name: quantize(w) for name, (_, _, quantize, _) in kernels.items()}
        for name, (fn, ref_fn, _, key) in kernels.items():
            leaf = leaves[name]
            codes, scale = leaf[key], leaf["s"]
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, in_dim), generator=gen, device="cuda").to(dtype)
                out = fn(x, codes, scale)
                ref = ref_fn(x, codes, scale)
                again = fn(x, codes, scale)
                torch.cuda.synchronize()
                errs[dtype] = (out.float() - ref.float()).abs().max().item()
                assert torch.equal(out, again), (label, name, "two calls differ")
            assert errs[torch.float32] <= F32_ATOL, (label, name, "f32", errs)
            assert errs[torch.bfloat16] <= BF16_ATOL, (label, name, "bf16", errs)
            profiled = {}
            if label.endswith("w_gate/w_up") and m == 8 and in_dim == 1536:
                profiled = one_kernel_per_call(torch, name, lambda: fn(x, codes, scale), control)
            w_bf16 = qmod.maybe_dequant(leaf, torch.bfloat16)
            ms = timer.ms(lambda: fn(x, codes, scale))
            plain_ms = timer.ms(lambda: ref_fn(x, codes, scale), max_iters=20)
            library_ms = timer.ms(lambda: torch.matmul(x, w_bf16))
            beside = {}
            if key == "q32":  # B9 on the same weights and x, in the same call: the control
                b9 = leaves["cuda_int4_matmul"]
                beside["b9_ms_same_weights"] = timer.ms(lambda: cq.cuda_int4_matmul(x, b9["q4"], b9["s"]))
            bytes_moved = codes.numel() * codes.element_size() + out_dim * 4 + m * (in_dim + out_dim) * 2
            b_ms, b_by = bound(bytes_moved, 2 * m * in_dim * out_dim)
            n_split = cq._mma_split(codes.shape[0], out_dim, in_dim // codes.shape[0])[0]
            row = {
                "name": name, "shape": label, "M": m, "IN": in_dim, "OUT": out_dim,
                "splits": n_split, **profiled, "tickets": cq._tickets_needed(out_dim, n_split),
                "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
                "ms": ms, **beside, "plain_ms": plain_ms,
                # torch.matmul on the dequantized bf16 weight: 4x the bytes
                "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            }
            emit({"phase": "kernel", **row})
            summary.setdefault(name, row)
        del w, w_bf16, leaves
    too_many = qplain.MAX_KERNEL_ROWS + 1
    for name, (fn, _, quantize, key) in kernels.items():
        leaf = quantize(torch.randn((64, 128), generator=gen, device="cuda"))
        try:
            fn(torch.zeros((too_many, 64), device="cuda"), leaf[key], leaf["s"])
        except ValueError as err:
            emit({"phase": "kernel", "name": name, "M": too_many, "raised": str(err)})
        else:
            raise AssertionError(f"{name} took a CUDA x of {too_many} rows")
    return summary


def batch_prompt_lengths():
    """Token counts of the paged engine phase's 17 prompts (the byte
    tokenizer gives one token per character plus a BOS)."""
    study = len(STUDY_PROMPT.format(words=STUDY_WORDS[0])) + 1
    return [study] * 4 + list(BATCH_CONTEXTS) + [LONG_PROMPT_TOKENS]


def paged_inputs(torch, gen, b, hq, hkv, d, lengths, dtype, session=False, page=PAGE):
    """q, a pool of ``page``-position pages in a shuffled permutation (plus
    three pages no row names) and its table; rows past ``lengths`` are pad
    rows that point every entry at one private page, as the engine's do.
    The table is as wide as the batch path's (pow2 of the most pages a row
    needs), or with ``session`` as a stepped session's (pow2 of twice
    that)."""
    need = [-(-n // page) for n in lengths]
    jmax = 1
    while jmax < max(need + [1]) * (2 if session else 1):
        jmax *= 2
    n_pool = sum(need) + 4
    perm = torch.randperm(n_pool, generator=gen, device="cuda").tolist()
    table = torch.zeros((b, jmax), dtype=torch.int32)
    pos = 0
    for r, k in enumerate(need):
        table[r, :k] = torch.tensor(perm[pos : pos + k])
        pos += k
    table[len(lengths):] = perm[-1]
    lens = list(lengths) + [lengths[0]] * (b - len(lengths))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

    q = rnd(b, hq, d)
    k = rnd(n_pool, hkv, page, d)
    v = rnd(n_pool, hkv, page, d)
    return q, k, v, table.cuda(), torch.tensor(lens, dtype=torch.int32, device="cuda")


def parts_errors(torch, got, want, tol):
    """Largest differences of (acc/l, m, l) over rows with cached tokens,
    whether each is within atol = rtol = ``tol``, and whether every row
    with no cached token came out exactly (0, -inf, 0)."""
    acc, m, l = (x.float() for x in got)
    acc_r, m_r, l_r = (x.float() for x in want)
    live = l_r > 0
    empty_exact = bool(
        torch.equal(l == 0, ~live)
        and torch.all(torch.isneginf(m[~live]))
        and torch.all(acc[~live] == 0)
    )
    pairs = {
        "out": ((acc / l[..., None])[live], (acc_r / l_r[..., None])[live]),
        "m": (m[live], m_r[live]),
        "l": (l[live], l_r[live]),
    }
    errs, ok = {}, empty_exact
    for key, (a, b) in pairs.items():
        diff = (a - b).abs()
        errs[key] = diff.max().item()
        ok = ok and bool(torch.all(diff <= tol + tol * b.abs()))
    return errs, ok, empty_exact


def paged_kernel_phase(torch, cpa, plain, timer, quantize_kv_vector, control):
    """The paged parts kernels against their plain versions: at the paged
    engine phase's own batch (17 rows of the 62–2,112-token prompts, pad
    rows to 32), once more in pages of 48 positions (not a multiple of
    the kernel's 32-position tile: each position looked up), at qwen2:1.5b
    widths for B 1, 16 (with a row that has no cached token and one that
    has one) and 64 with lengths of 62–1,100 tokens, and at the phi3/gemma
    head dims; every table with junk entries past each row's pages.
    float32 to 1e-4, bfloat16 to 2e-2 on acc/l, m and l (atol = rtol),
    the empty row exactly (0, -inf, 0); two calls give the same bits. At
    the engine batch a ``torch.profiler`` trace shows one device kernel a
    call (``control`` shows two). Timed in bf16 beside SDPA with a length
    mask over the rows gathered (B5: and dequantized) into a contiguous
    bf16 cache, the gather untimed: it computes acc / l only. Returns the
    engine-batch row of each kernel for the summary."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(1)

    def mixed(n, empty=False):
        lens = torch.randint(62, 1101, (n,), generator=gen, device="cuda").tolist()
        if empty:
            lens[3] = 0
            lens[4] = 1
        return lens

    # (label, batch, hq, hkv, d, lengths of the real rows, page)
    shapes = [
        ("qwen2:1.5b engine batch", 32, 12, 2, 128, batch_prompt_lengths(), PAGE),
        ("qwen2:1.5b engine batch, page 48", 32, 12, 2, 128, batch_prompt_lengths(), 48),
        ("qwen2:1.5b", 1, 12, 2, 128, mixed(1), PAGE),
        ("qwen2:1.5b", 16, 12, 2, 128, mixed(16, empty=True), PAGE),
        ("qwen2:1.5b", 64, 12, 2, 128, mixed(64), PAGE),
        ("phi3:3.8b", 8, 32, 32, 96, mixed(8), PAGE),
        ("gemma:2b", 8, 8, 1, 256, mixed(8), PAGE),
    ]
    summary = {}
    for label, b, hq, hkv, d, lengths, page in shapes:
        for name in ("cuda_paged_decode_attention_parts", "cuda_paged_decode_attention_parts_int8"):
            errs, empties = {}, True
            for dtype, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
                q, k, v, table, lens = paged_inputs(torch, gen, b, hq, hkv, d, lengths, dtype, page=page)
                table = with_junk(torch, gen, table, lens.tolist(), k.shape[0], page=page)
                if name == "cuda_paged_decode_attention_parts":
                    args = (q, k, v, table, lens)
                    fn, ref_fn = cpa.cuda_paged_decode_attention_parts, plain.paged_decode_attention_parts_reference
                    kv_bytes_per_token = 2 * hkv * d * 2
                else:
                    kq, ks = quantize_kv_vector(k)
                    vq, vs = quantize_kv_vector(v)
                    args = (q, kq, ks, vq, vs, table, lens)
                    fn = cpa.cuda_paged_decode_attention_parts_int8
                    ref_fn = plain.paged_decode_attention_parts_int8_reference
                    kv_bytes_per_token = 2 * hkv * (d + 4)
                got = fn(*args)
                want = ref_fn(*args)
                again = fn(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(a, c) for a, c in zip(got, again)), (label, name, "two calls differ")
                errs[dtype], ok, empty_exact = parts_errors(torch, got, want, tol)
                empties = empties and empty_exact
                assert ok, (label, name, str(dtype), errs[dtype], empty_exact)
            profiled = {}
            if label == "qwen2:1.5b engine batch":
                profiled = one_kernel_per_call(torch, name, lambda: fn(*args), control)
            ms = timer.ms(lambda: fn(*args))
            plain_ms = timer.ms(lambda: ref_fn(*args), max_iters=20)
            if name == "cuda_paged_decode_attention_parts":
                kg, vg = plain._gather_pages(k, table), plain._gather_pages(v, table)
            else:  # dequantized, untimed
                kg = (plain._gather_pages(kq, table).float()
                      * plain._gather_pages(ks, table)[..., None]).to(torch.bfloat16)
                vg = (plain._gather_pages(vq, table).float()
                      * plain._gather_pages(vs, table)[..., None]).to(torch.bfloat16)
            mask = (torch.arange(kg.shape[2], device="cuda")[None, :] < lens[:, None])[:, None, None, :]
            library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True))
            del kg, vg
            cached = int(lens.sum().item())
            group = hq // hkv
            bytes_moved = (
                b * hq * d * 2  # q
                + cached * kv_bytes_per_token  # each cached K/V row once
                + table.numel() * 4 + b * 4  # table, lengths
                + b * hkv * group * (d + 2) * 4  # acc, m, l
            )
            b_ms, b_by = bound(bytes_moved, 4 * hq * d * cached)
            row = {
                "name": name, "shape": label, "B": b, "rows": len(lengths), "page": page,
                "jmax": table.shape[1], "grid": cpa.parts_grid(b, hkv, table.shape[1] * page),
                "cached_tokens": cached, "junk_table_entries": True,
                "has_empty_row": 0 in lengths, "has_one_position_row": 1 in lengths,
                "empty_row_exact": empties, **profiled,
                "max_abs_err": errs[torch.bfloat16]["out"],
                "max_abs_err_m_l_bf16": [errs[torch.bfloat16]["m"], errs[torch.bfloat16]["l"]],
                "max_abs_err_f32": errs[torch.float32],
                "ms": ms, "plain_ms": plain_ms,
                # SDPA with a length mask on the rows gathered (B5: dequantized) into a
                # contiguous bf16 cache, gather untimed: acc / l only
                "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit({"phase": "kernel", **row})
            summary.setdefault(name, row)
    return summary


def spec_prompt_lengths():
    """Token counts of the speculative sessions' 8 prompts (those of the
    int4 paged batch)."""
    study = len(STUDY_PROMPT.format(words=STUDY_WORDS[0])) + 1
    return [study] * 2 + list(INT4_BATCH_CONTEXTS)


def mq_bound(b, q_len, hq, hkv, d, lengths, offsets, kv_bytes_per_token, q_bytes, jmax):
    """Least time of one multi-query parts call: each row's cached K/V read
    once up to its last query's limit, q, table, lengths and offsets read,
    (acc, m, l) written; 4·D flops per (head, query, visible token)."""
    frontier = sum(max(0, min(n, off + q_len)) for n, off in zip(lengths, offsets))
    visible = sum(max(0, min(n, off + j + 1)) for n, off in zip(lengths, offsets) for j in range(q_len))
    bytes_moved = (
        b * q_len * hq * d * q_bytes + frontier * kv_bytes_per_token
        + b * jmax * 4 + 2 * b * 4 + b * q_len * hq * (d + 2) * 4
    )
    return bound(bytes_moved, 4 * hq * d * visible), frontier, visible


def page_constant(torch, pool):
    """A V pool ``[P,Hkv,page,D]`` like ``pool`` whose rows are constant
    over each (page, kv head), one of nine values in [-1, 1] (exact in
    bf16): acc/l is then a mix of the constants of the pages a query
    reads, so a tile read from a wrong page moves it by about its weight."""
    n_pool, hkv = pool.shape[:2]
    p = torch.arange(n_pool, device=pool.device)[:, None]
    h = torch.arange(hkv, device=pool.device)[None, :]
    c = ((3 * p + 5 * h) % 9 - 4).float() / 4
    return c[:, :, None, None].expand(pool.shape).to(pool.dtype).contiguous()


def mq_limits_mask(torch, lens, offsets, q_len, t):
    """[B, 1, Q, T] boolean: query j of row b sees positions below
    min(lengths[b], offsets[b] + j + 1)."""
    j = torch.arange(q_len, device="cuda")
    lim = torch.clamp(torch.minimum(lens[:, None], offsets[:, None] + j[None, :] + 1), min=0)
    return (torch.arange(t, device="cuda")[None, None, :] < lim[:, :, None])[:, None]


def paged_mq_kernel_phase(torch, cpa, plain, timer, quantize_kv_vector, kernels, control):
    """B7/B8 against their plain versions: at the speculative sessions' own
    batch (8 rows of 62–1,100 tokens, qwen2:1.5b widths, a session's table
    width) at Q 5 (k = 4) and Q 1, with offsets that cut inside the cached
    range on half the rows (the engine's offsets never cut: its candidates
    sit past the prompt); at the one-row session of
    ``generate_speculative``; at B 4 with an empty row and a row whose
    first query sees nothing; and at the phi3/gemma head dims. f32 to
    1e-4, bf16 to 5e-3 (acc/l, m, l), queries with no visible token
    exactly (0, -inf, 0); at Q 1 each equals B4/B5 on lengths cut to the
    causal limit, bit for bit. bf16 runs the tensor-core kernel, one
    launch a call up to Q 64 (Q 10, 13 and 17 included), two calls giving
    the same bits; f32 the CUDA-core kernel, chunks of 9. At Q 5 and Q 13
    a ``torch.profiler`` trace shows one device kernel a call (``control``
    shows two), as does one call at Q 1 (B4/B5's ``decode_tile_kernel``),
    and the kernel is held to its plain
    version once more over a V pool that is constant per (page, kv head),
    where a tile read from a wrong page moves acc/l by about its weight.
    The library yardstick is SDPA with each query's limit as a boolean mask
    over the rows gathered (B8: and dequantized) into a contiguous bf16
    cache, the gather untimed: it computes acc / l only. Returns the
    engine-batch Q 5 row of each kernel for the summary."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(3)
    lib = kernels.library("paged_attention")
    q_max = {dtype: lib.paged_mq_query_max(code) for dtype, code in
             ((torch.float32, 0), (torch.bfloat16, 1))}
    eng = spec_prompt_lengths()
    eng_cut = [n - 40 if i % 2 else n + 7 for i, n in enumerate(eng)]
    # (label, batch, hq, hkv, d, lengths, offsets, Q)
    shapes = [
        ("qwen2:1.5b engine batch", 8, 12, 2, 128, eng, eng_cut, SPEC_K + 1),
        ("qwen2:1.5b engine batch", 8, 12, 2, 128, eng, eng_cut, 1),
        ("qwen2:1.5b engine batch", 8, 12, 2, 128, eng, eng_cut, 10),
        ("qwen2:1.5b engine batch", 8, 12, 2, 128, eng, eng_cut, LONG_SPEC_K + 1),
        ("qwen2:1.5b engine batch", 8, 12, 2, 128, eng, eng_cut, 17),
        ("qwen2:1.5b one-row session", 1, 12, 2, 128, eng[:1], [eng[0] + 20], SPEC_K + 1),
        ("qwen2:1.5b", 4, 12, 2, 128, [0, 1, 300, 1100], [0, -1, 297, 1100], SPEC_K + 1),
        ("phi3:3.8b", 4, 32, 32, 96, [62, 300, 700, 1100], [62, 290, 700, 1000], SPEC_K + 1),
        ("gemma:2b", 4, 8, 1, 256, [62, 300, 700, 1100], [62, 290, 700, 1000], SPEC_K + 1),
    ]
    mq = {
        "cuda_paged_decode_attention_mq_parts": (
            cpa.cuda_paged_decode_attention_mq_parts, plain.paged_mq_attention_reference,
            cpa.cuda_paged_decode_attention_parts),
        "cuda_paged_decode_attention_mq_parts_int8": (
            cpa.cuda_paged_decode_attention_mq_parts_int8, plain.paged_mq_attention_int8_reference,
            cpa.cuda_paged_decode_attention_parts_int8),
    }
    summary = {}
    for label, b, hq, hkv, d, lengths, offs, q_len in shapes:
        for name, (fn, ref_fn, single) in mq.items():
            errs, empties, q1_equal, launches = {}, True, None, {}
            for dtype, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, MQ_MMA_ATOL)):
                _, k, v, table, lens = paged_inputs(torch, gen, b, hq, hkv, d, lengths, dtype,
                                                    session=True)
                q = torch.randn((b, q_len, hq, d), generator=gen, device="cuda").to(dtype)
                offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
                if name.endswith("int8"):
                    kq, ks = quantize_kv_vector(k)
                    vq, vs = quantize_kv_vector(v)
                    pool = (kq, ks, vq, vs)
                    kv_bytes_per_token = 2 * hkv * (d + 4)
                else:
                    pool = (k, v)
                    kv_bytes_per_token = 2 * hkv * d * q.element_size()
                args = (q, *pool, table, lens, offsets)
                fn.launches = 0
                got = fn(*args)
                launches[dtype] = fn.launches
                assert launches[dtype] == -(-q_len // q_max[dtype]), (label, name, q_len, launches)
                want = ref_fn(*args)
                again = fn(*args)
                torch.cuda.synchronize()
                assert all(torch.equal(a, c) for a, c in zip(got, again)), (label, name, "two calls differ")
                errs[dtype], ok, empty_exact = parts_errors(torch, got, want, tol)
                empties = empties and empty_exact
                assert ok, (label, name, q_len, str(dtype), errs[dtype], empty_exact)
                cut = torch.clamp(torch.minimum(lens, offsets + 1), min=0)
                q0 = q[:, 0].contiguous()
                if q_len == 1:
                    one = single(q0, *pool, table, cut)
                    q1_equal = all(torch.equal(a[:, 0], c) for a, c in zip(got, one))
                    assert q1_equal, (label, name, "Q 1 differs from the single-query kernel")
            extra = {}
            if label.endswith("engine batch") and q_len in (SPEC_K + 1, LONG_SPEC_K + 1):
                extra = one_kernel_per_call(torch, name, lambda: fn(*args), control)
                q1 = q[:, :1].contiguous()
                # the port's kernels of a Q 1 call (its wrapper cuts the lengths with torch ops)
                q1_names = [n for n, _ in device_kernels(torch, lambda: fn(q1, *args[1:]))
                            if "at::native" not in n]
                extra["q1_device_kernels"] = q1_names
                assert len(q1_names) == 1 and "decode_tile_kernel" in q1_names[0], q1_names
                vc = page_constant(torch, v)
                pool_c = (k, vc) if len(pool) == 2 else (kq, ks, *quantize_kv_vector(vc))
                args_c = (q, *pool_c, table, lens, offsets)
                c_errs, c_ok, _ = parts_errors(torch, fn(*args_c), ref_fn(*args_c), MQ_MMA_ATOL)
                assert c_ok, (label, name, "V constant per page", c_errs)
                extra["page_constant_v_max_abs_err"] = c_errs["out"]
            ms = timer.ms(lambda: fn(*args))
            plain_ms = timer.ms(lambda: ref_fn(*args), max_iters=20)
            kg = plain._gather_pages(pool[0], table)
            vg = plain._gather_pages(pool[-2] if len(pool) == 4 else pool[1], table)
            if len(pool) == 4:  # dequantized, untimed
                kg = (kg.float() * plain._gather_pages(ks, table)[..., None]).to(torch.bfloat16)
                vg = (vg.float() * plain._gather_pages(vs, table)[..., None]).to(torch.bfloat16)
            mask = mq_limits_mask(torch, lens, offsets, q_len, kg.shape[2])
            qt = q.transpose(1, 2)
            library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kg, vg, attn_mask=mask, enable_gqa=True))
            del kg, vg
            (b_ms, b_by), frontier, visible = mq_bound(
                b, q_len, hq, hkv, d, lengths + [lengths[0]] * (b - len(lengths)), offs,
                kv_bytes_per_token, q.element_size(), table.shape[1])
            row = {
                "name": name, "shape": label, "B": b, "Q": q_len, "lengths": lengths,
                "offsets": offs, "frontier_tokens": frontier, "visible_pairs": visible,
                "empty_queries_exact": empties, "q1_equals_single_query_kernel": q1_equal,
                "launches_per_call": launches[torch.bfloat16],
                "launches_per_call_f32": launches[torch.float32],
                "grid": cpa.mq_grid(b, hkv, cpa.mq_q_tiles(q_len, hq // hkv), table.shape[1] * PAGE),
                **extra,
                "max_abs_err": errs[torch.bfloat16]["out"],
                "max_abs_err_m_l_bf16": [errs[torch.bfloat16]["m"], errs[torch.bfloat16]["l"]],
                "max_abs_err_f32": errs[torch.float32],
                "ms": ms, "plain_ms": plain_ms,
                # SDPA, per-query limit mask, rows gathered (B8: dequantized) into a
                # contiguous bf16 cache, gather untimed: acc / l only
                "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit({"phase": "kernel", **row})
            summary.setdefault(name, row)
    return summary


def stacked_layer_kernel_phase(torch, cpa, timer, quantize_kv_vector):
    """The stacked ``layer=`` form of B4/B5/B7/B8: a [L,P,Hkv,page,D] pool of
    the speculative session's rows (qwen2:1.5b widths, L 4), read at layer
    2 (an int and a 0-d tensor) and held bit for bit against the call on
    that layer's own pool; both timed."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    n_layers, layer = 4, 2
    eng = spec_prompt_lengths()
    q, k, v, table, lens = paged_inputs(torch, gen, 8, 12, 2, 128, eng, torch.bfloat16, session=True)
    k = torch.stack([torch.randn(k.shape, generator=gen, device="cuda").to(k.dtype)
                     for _ in range(n_layers)])
    v = torch.stack([torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
                     for _ in range(n_layers)])
    kq, ks = quantize_kv_vector(k)
    vq, vs = quantize_kv_vector(v)
    qm = torch.randn((8, SPEC_K + 1, 12, 128), generator=gen, device="cuda").to(torch.bfloat16)
    offsets = torch.tensor(eng, dtype=torch.int32, device="cuda")
    cases = {
        "cuda_paged_decode_attention_parts": (
            cpa.cuda_paged_decode_attention_parts, (q,), (k, v), (table, lens)),
        "cuda_paged_decode_attention_parts_int8": (
            cpa.cuda_paged_decode_attention_parts_int8, (q,), (kq, ks, vq, vs), (table, lens)),
        "cuda_paged_decode_attention_mq_parts": (
            cpa.cuda_paged_decode_attention_mq_parts, (qm,), (k, v), (table, lens, offsets)),
        "cuda_paged_decode_attention_mq_parts_int8": (
            cpa.cuda_paged_decode_attention_mq_parts_int8, (qm,), (kq, ks, vq, vs),
            (table, lens, offsets)),
    }
    for name, (fn, head, pool, tail) in cases.items():
        per_layer = tuple(p[layer] for p in pool)
        want = fn(*head, *per_layer, *tail)
        equal = True
        for form in (layer, torch.tensor(layer, device="cuda")):
            got = fn(*head, *pool, *tail, layer=form)
            equal = equal and all(torch.equal(a, b) for a, b in zip(got, want))
        torch.cuda.synchronize()
        assert equal, (name, "layer= differs from the per-layer call")
        emit({
            "phase": "kernel", "name": name, "form": "layer=", "L": n_layers, "layer": layer,
            "B": 8, "Q": qm.shape[1] if "mq" in name else 1, "bit_equal_to_per_layer_call": equal,
            "ms": timer.ms(lambda: fn(*head, *pool, *tail, layer=layer)),
            "per_layer_ms": timer.ms(lambda: fn(*head, *per_layer, *tail)),
        })


def contiguous_session_shape():
    """(rows, lengths, capacity) of the contiguous n-gram session's verify
    midway: its 8 prompts and the joiner, 60 tokens generated each, in a
    bucket of 16 rows (pad rows copy row 0), over a cache of the widest
    prompt allocation + the 134-token budget's bucket + the rounds'
    margin (2,048 + 256 + 128)."""
    prompts = spec_prompt_lengths() + [CONTIG_SPEC_JOINER_TOKENS]
    offsets = [n + 60 for n in prompts]
    offsets += [offsets[0]] * (16 - len(offsets))
    return 16, offsets, 2048 + 256 + 128


def contiguous_mq_kernel_phase(torch, cpa, plain, timer, quantize_kv_vector):
    """The contiguous instantiations of B7/B8 against their plain version:
    at the contiguous n-gram session's shape (16 rows of 70–1,160 tokens
    over a 2,432-position cache) at Q 5 (k = 4), Q 2 (the adaptive
    policy's k = 1) and Q 13 (k = 12), at the one-row session of
    ``generate``, and at the phi3/gemma head dims. f32 to 1e-4 (the
    CUDA-core kernel, chunks of 9), bf16 to CONTIG_MQ_BF16_ATOL (the
    tensor-core kernel, one launch up to Q 64); two calls give the same
    bits. At Q 5 a ``torch.profiler`` trace shows one device kernel of the
    contiguous instantiation a call (the wrapper's ``acc / l`` is torch's).
    The library yardstick is SDPA with each query's limit as a boolean
    mask over the same cache (B8: dequantized to bf16, untimed)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, offs_sess, t_sess = contiguous_session_shape()
    one = spec_prompt_lengths()[0] + 20
    # (label, batch, hq, hkv, d, offsets, capacity, Q)
    shapes = [
        ("qwen2:1.5b contiguous session", b, 12, 2, 128, offs_sess, t_sess, SPEC_K + 1),
        ("qwen2:1.5b contiguous session", b, 12, 2, 128, offs_sess, t_sess, 2),
        ("qwen2:1.5b contiguous session", b, 12, 2, 128, offs_sess, t_sess, LONG_SPEC_K + 1),
        ("qwen2:1.5b one-row session", 1, 12, 2, 128, [one], 128 + 256 + 128, SPEC_K + 1),
        ("phi3:3.8b", 4, 32, 32, 96, [62, 300, 700, 1000], 1152, SPEC_K + 1),
        ("gemma:2b", 4, 8, 1, 256, [62, 300, 700, 1000], 1152, SPEC_K + 1),
    ]
    mq = {
        "cuda_contiguous_mq_attention": (cpa.cuda_contiguous_mq_attention,
                                         plain.contiguous_mq_attention_reference),
        "cuda_contiguous_mq_attention_int8": (cpa.cuda_contiguous_mq_attention_int8,
                                              plain.contiguous_mq_attention_int8_reference),
    }
    summary = {}
    for label, b, hq, hkv, d, offs, t, q_len in shapes:
        for name, (fn, ref_fn) in mq.items():
            errs, launches = {}, {}
            for dtype, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, CONTIG_MQ_BF16_ATOL)):
                k = torch.randn((b, hkv, t, d), generator=gen, device="cuda").to(dtype)
                v = torch.randn((b, hkv, t, d), generator=gen, device="cuda").to(dtype)
                q = torch.randn((b, q_len, hq, d), generator=gen, device="cuda").to(dtype)
                offsets = torch.tensor(offs, dtype=torch.int32, device="cuda")
                lens = offsets + q_len  # every candidate is in the cache
                if name.endswith("int8"):
                    kq, ks = quantize_kv_vector(k)
                    vq, vs = quantize_kv_vector(v)
                    cache = (kq, ks, vq, vs)
                    kv_bytes_per_token = 2 * hkv * (d + 4)
                else:
                    cache = (k, v)
                    kv_bytes_per_token = 2 * hkv * d * q.element_size()
                args = (q, *cache, lens, offsets)
                fn.launches = 0
                got = fn(*args)
                launches[dtype] = fn.launches
                want = ref_fn(*args)
                again = fn(*args)
                torch.cuda.synchronize()
                assert torch.equal(got, again), (label, name, "two calls differ")
                diff = (got.float() - want.float()).abs()
                errs[dtype] = diff.max().item()
                assert bool(torch.all(diff <= tol + tol * want.float().abs())), (
                    label, name, q_len, str(dtype), errs[dtype])
            extra = {}
            if label.endswith("session") and q_len == SPEC_K + 1:
                names = [n for n, _ in device_kernels(torch, lambda: fn(*args))]
                ours = [n for n in names if "mq_mma_kernel" in n and "ContiguousRows" in n]
                assert len(ours) == 1, names
                extra = {"device_kernels_of_the_instantiation_per_call": len(ours),
                         "device_kernel": ours[0], "device_kernels_per_call": len(names)}
            ms = timer.ms(lambda: fn(*args))
            plain_ms = timer.ms(lambda: ref_fn(*args), max_iters=20)
            kd, vd = cache[0], cache[-2] if len(cache) == 4 else cache[1]
            if len(cache) == 4:  # dequantized, untimed
                kd = (kd.float() * cache[1][..., None]).to(torch.bfloat16)
                vd = (vd.float() * cache[3][..., None]).to(torch.bfloat16)
            mask = mq_limits_mask(torch, lens, offsets, q_len, t)
            qt = q.transpose(1, 2)
            library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kd, vd, attn_mask=mask, enable_gqa=True))
            del kd, vd
            frontier = sum(min(n + q_len, t) for n in offs)
            visible = sum(min(n + j + 1, t) for n in offs for j in range(q_len))
            bytes_moved = (b * q_len * hq * d * 2 * q.element_size() + frontier * kv_bytes_per_token
                           + 2 * b * 4)
            b_ms, b_by = bound(bytes_moved, 4 * hq * d * visible)
            row = {
                "name": name, "shape": label, "B": b, "Q": q_len, "offsets": offs, "capacity": t,
                "frontier_tokens": frontier, "visible_pairs": visible,
                "launches_per_call": launches[torch.bfloat16],
                "launches_per_call_f32": launches[torch.float32],
                **extra,
                "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
                "ms": ms, "plain_ms": plain_ms,
                # SDPA, per-query limit mask over the same cache (B8: dequantized to bf16, untimed)
                "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit({"phase": "kernel", **row})
            summary.setdefault(name, row)
    return summary


def with_junk(torch, gen, table, lengths, n_pool, page=PAGE):
    """The table with every entry past each row's pages replaced by junk,
    inside and outside [0, P): a write-through table's entries past the
    frontier are never read, and the kernel clips what it would read."""
    need = torch.tensor([-(-n // page) for n in lengths] + [0] * (table.shape[0] - len(lengths)),
                        device="cuda")
    junk = torch.randint(-n_pool - 5, 2 * n_pool + 5, table.shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    cols = torch.arange(table.shape[1], device="cuda")
    return torch.where(cols[None, :] < need[:, None], table, junk)


def write_through_lengths():
    """Token counts of the write-through phase's 8 rows midway through its
    decode: the int4 batch's prompts plus half the steps."""
    return [n + WRITE_THROUGH_STEPS // 2 for n in spec_prompt_lengths()]


MARKER_KERNEL = "spin_kernel"  # what torch.cuda._sleep launches
TRACE_TRIES = 5
TRACE_RETRY_S = 1.0


def device_kernels(torch, fn):
    """(name, device µs) of each device kernel one call of ``fn`` runs, from
    a ``torch.profiler`` trace of that call (after one warm call): a
    wrapper's launch count counts its calls, this what reached the card.

    The call is bracketed by ``torch.cuda._sleep`` marker kernels, two
    before it and one after, each followed by a synchronize. A trace can
    come back without some or all of its device records, and lossy traces
    come in runs (``scripts/torch_profiler_loss.py``: on an H100 with
    torch 2.11, 13 of 3,000 one-call traces of B9 showed no kernel). A
    trace that lacks a marker on either side of the call's kernels (or,
    when it shows none, any of the three) is not read as a count: it is
    reported and taken again after ``TRACE_RETRY_S``, at most
    ``TRACE_TRIES`` times."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mark()
            mark()
            fn()
            torch.cuda.synchronize()
            mark()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        launched = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
        markers = [i for i, e in enumerate(launched) if MARKER_KERNEL in e["name"]]
        ours = [(i, e) for i, e in enumerate(launched) if MARKER_KERNEL not in e["name"]]
        if ours:
            whole = bool(markers) and markers[0] < ours[0][0] and markers[-1] > ours[-1][0]
        else:
            whole = len(markers) == 3
        if whole:
            return [(e["name"], e["dur"]) for _, e in ours]
        emit({"phase": "trace_retry", "kernels": [e["name"] for e in launched]})
        time.sleep(TRACE_RETRY_S)
    raise AssertionError(f"{TRACE_TRIES} traces each lost a marker kernel")


def b7_f32_control(torch, cpa):
    """One call of B7 with an f32 q at Q 5 on the speculative sessions'
    rows (``mq_partial_kernel`` and ``parts_merge_kernel``: two device
    kernels), the profiler's control."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    _, k, v, table, lens = paged_inputs(torch, gen, 8, 12, 2, 128, spec_prompt_lengths(), torch.float32,
                                        session=True)
    q = torch.randn((8, SPEC_K + 1, 12, 128), generator=gen, device="cuda")
    return lambda: cpa.cuda_paged_decode_attention_mq_parts(q, k, v, table, lens, lens)


def one_kernel_per_call(torch, name, fn, control):
    """Assert that one call of ``fn`` runs exactly one device kernel, and
    that the trace sees kernels at all: ``control``, a call of a
    two-launch kernel, shows two."""
    ours, theirs = device_kernels(torch, fn), device_kernels(torch, control)
    assert len(theirs) == 2, (name, "control", theirs)
    assert len(ours) == 1, (name, ours)
    return {"device_kernels_per_call": len(ours), "device_kernel": ours[0][0],
            "device_us": ours[0][1], "control_device_kernels_per_call": len(theirs)}


def paged_decode_kernel_phase(torch, cpa, ca, plain, timer, control):
    """B6 against its plain version: at the write-through phase's 8 rows,
    at qwen2:1.5b widths for B 1, 16 and 64 (62–1,100 tokens), at the
    phi3/gemma head dims, and at the write-through rows in pages of 48
    positions (not a multiple of the kernel's 32-position tile); every
    table with junk entries past the rows' pages. f32 to 1e-4 and bf16 to
    2e-2 (max abs error of the normalised output), timed in bf16 beside
    B4 on the same rows and SDPA on the rows gathered into a contiguous
    cache (the gather untimed). One call runs one device kernel
    (``control`` shows two). Returns the first row."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(5)

    def mixed(n):
        return torch.randint(62, 1101, (n,), generator=gen, device="cuda").tolist()

    # (label, batch, hq, hkv, d, lengths, page)
    shapes = [
        ("qwen2:1.5b write-through rows", 8, 12, 2, 128, write_through_lengths(), PAGE),
        ("qwen2:1.5b", 1, 12, 2, 128, mixed(1), PAGE),
        ("qwen2:1.5b", 16, 12, 2, 128, mixed(16), PAGE),
        ("qwen2:1.5b", 64, 12, 2, 128, mixed(64), PAGE),
        ("phi3:3.8b", 8, 32, 32, 96, mixed(8), PAGE),
        ("gemma:2b", 8, 8, 1, 256, mixed(8), PAGE),
        ("qwen2:1.5b write-through rows, page 48", 8, 12, 2, 128, write_through_lengths(), 48),
    ]
    name = "cuda_paged_decode_attention"
    fn, ref_fn = cpa.cuda_paged_decode_attention, plain.paged_decode_attention_reference
    summary = {}
    for label, b, hq, hkv, d, lengths, page in shapes:
        errs = {}
        for dtype, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
            q, k, v, table, lens = paged_inputs(torch, gen, b, hq, hkv, d, lengths, dtype, page=page)
            table = with_junk(torch, gen, table, lengths, k.shape[0], page=page)
            args = (q, k, v, table, lens)
            out = fn(*args)
            ref = ref_fn(*args)
            again = fn(*args)
            torch.cuda.synchronize()
            errs[dtype] = (out.float() - ref.float()).abs().max().item()
            assert errs[dtype] <= tol, (label, name, str(dtype), errs)
            assert torch.equal(out, again), (label, name, "two calls differ")
        profiled = {}
        if not summary:
            profiled = one_kernel_per_call(torch, name, lambda: fn(*args), control)
        ms = timer.ms(lambda: fn(*args))
        plain_ms = timer.ms(lambda: ref_fn(*args), max_iters=20)
        b4_ms = timer.ms(lambda: cpa.cuda_paged_decode_attention_parts(*args))
        kg = plain._gather_pages(k, table)
        vg = plain._gather_pages(v, table)
        mask = (torch.arange(kg.shape[2], device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True))
        del kg, vg
        cached = int(lens.sum().item())
        bytes_moved = (
            2 * b * hq * d * 2  # q in, out
            + cached * 2 * hkv * d * 2  # each attended K/V row once
            + table.numel() * 4 + b * 4  # table, lengths
        )
        b_ms, b_by = bound(bytes_moved, 4 * hq * d * cached)
        row = {
            "name": name, "shape": label, "B": b, "lengths": lengths if b <= 8 else None,
            "page": page, "jmax": table.shape[1], "grid": ca.decode_grid(b, hkv, table.shape[1] * page),
            "tickets": b * hkv, "attended_tokens": cached, "junk_table_entries": True, **profiled,
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "plain_ms": plain_ms, "b4_ms_same_rows": b4_ms,
            # SDPA with a length mask on the rows gathered into [B,Hkv,Jmax·page,D]
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        }
        emit({"phase": "kernel", **row})
        summary.setdefault(name, row)
    return summary


# torch._int_mm refuses fewer than this many rows of its first operand on CUDA.
INT_MM_MIN_ROWS = 17


def int_mm_ms(torch, timer, xq, w8):
    """Time of ``torch._int_mm`` (int8 × int8 → int32) on the activation
    codes, padded with zero rows to INT_MM_MIN_ROWS, and the unpacked int8
    weight codes: B11's sum without its scales."""
    a = torch.zeros((INT_MM_MIN_ROWS, xq.shape[1]), dtype=torch.int8, device="cuda")
    a[: xq.shape[0]] = xq
    return timer.ms(lambda: torch._int_mm(a, w8))


def w4a8_kernel_phase(torch, cq, qplain, qmod, timer, control):
    """B11 against its plain version, bit for bit, at the probe's shape and
    at llama3.1:8b's w_gate (M 8, weights at the model's 1/sqrt(IN)
    scale), with bf16 and f32 activations, each also with a zero row (its
    output row exact zeros); at M 1 to 8 with OUT 7 and 130 (the byte-wise
    loads), a zero row from M 2. One call runs one device kernel
    (``control`` shows two). Timed with bf16 activations beside B9 on the
    same weights and torch._int_mm on the unpacked codes; the plain
    quantization's torch ops (what the wrapper ran ahead of the kernel
    until the kernel quantized x itself) are timed alone as a yardstick.
    Returns the first row."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    name = "cuda_w4a8_matmul"
    fn, ref_fn = cq.cuda_w4a8_matmul, qplain.w4a8_matmul_reference

    def bit_equal(x, codes, scale, zero_row=None):
        if zero_row is not None:
            x = x.clone()
            x[zero_row] = 0
        out, ref = fn(x, codes, scale), ref_fn(x, codes, scale)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == ref.shape, (name, out.shape)
        assert torch.equal(out, ref), (name, tuple(x.shape), str(x.dtype), (out - ref).abs().max().item())
        assert zero_row is None or not out[zero_row].any(), (name, "zero row")
        return (out - ref).abs().max().item()

    for m in range(1, qplain.MAX_KERNEL_ROWS + 1):
        for in_dim, out_dim in ((256, 7), (512, 130)):
            leaf = qmod.quantize_tensor_int4(torch.randn((in_dim, out_dim), generator=gen, device="cuda"))
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, in_dim), generator=gen, device="cuda").to(dtype)
                bit_equal(x, leaf["q4"], leaf["s"], m // 2 if m > 1 else None)
    emit({"phase": "kernel", "name": name, "bit_equal_m_1_to_8": [[256, 7], [512, 130]],
          "zero_row_from_m": 2})
    m = qplain.MAX_KERNEL_ROWS
    summary = {}
    for label, in_dim, out_dim in W4A8_SHAPES:
        w = torch.randn((in_dim, out_dim), generator=gen, device="cuda") / math.sqrt(in_dim)
        leaf = qmod.quantize_tensor_int4(w)
        codes, scale = leaf["q4"], leaf["s"]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, in_dim), generator=gen, device="cuda").to(dtype)
            errs[dtype] = bit_equal(x, codes, scale)
            bit_equal(x, codes, scale, zero_row=3)
        profiled = {}
        if not summary:
            profiled = one_kernel_per_call(torch, name, lambda: fn(x, codes, scale), control)
        ms = timer.ms(lambda: fn(x, codes, scale))
        plain_ms = timer.ms(lambda: ref_fn(x, codes, scale), max_iters=20)
        b9_ms = timer.ms(lambda: cq.cuda_int4_matmul(x, codes, scale))
        # the plain quantization's torch ops alone: a yardstick, not part of the call
        quantize_ms = timer.ms(lambda: qplain.quantize_activations_rowwise(x))
        xq, _ = qplain.quantize_activations_rowwise(x)
        library_ms = int_mm_ms(torch, timer, xq, qplain.unpack_int4(codes))
        bytes_moved = codes.numel() + out_dim * 4 + m * in_dim * 2 + m * out_dim * 4
        b_ms, b_by = bound(bytes_moved, 2 * m * in_dim * out_dim, INT8_OPS)
        n_split = cq._w4a8_split(codes.shape[0], out_dim)[0]
        row = {
            "name": name, "shape": label, "M": m, "IN": in_dim, "OUT": out_dim,
            "splits": n_split, "tickets": cq._tickets_needed(out_dim, n_split), **profiled,
            "bit_equal": True, "zero_row_bit_equal": True,
            "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "activation_quantize_ms": quantize_ms, "plain_ms": plain_ms,
            "b9_ms_same_weights": b9_ms,
            # torch._int_mm on the unpacked int8 codes, x's codes padded to 17 rows
            "library_ms": library_ms, "library_rows": INT_MM_MIN_ROWS,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit({"phase": "kernel", **row})
        summary.setdefault(name, row)
        del w, leaf
    return summary


def w4a8_probe_phase(torch, root, kernels):
    """B11's path: the port's w4a8 probe (``scripts/torch_w4a8_probe.py``),
    its lines re-emitted; B11 and B9 each ran and no other kernel did."""
    from importlib.util import module_from_spec, spec_from_file_location

    spec = spec_from_file_location("torch_w4a8_probe", root / "scripts" / "torch_w4a8_probe.py")
    probe = module_from_spec(spec)
    spec.loader.exec_module(probe)
    lines, counts = count_launches(kernels, lambda: probe.probe(torch))
    for line in lines:
        emit({"phase": "w4a8_probe", **line})
    emit({"phase": "w4a8_probe_launches", "counts": counts})
    assert counts["cuda_w4a8_matmul"] > 0 and counts["cuda_int4_matmul"] > 0, counts
    others = {k: n for k, n in counts.items() if k not in ("cuda_w4a8_matmul", "cuda_int4_matmul")}
    assert not any(others.values()), counts
    assert 0 < lines[0]["w4a8_rel_err"] < 0.05, lines[0]
    return counts


def study_requests(GenerationRequest):
    """The study's prompt at its 100- and 500-word lengths, plus one long
    prompt whose prefill runs in two chunks (offset 2048 for the second)."""
    reqs = [
        GenerationRequest(
            MODEL,
            STUDY_PROMPT.format(words=words),
            math.ceil(words * TOKENS_PER_WORD),
            stop_at_eos=False,
        )
        for words in STUDY_WORDS
    ]
    long_prompt = ("Context: " + "the light reactions split water and store energy. " * 42)[:2100]
    reqs.append(GenerationRequest(MODEL, long_prompt + " Summarise.", 32, stop_at_eos=False))
    return reqs


def context_prompt(n_tokens: int) -> str:
    """A prompt of ``n_tokens`` byte-tokenizer tokens (BOS included)."""
    text = "Context: " + "the light reactions split water and store energy. " * 60
    return (text[: n_tokens - 12] + " Summarise.")[: n_tokens - 1]


def int4_batch_requests(GenerationRequest):
    """The int4 paged batch: two study prompts and two contexts each of 300,
    700 and 1,100 tokens; every other row asks for 134 new tokens, the rest
    for 32, all greedy."""
    prompts = [STUDY_PROMPT.format(words=STUDY_WORDS[0])] * 2
    prompts += [context_prompt(n) for n in INT4_BATCH_CONTEXTS]
    return [
        GenerationRequest(MODEL, p, 134 if i % 2 == 0 else 32, stop_at_eos=False)
        for i, p in enumerate(prompts)
    ]


def spec_requests(GenerationRequest):
    """The n-gram session's rows: the int4 batch's 8 prompts, each at
    SPEC_NEW_TOKENS new tokens; row 1 samples (temperature 0.7, seed 1)."""
    return [
        dataclasses.replace(r, max_new_tokens=SPEC_NEW_TOKENS,
                            **(dict(temperature=0.7, seed=1) if i == 1 else {}))
        for i, r in enumerate(int4_batch_requests(GenerationRequest))
    ]


def selfdraft_requests(GenerationRequest):
    """The self-draft session's greedy rows: the study prompt and the 300-,
    700- and 1,100-token contexts, at SELFDRAFT_NEW_TOKENS new tokens."""
    prompts = [STUDY_PROMPT.format(words=STUDY_WORDS[0])] + [context_prompt(n) for n in (300, 700, 1100)]
    return [GenerationRequest(MODEL, p, SELFDRAFT_NEW_TOKENS, stop_at_eos=False)
            for p in prompts[:SELFDRAFT_ROWS]]


def long_spec_requests(GenerationRequest):
    """The long-k session's greedy rows: the self-draft's prompts at
    LONG_SPEC_NEW_TOKENS new tokens."""
    return [dataclasses.replace(r, max_new_tokens=LONG_SPEC_NEW_TOKENS)
            for r in selfdraft_requests(GenerationRequest)[:LONG_SPEC_ROWS]]


def batch_requests(GenerationRequest):
    """The paged batch: four study prompts, four contexts each of about
    300, 700 and 1,100 tokens, and one 2,112-token prompt (two prefill
    chunks). Every other row asks for 134 new tokens (the study's 100
    words) and the rest for 32; row 1 samples (temperature 0.7, seed 1)."""
    prompts = [STUDY_PROMPT.format(words=STUDY_WORDS[0])] * 4
    prompts += [context_prompt(n) for n in BATCH_CONTEXTS + (LONG_PROMPT_TOKENS,)]
    reqs = []
    for i, prompt in enumerate(prompts):
        kw = dict(temperature=0.7, seed=1) if i == 1 else {}
        reqs.append(GenerationRequest(MODEL, prompt, 134 if i % 2 == 0 else 32, stop_at_eos=False, **kw))
    return reqs


def check_results(engine, requests, results):
    """Finite, in-vocabulary tokens of the asked length (or ending at EOS)."""
    for r, res in zip(requests, results):
        vocab = engine._models[r.model].cfg.vocab_size
        eos = engine._tokenizer_for(r.model).eos_id
        assert res.generated_tokens == len(res.tokens) >= 1
        assert all(0 <= t < vocab for t in res.tokens)
        # stop_at_eos=False: tokens end at max_new_tokens or at an EOS
        assert len(res.tokens) == r.max_new_tokens or res.tokens[-1] == eos
        assert res.prefill_s > 0 and res.decode_s > 0


def count_launches(kernels, run):
    """Set every count to 0, run the path, read the counts just after."""
    for fn in kernels:
        fn.launches = 0
    out = run()
    return out, {fn.__name__: fn.launches for fn in kernels}


def engine_phase(phase, engine, requests, kernels, n_layers, chunks_of, matmul=None):
    """Drive ``generate`` (warm first) and check its launch counts; with
    ``matmul`` (an int4 kernel's name), that kernel ran once per dense
    matmul of every decode forward and nowhere else."""
    engine.warmup(requests[0])
    results, counts = count_launches(kernels, lambda: [engine.generate(r) for r in requests])
    check_results(engine, requests, results)
    steps = 0
    chunks = 0
    for res in results:
        steps += len(res.tokens) - 1
        chunks += chunks_of(res.prompt_tokens)
        emit({
            "phase": phase, "prompt_tokens": res.prompt_tokens,
            "generated_tokens": res.generated_tokens, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "tokens_per_s": res.tokens_per_s,
        })
    decode_name = "cuda_decode_attention_int8" if engine.kv_quantize else "cuda_decode_attention"
    expected = {fn.__name__: 0 for fn in kernels}
    expected["cuda_prefill_attention"] = n_layers * chunks
    expected[decode_name] = n_layers * steps
    if matmul:
        expected[matmul] = MATMULS_PER_LAYER * n_layers * steps
    emit({"phase": phase + "_launches", "counts": counts, "expected": expected})
    assert counts == expected, (counts, expected)
    return counts


def prefill_forwards(eng_mod, prompt_lengths):
    """Prefill forwards of one paged batch: each single-chunk prompt bucket
    is one (grouped or solo) forward, and each multi-chunk prompt one per
    chunk."""
    buckets, chunked = set(), 0
    for n in prompt_lengths:
        chunks = eng_mod._prompt_chunks(n)
        if len(chunks) == 1:
            buckets.add(chunks[0][1])
        else:
            chunked += len(chunks)
    return len(buckets) + chunked


def paged_engine_phase(phase, engine, requests, kernels, n_layers, eng_mod, matmul=None):
    """Drive one ``generate_batch`` of the requests over the paged pool
    (warm first, on four of them with 4 new tokens each) and check its launch counts: the parts
    kernel of the pool's kind ran a whole number of steps of n_layers
    launches, at least the longest row's decode steps and at most 133;
    the other parts kernel and the contiguous decode kernels never ran;
    the prefill kernel ran n_layers times per prefill forward; with
    ``matmul`` (an int4 kernel's name), that kernel ran once per dense
    matmul of every decode forward (MATMULS_PER_LAYER per parts launch)."""
    engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in requests[:2] + requests[-2:]])
    results, counts = count_launches(kernels, lambda: engine.generate_batch(requests))
    check_results(engine, requests, results)
    windows = {}
    for res in results:
        windows[res.extras["decode_window"]] = res.decode_s
        emit({
            "phase": phase, "prompt_tokens": res.prompt_tokens,
            "generated_tokens": res.generated_tokens, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "sampled": res.request.temperature > 0,
        })
    tokens = sum(r.generated_tokens for r in results)
    window_s = sum(windows.values())
    parts = (
        "cuda_paged_decode_attention_parts_int8" if engine.kv_quantize
        else "cuda_paged_decode_attention_parts"
    )
    longest = max(r.generated_tokens for r in results)
    n_parts = counts[parts]
    expected_zero = {fn.__name__: 0 for fn in kernels}
    for name in (parts, "cuda_prefill_attention", matmul):
        expected_zero.pop(name, None)
    forwards = prefill_forwards(eng_mod, [r.prompt_tokens for r in results])
    emit({
        "phase": phase + "_summary", "rows": len(results), "decode_windows": len(windows),
        "generated_tokens": tokens, "decode_window_s": window_s,
        "decode_tokens_per_s": tokens / window_s, "prefill_forwards": forwards,
        "counts": counts,
    })
    assert n_parts % n_layers == 0, counts
    assert n_layers * (longest - 1) <= n_parts <= n_layers * (max(r.max_new_tokens for r in requests) - 1), counts
    assert {k: counts[k] for k in expected_zero} == expected_zero, counts
    assert counts["cuda_prefill_attention"] == n_layers * forwards, (counts, forwards)
    if matmul:
        assert counts[matmul] == MATMULS_PER_LAYER * n_parts, counts
    return counts


def contiguous_batch_phase(torch, eng_mod, tfm, ca, kernels, GenerationRequest, smi):
    """``generate_batch`` without ``paged_kv`` (one contiguous batch cache)
    at int8 weights and SOLO_CUT_LAYERS layers: the 17 ``batch_requests``
    rows over a bf16 cache, then the first CONTIG_INT8_ROWS over an int8
    cache. Each runs in one
    decode window whose every step is one B2 (B3) launch a layer; B1 runs
    once a layer per prefill forward; nothing else launches. Every greedy
    row is replayed teacher-forced (its tokens' logits within LOGIT_ATOL
    of each position's maximum, gated); the share of each row's first
    CONTIG_SOLO_TOKENS tokens equal to its solo ``generate``'s is printed.
    Returns the launches."""
    import gc

    totals = {fn.__name__: 0 for fn in kernels}
    for kv, reqs in ((None, batch_requests(GenerationRequest)),
                     ("int8", batch_requests(GenerationRequest)[:CONTIG_INT8_ROWS])):
        phase = "engine_batch_contiguous" + ("_int8_kv" if kv else "")
        engine = eng_mod.TorchEngine(quantize="int8", kv_quantize=kv, registry=cut_registry())
        engine.load_model(MODEL)
        n_layers = engine._models[MODEL].cfg.n_layers
        engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in reqs[:2] + reqs[-2:]])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results, counts = count_launches(kernels, lambda: engine.generate_batch(reqs))
        peak = torch.cuda.max_memory_allocated()
        check_results(engine, reqs, results)
        windows = {r.extras["decode_window"]: r.decode_s for r in results}
        steps = max(len(r.tokens) for r in results) - 1
        tokens = sum(r.generated_tokens for r in results)
        decode = "cuda_decode_attention_int8" if kv else "cuda_decode_attention"
        forwards = prefill_forwards(eng_mod, [r.prompt_tokens for r in results])
        expected = {fn.__name__: 0 for fn in kernels}
        expected.update({"cuda_prefill_attention": n_layers * forwards, decode: n_layers * steps})
        shares = []
        for req, res in zip(reqs, results):
            solo = engine.generate(dataclasses.replace(req, max_new_tokens=CONTIG_SOLO_TOKENS)).tokens
            shares.append(sum(a == b for a, b in zip(solo, res.tokens)) / len(solo))
        gaps = [replay_gap(torch, engine, tfm, ca, eng_mod, req, res.tokens)
                for req, res in zip(reqs, results) if req.temperature == 0]
        window_s = sum(windows.values())
        emit({
            "phase": phase, "rows": len(results), "decode_windows": len(windows),
            "decode_steps": steps, "generated_tokens": tokens, "decode_window_s": window_s,
            "decode_tokens_per_s": tokens / window_s, "ms_per_step": 1e3 * window_s / steps,
            "prefill_forwards": forwards, "solo_token_share": shares,
            "solo_token_share_mean": sum(shares) / len(shares), "solo_tokens_compared": CONTIG_SOLO_TOKENS,
            "greedy_rows": len(gaps), "max_logit_gap": max(gaps), "logit_atol": LOGIT_ATOL,
            "max_memory_allocated_bytes": peak, "counts": counts, "expected": expected,
            "nvidia_smi": smi,
        })
        assert len(windows) == 1, windows
        assert counts == expected, (counts, expected)
        assert max(gaps) <= LOGIT_ATOL, gaps
        for k, v in counts.items():
            totals[k] += v
        del engine, results
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def lru_phase(torch, eng_mod, kernels, GenerationRequest, smi):
    """The LRU model guard on the card: three study models at int8 under
    ``TPU_ALLOC_BUDGET_BYTES`` = the two larger ones' weights + the load
    headroom (``utils/memory.py``). qwen2:1.5b, then gemma:2b load; a
    request to qwen2 makes gemma the least recently used; loading phi3
    evicts gemma, and ``memory_allocated`` falls by at least
    LRU_FREED_SHARE of gemma's bytes. With a contiguous session live on
    qwen2 (now the least recently used), a request to gemma evicts phi3
    instead (qwen2's eviction defers), reloads gemma and gives the same
    greedy tokens as before its eviction. Returns the launches."""
    import gc
    import os
    from importlib import import_module

    memory = import_module(f"{PKG}.utils.memory")
    qmod = import_module(f"{PKG}.models.quantize")
    engine = eng_mod.TorchEngine(quantize="int8")
    q, g, p = LRU_MODELS
    est = {m: engine.model_weight_bytes(m) for m in LRU_MODELS}
    budget = est[g] + est[p] + memory.LOAD_TRANSIENT_HEADROOM_BYTES
    req = {m: GenerationRequest(m, STUDY_PROMPT.format(words=STUDY_WORDS[0]), LRU_NEW_TOKENS,
                                stop_at_eos=False) for m in LRU_MODELS}
    previous = os.environ.get(memory.ALLOC_ENV_OVERRIDE)
    os.environ[memory.ALLOC_ENV_OVERRIDE] = str(budget)
    try:
        for fn in kernels:
            fn.launches = 0
        tokens = {q: engine.generate(req[q]).tokens}
        tokens[g] = engine.generate(req[g]).tokens
        engine.generate(req[q])  # gemma is now the least recently used
        nbytes = {m: qmod.params_nbytes(engine._models[m].params) for m in (q, g)}
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        engine.load_model(p)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        loaded_after_p = engine.loaded_models()
        nbytes[p] = qmod.params_nbytes(engine._models[p].params)
        freed = before + nbytes[p] - after
        sess = engine.decode_open([req[q]])
        engine.generate(req[p])  # qwen2, with its live session, is now the least recently used
        reloaded = engine.generate(req[g]).tokens
        loaded_after_g = engine.loaded_models()
        session_results = []
        while sess.active:
            session_results.extend(sess.step())
        sess.close()
        counts = {fn.__name__: fn.launches for fn in kernels}
    finally:
        if previous is None:
            os.environ.pop(memory.ALLOC_ENV_OVERRIDE, None)
        else:
            os.environ[memory.ALLOC_ENV_OVERRIDE] = previous
    emit({
        "phase": "engine_lru", "models": list(LRU_MODELS), "budget_bytes": budget,
        "load_headroom_bytes": memory.LOAD_TRANSIENT_HEADROOM_BYTES, "estimate_bytes": est,
        "params_bytes": nbytes, "loaded_after_phi3": loaded_after_p,
        "memory_allocated_before_phi3": before, "memory_allocated_after_phi3": after,
        "freed_bytes": freed, "freed_share_of_gemma": freed / nbytes[g],
        "loaded_after_gemma_reload": loaded_after_g, "gemma_tokens_equal_after_reload": reloaded == tokens[g],
        "session_tokens_equal_solo": session_results[0].tokens == tokens[q],
        "counts": counts, "nvidia_smi": smi,
    })
    assert {k for k, v in counts.items() if v} == {"cuda_prefill_attention", "cuda_decode_attention"}, counts
    assert loaded_after_p == sorted([q, p]), loaded_after_p
    assert freed >= LRU_FREED_SHARE * nbytes[g], (freed, nbytes[g])
    assert loaded_after_g == sorted([q, g]), loaded_after_g  # phi3 went, not qwen2
    assert reloaded == tokens[g]
    assert session_results[0].tokens == tokens[q]
    del engine, sess
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def integration_phase(torch, engine, phase, paths, forward, logits_for, qmod, model=MODEL):
    """Prefill + 8 decode steps of the full-width model with the kernels
    injected, and again with the plain versions: logits per step agree to
    LOGIT_ATOL, and greedy tokens agree except at near-ties narrower than
    the observed difference. ``paths`` maps "kernels" and "plain" to
    (prefill attention, decode attention, int4 matmul of ``dense_dot``)."""
    tf = engine._models[model]
    tok = engine._tokenizer_for(model)
    ids = tok.encode("In 100 words, please give me information about the water cycle")
    s_bucket = 64
    logits = {name: [] for name in paths}
    caches = {name: tf.init_cache(1, s_bucket + 16, dtype=engine.dtype) for name in paths}
    tokens = torch.tensor([ids + [tok.pad_id] * (s_bucket - len(ids))], device="cuda")
    installed = qmod.cuda_int4_matmul

    def run(name, toks, offset, prefill):
        pf, dec, matmul = paths[name]
        qmod.cuda_int4_matmul = matmul
        try:
            if prefill:
                return forward(tf.params, tf.cfg, toks, offset, *caches[name], None, pf, layers=tf.layers)[0]
            return forward(tf.params, tf.cfg, toks, offset, *caches[name], dec, layers=tf.layers)[0]
        finally:
            qmod.cuda_int4_matmul = installed

    for name in paths:
        h = run(name, tokens, 0, True)
        logits[name].append(logits_for(tf.params, tf.cfg, h[:, len(ids) - 1]))
    forced = []  # teacher-forced from the kernel path's greedy tokens
    for step in range(8):
        nxt = int(torch.argmax(logits["kernels"][-1][0]))
        forced.append(nxt)
        for name in paths:
            h = run(name, torch.tensor([[nxt]], device="cuda"), len(ids) + step, False)
            logits[name].append(logits_for(tf.params, tf.cfg, h[:, 0]))
    compare_logits(torch, phase, logits, forced)


def wide_integration_phase(torch, eng_mod, ca, plain, cq, tfm, qmod):
    """The logits comparison of ``integration_phase`` at each of the
    study's wide head layouts (WIDE_MODELS), int8 weights and a bf16 KV
    cache as the study runs them."""
    engine = eng_mod.TorchEngine(quantize="int8")
    for model in WIDE_MODELS:
        engine.load_model(model)
        integration_phase(torch, engine, f"integration_{model}", {
            "kernels": (ca.cuda_prefill_attention, ca.cuda_decode_attention, cq.cuda_int4_matmul),
            "plain": (plain.prefill_attention_cached, plain.decode_attention_reference,
                      cq.cuda_int4_matmul),
        }, tfm.forward, tfm.logits_for, qmod, model=model)


def compare_logits(torch, phase, logits, forced):
    """Per-step logits of the kernel path against the plain path: within
    LOGIT_ATOL, and greedy tokens equal except at near-ties of the plain
    path narrower than twice the observed difference."""
    torch.cuda.synchronize()
    max_diff = 0.0
    mismatches = []
    for i, (a, b) in enumerate(zip(logits["kernels"], logits["plain"])):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        diff = (a - b).abs().max().item()
        max_diff = max(max_diff, diff)
        for row in range(a.shape[0]):
            ta, tb = int(torch.argmax(a[row])), int(torch.argmax(b[row]))
            if ta != tb:
                top2 = torch.topk(b[row], 2).values
                margin = (top2[0] - top2[1]).item()
                mismatches.append({"step": i, "row": row, "kernels": ta, "plain": tb,
                                   "plain_top2_margin": margin})
                assert margin <= 2 * diff, ("greedy tokens differ beyond a near-tie", i, margin, diff)
    scale = max(x.abs().max().item() for x in logits["plain"])
    emit({
        "phase": phase, "steps": len(logits["plain"]), "max_abs_logit_diff": max_diff,
        "max_abs_logit": scale, "tolerance": LOGIT_ATOL, "greedy_mismatches": mismatches,
        "forced_tokens": forced,
    })
    assert max_diff <= LOGIT_ATOL, max_diff


def prefill_pool(torch, engine, pk, tfm, eng_mod):
    """Four rows prefilled (contiguous, with the prefill kernel) and
    paginated into one pool of the engine's KV kind (int8 codes under
    ``kv_quantize``). Returns the pool, its table, the prompt lengths and
    each row's last-position logits."""
    quantized = bool(engine.kv_quantize)
    tf = engine._models[MODEL]
    cfg = tf.cfg
    tok = engine._tokenizer_for(MODEL)
    prompts = [STUDY_PROMPT.format(words=100), context_prompt(300), context_prompt(700),
               context_prompt(130)]
    ids = [tok.encode(p) for p in prompts]
    lens = [len(x) for x in ids]
    need = [-(-n // PAGE) for n in lens]
    pool = pk.PagePool.create(cfg.n_layers, sum(need), cfg.n_kv_heads, cfg.d_head, PAGE,
                              dtype=engine.dtype, quantized=quantized, device="cuda")
    table = torch.zeros((len(ids), max(need)), dtype=torch.int32)
    first = []
    for r, row in enumerate(ids):
        bucket = eng_mod._prompt_alloc(len(row))
        kc, vc = tf.init_cache(1, bucket, dtype=engine.dtype)
        tokens = torch.tensor([row + [tok.pad_id] * (bucket - len(row))], device="cuda")
        h, kc, vc = tfm.forward(tf.params, cfg, tokens, 0, kc, vc, None,
                                eng_mod.cuda_prefill_attention, layers=tf.layers)
        first.append(tfm.logits_for(tf.params, cfg, h[:, len(row) - 1]))
        pages = pool.alloc(need[r])
        table[r, : need[r]] = torch.tensor(pages)
        chunks = (pk._paginate(kc[:, 0], len(row), PAGE), pk._paginate(vc[:, 0], len(row), PAGE))
        if quantized:
            chunks = pk.quantize_chunks(*chunks)
        pk.scatter_pages(pool.k, pool.v, pages, *chunks)
    return pool, table.cuda(), torch.tensor(lens, dtype=torch.int32, device="cuda"), torch.cat(first)


def paged_integration_phase(torch, engine, pk, plain, tfm, eng_mod):
    """Four rows in one bf16 pool, then 8 teacher-forced decode steps
    through the stacked-hybrid paged path, once with the parts kernel (the
    engine's callable) and once with the plain parts: each path has its
    own side caches over the shared read-only pool."""
    tf = engine._models[MODEL]
    cfg = tf.cfg
    pool, table, prompt_lens, first = prefill_pool(torch, engine, pk, tfm, eng_mod)

    def plain_parts(q, k_leaf, v_leaf, lengths):
        return plain.paged_decode_attention_parts_reference(
            q, k_leaf["pool"], v_leaf["pool"], k_leaf["table"], lengths)

    paths = {"kernels": eng_mod._paged_parts, "plain": plain_parts}
    sides = {name: engine._side_caches(cfg, len(prompt_lens), 16) for name in paths}
    logits = {name: [first] for name in paths}
    forced = []
    for step in range(8):
        nxt = torch.argmax(logits["kernels"][-1], dim=-1)
        forced.append(nxt.tolist())
        offs = prompt_lens.long() + step
        for name, parts_fn in paths.items():
            leaf = {"table": table, "write_pos": torch.full_like(offs, step), "prompt_lens": prompt_lens}
            kc = {**leaf, "pool": pool.k, "side": sides[name][0]}
            vc = {**leaf, "pool": pool.v, "side": sides[name][1]}
            h, _, _ = tfm.forward(tf.params, cfg, nxt[:, None], offs, kc, vc, parts_fn,
                                  layers=tf.layers)
            logits[name].append(tfm.logits_for(tf.params, cfg, h[:, 0]))
    compare_logits(torch, "paged_integration", logits, forced)


def write_through_requests(GenerationRequest):
    """The write-through phase's rows: the int4 batch's 8 prompts (the
    study prompt and the 300-, 700- and 1,100-token contexts, two each),
    greedy, WRITE_THROUGH_STEPS + 1 new tokens."""
    return [dataclasses.replace(r, max_new_tokens=WRITE_THROUGH_STEPS + 1)
            for r in int4_batch_requests(GenerationRequest)]


def write_through_pool(torch, engine, pk, eng_mod, requests):
    """Each row prefilled through the engine's prefill (B1) and written into
    one pool of the engine's dtype with ``write_prefill``; a row owns
    ceil((prompt + budget + 1) / page) pages, the JAX package's legacy
    write-through bill. Returns the pool, its table, the prompt lengths
    and each row's last-position logits."""
    tf = engine._models[MODEL]
    cfg = tf.cfg
    tok = engine._tokenizer_for(MODEL)
    ids = [tok.encode(r.prompt) for r in requests]
    need = [-(-(len(x) + r.max_new_tokens) // PAGE) for x, r in zip(ids, requests)]
    pool = pk.PagePool.create(cfg.n_layers, sum(need), cfg.n_kv_heads, cfg.d_head, PAGE,
                              dtype=engine.dtype, device="cuda")
    table = torch.zeros((len(ids), max(need)), dtype=torch.int32, device="cuda")
    first = []
    for r, row in enumerate(ids):
        table[r, : need[r]] = torch.tensor(pool.alloc(need[r]), dtype=torch.int32)
        logits, kc, vc = engine._run_prefill(MODEL, row, eng_mod._prompt_alloc(len(row)))
        first.append(logits)
        pk.write_prefill(pool.k, pool.v, table[r], kc[:, 0], vc[:, 0], len(row))
    lens = torch.tensor([len(x) for x in ids], dtype=torch.int32, device="cuda")
    return pool, table, lens, torch.cat(first)


def write_through_phase(torch, engine, pk, tfm, eng_mod, kernels, n_layers, GenerationRequest):
    """The write-through paged decode at the model level, as the JAX package
    drives it: 8 rows prefilled (B1) and written into one bf16 pool, then
    WRITE_THROUGH_STEPS greedy steps through ``forward`` over the leaf
    ``{"pool", "table"}`` with the engine's paged dispatch: each step
    writes its K/V through the table and attends with B6. B1 ran n_layers
    times per row, B6 n_layers times per step, nothing else. Prints the
    wall per step and the share of greedy tokens equal, position by
    position up to a row's first EOS, to the same rows through the
    stacked ``generate_batch`` (B4; a figure: bf16 near-ties may part)."""
    requests = write_through_requests(GenerationRequest)
    tf = engine._models[MODEL]
    cfg = tf.cfg
    times = {}

    def run():
        t0 = time.perf_counter()
        pool, table, lens, first = write_through_pool(torch, engine, pk, eng_mod, requests)
        engine._sync()
        t1 = time.perf_counter()
        token = torch.argmax(first, dim=-1)
        offs = lens.long()
        out = [token]
        for _ in range(WRITE_THROUGH_STEPS):
            kc, vc = {"pool": pool.k, "table": table}, {"pool": pool.v, "table": table}
            h, _, _ = tfm.forward(tf.params, cfg, token[:, None], offs, kc, vc, eng_mod._paged_parts,
                                  layers=tf.layers)
            token = torch.argmax(tfm.logits_for(tf.params, cfg, h[:, 0]), dim=-1)
            out.append(token)
            offs = offs + 1
        tokens = torch.stack(out, dim=1).tolist()
        engine._sync()
        times.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     pool_pages=pool.n_pages, jmax=table.shape[1])
        return tokens

    tokens, counts = count_launches(kernels, run)
    expected = {fn.__name__: 0 for fn in kernels}
    expected["cuda_prefill_attention"] = n_layers * len(requests)
    expected["cuda_paged_decode_attention"] = n_layers * WRITE_THROUGH_STEPS
    batch = engine.generate_batch(requests)
    batch_steps = max(r.generated_tokens for r in batch) - 1
    eos = engine._tokenizer_for(MODEL).eos_id
    same = total = 0
    for row, res in zip(tokens, batch):
        upto = row.index(eos) + 1 if eos in row else len(row)
        total += min(upto, len(res.tokens))
        same += sum(a == b for a, b in zip(row[:upto], res.tokens))
    emit({
        "phase": "engine_write_through", "rows": len(requests), "steps": WRITE_THROUGH_STEPS,
        "prompt_tokens": [len(engine._tokenizer_for(MODEL).encode(r.prompt)) for r in requests],
        **times, "wall_ms_per_step": times["decode_s"] / WRITE_THROUGH_STEPS * 1e3,
        "stacked_batch_wall_ms_per_step": batch[0].decode_s / batch_steps * 1e3,
        "greedy_tokens_compared": total, "equal_to_stacked_batch": same, "share": same / total,
        "counts": counts, "expected": expected,
    })
    assert all(0 <= t < cfg.vocab_size for row in tokens for t in row)
    assert counts == expected, (counts, expected)
    return counts


def write_through_integration_phase(torch, engine, pk, plain, tfm, eng_mod, GenerationRequest):
    """8 teacher-forced write-through steps of the same 8 rows, once with
    B6 (the engine's dispatch) and once with its plain version, each path
    over its own pool (the steps write into it): logits agree to
    LOGIT_ATOL."""
    requests = write_through_requests(GenerationRequest)
    tf = engine._models[MODEL]
    cfg = tf.cfg

    def plain_b6(q, k_leaf, v_leaf, lengths):
        return plain.paged_decode_attention_reference(
            q, k_leaf["pool"], v_leaf["pool"], k_leaf["table"], lengths)

    paths = {"kernels": eng_mod._paged_parts, "plain": plain_b6}
    pools = {name: write_through_pool(torch, engine, pk, eng_mod, requests) for name in paths}
    logits = {name: [pools[name][3]] for name in paths}
    forced = []
    for step in range(8):
        nxt = torch.argmax(logits["kernels"][-1], dim=-1)
        forced.append(nxt.tolist())
        for name, fn in paths.items():
            pool, table, lens, _ = pools[name]
            kc, vc = {"pool": pool.k, "table": table}, {"pool": pool.v, "table": table}
            h, _, _ = tfm.forward(tf.params, cfg, nxt[:, None], lens.long() + step, kc, vc, fn,
                                  layers=tf.layers)
            logits[name].append(tfm.logits_for(tf.params, cfg, h[:, 0]))
    compare_logits(torch, "write_through_integration", logits, forced)


def spec_integration_phase(torch, engine, pk, plain, tfm, eng_mod):
    """The full-width verify forward of a fixed block of SPEC_K + 1
    candidates per row (each row's greedy first token, then four fixed
    tokens) over four prompts in one pool of the engine's KV kind, once
    through B7/B8 (the engine's paged callable) and once with their plain
    versions: the logits of every query position agree to LOGIT_ATOL."""
    quantized = bool(engine.kv_quantize)
    tf = engine._models[MODEL]
    cfg = tf.cfg
    tok = engine._tokenizer_for(MODEL)
    pool, table, prompt_lens, first = prefill_pool(torch, engine, pk, tfm, eng_mod)
    rows = len(prompt_lens)
    fixed = tok.encode(" the light", add_bos=False)[:SPEC_K]
    block = torch.cat([torch.argmax(first, dim=-1)[:, None],
                       torch.tensor([fixed] * rows, device="cuda")], dim=1)

    def plain_parts(q, k_leaf, v_leaf, lengths):
        offsets = (k_leaf["write_pos"] + k_leaf["prompt_lens"]).to(torch.int32)
        if quantized:
            kp, vp = k_leaf["pool"], v_leaf["pool"]
            return plain.paged_mq_attention_int8_reference(
                q, kp["q"], kp["s"], vp["q"], vp["s"], k_leaf["table"], lengths, offsets)
        return plain.paged_mq_attention_reference(
            q, k_leaf["pool"], v_leaf["pool"], k_leaf["table"], lengths, offsets)

    paths = {"kernels": eng_mod._paged_parts, "plain": plain_parts}
    logits = {}
    for name, parts_fn in paths.items():
        side_k, side_v = engine._side_caches(cfg, rows, 16)
        leaf = {"table": table, "write_pos": torch.zeros_like(prompt_lens, dtype=torch.long),
                "prompt_lens": prompt_lens}
        kc = {**leaf, "pool": pool.k, "side": side_k}
        vc = {**leaf, "pool": pool.v, "side": side_v}
        h, _, _ = tfm.forward(tf.params, cfg, block, prompt_lens.long(), kc, vc, parts_fn,
                              layers=tf.layers)
        lg = tfm.logits_for(tf.params, cfg, h)  # [rows, k + 1, V]
        logits[name] = [lg[:, j] for j in range(SPEC_K + 1)]
    compare_logits(torch, "spec_integration_int8_pool" if quantized else "spec_integration",
                   logits, block.tolist())


def drain(session):
    results = []
    while session.active:
        results.extend(session.step())
    return results


def spec_engine_phase(phase, engine, requests, kernels, n_layers, eng_mod, verify, draft_layers=0,
                      k=SPEC_K, verify_launches=1):
    """Open a speculative session over ``requests`` (warm first, on four
    of them with 8 new tokens) and step it until every row retires. The
    verify kernel ``verify`` (B7 or B8) ran ``verify_launches`` times (the
    chunks of a k + 1 block) per layer per verify round; the prefill kernel once per layer per prefill forward (the
    target's grouped forwards, and with a model draft of ``draft_layers``
    layers, each row's draft prefill chunks); a model draft's steps ran
    B2 k + 1 times per layer per round; no other kernel ran. Returns the
    counts and the results in request order."""
    warm = engine.decode_open([dataclasses.replace(r, max_new_tokens=8) for r in requests[:2] + requests[-2:]])
    drain(warm)
    warm.close()
    times = {}

    def run():
        t0 = time.perf_counter()
        session = engine.decode_open(requests)
        assert session.spec is not None, "the session did not speculate"
        engine._sync()
        t1 = time.perf_counter()
        out = drain(session)
        engine._sync()
        times.update(open_s=t1 - t0, decode_window_s=time.perf_counter() - t1)
        session.close()
        return out

    results, counts = count_launches(kernels, run)
    order = {id(r): i for i, r in enumerate(requests)}
    results.sort(key=lambda res: order[id(res.request)])
    check_results(engine, requests, results)
    spec = [r.extras["spec"] for r in results]
    rounds = max(x["rounds"] for x in spec)  # the last row to retire rode every round
    accepted = sum(x["accepted"] for x in spec)
    drafted = sum(x["drafted"] for x in spec)
    tokens = sum(r.generated_tokens for r in results)
    prompts = [r.prompt_tokens for r in results]
    forwards = prefill_forwards(eng_mod, prompts)
    draft_chunks = sum(len(eng_mod._prompt_chunks(n)) for n in prompts) if draft_layers else 0
    expected = {fn.__name__: 0 for fn in kernels}
    expected[verify] = n_layers * rounds * verify_launches
    expected["cuda_prefill_attention"] = n_layers * forwards + draft_layers * draft_chunks
    if draft_layers:
        expected["cuda_decode_attention"] = draft_layers * (k + 1) * rounds
    for res, x in zip(results, spec):
        emit({
            "phase": phase, "prompt_tokens": res.prompt_tokens,
            "generated_tokens": res.generated_tokens, "sampled": res.request.temperature > 0,
            "rounds": x["rounds"], "accepted": x["accepted"], "drafted": x["drafted"],
            "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        })
    emit({
        "phase": phase + "_summary", "rows": len(results), "k": k,
        "verify_launches_per_layer_round": verify_launches, "verify_rounds": rounds,
        "accepted": accepted, "drafted": drafted, "acceptance": accepted / drafted,
        "decode_tokens_per_round_all_rows": (tokens - len(results)) / rounds,
        "generated_tokens": tokens, **times,
        "decode_tokens_per_s": tokens / times["decode_window_s"],
        "prefill_forwards": forwards, "draft_prefill_chunks": draft_chunks,
        "counts": counts, "expected": expected,
    })
    assert counts == expected, (counts, expected)
    return counts, results


def greedy_share(phase, engine, requests, spec_results):
    """The share of the spec session's greedy tokens that equal, position
    by position, the same rows through the plain paged ``generate_batch``
    (a figure, not a gate: bf16 near-ties may resolve differently when the
    verify scores k + 1 positions at once)."""
    plain = engine.generate_batch(requests)
    same = total = 0
    for req, s, p in zip(requests, spec_results, plain):
        if req.temperature > 0:
            continue
        total += len(s.tokens)
        same += sum(a == b for a, b in zip(s.tokens, p.tokens))
    emit({"phase": phase, "greedy_tokens": total, "equal_to_plain_batch": same,
          "share": same / total})


def spec_entry_points_phase(engine, GenerationRequest, kernels):
    """``generate_speculative`` with one n-gram request (a one-row
    session), then ``generate``, which routes the same request there: both
    report their rounds, and the verify ran on B7 and on no other paged
    kernel."""
    req = GenerationRequest(MODEL, STUDY_PROMPT.format(words=STUDY_WORDS[0]), 64, stop_at_eos=False)
    (spec, routed), counts = count_launches(kernels, lambda: (
        engine.generate_speculative(req, k=SPEC_K, source="ngram"), engine.generate(req)))
    for name, res in (("generate_speculative", spec), ("generate", routed)):
        x = res.extras["spec"]
        assert x["source"] == "ngram" and x["rounds"] >= 1, res.extras
        emit({"phase": "spec_entry_points", "entry": name, "generated_tokens": res.generated_tokens,
              "rounds": x["rounds"], "accepted": x["accepted"], "decode_s": res.decode_s,
              "tokens_per_s": res.tokens_per_s})
    assert spec.tokens == routed.tokens
    assert counts["cuda_paged_decode_attention_mq_parts"] > 0, counts
    assert counts["cuda_paged_decode_attention_parts"] == counts["cuda_decode_attention"] == 0, counts
    emit({"phase": "spec_entry_points_launches", "counts": counts})
    return counts


def stepped_rounds(session, live_before):
    """The verify rounds a session's last slice ran: the largest delta of
    a row's cumulative rounds (every live row rides every round)."""
    host = session._spec_host
    return max((host["rounds"][r] - live_before.get(r, 0) for r in live_before), default=0)


def contiguous_spec_phase(phase, torch, engine, kernels, n_layers, eng_mod, GenerationRequest, verify):
    """The contiguous speculating session (the engine's default layout, an
    n-gram draft): the 8 n-gram rows open in a bucket of 16, one slice
    runs, a greedy joiner of CONTIG_SPEC_JOINER_TOKENS context joins (one
    prefill chunk), and the session drains. The verify ran ``verify`` (B7's
    or B8's contiguous instantiation) once a layer a round, the prefill
    kernel once a layer a prefill forward, and no other kernel; a
    ``torch.profiler`` trace of one round of the warm-up session shows
    n_layers device kernels of the instantiation (a trace of a round's
    ~2,700 kernels can lose records on every retake: it is then reported
    as lost, and the launch counts stand alone). Then the greedy share
    against the same rows through the plain contiguous session."""
    reqs = spec_requests(GenerationRequest)
    joiner = GenerationRequest(MODEL, context_prompt(CONTIG_SPEC_JOINER_TOKENS), SPEC_NEW_TOKENS,
                               stop_at_eos=False)
    warm = engine.decode_open([dataclasses.replace(r, max_new_tokens=8) for r in reqs[:2] + reqs[-2:]])
    assert warm.spec is not None and not warm.paged
    try:
        traced = [n for n, _ in device_kernels(torch, lambda: warm.step(1))]
    except AssertionError:  # every retake lost a marker: no count is read
        traced = []
    ours = [n for n in traced if "mq_mma_kernel" in n and "ContiguousRows" in n]
    assert not traced or len(ours) == n_layers, (len(ours), traced[:5])
    drain(warm)
    warm.close()
    rounds, times = [0], {}

    def step(session, n=None):
        before = {r: session._spec_host["rounds"][r] for r, row in enumerate(session.rows) if row}
        out = session.step(n)
        rounds[0] += stepped_rounds(session, before)
        return out

    def run():
        t0 = time.perf_counter()
        session = engine.decode_open(reqs, reserve_rows=len(reqs) + 1)
        assert session.spec is not None and not session.paged
        engine._sync()
        t1 = time.perf_counter()
        out = list(step(session))
        assert session.can_join(joiner)
        session.join(joiner)
        while session.active:
            out.extend(step(session))
        engine._sync()
        times.update(open_s=t1 - t0, decode_window_s=time.perf_counter() - t1,
                      cache_len=session.cache_len, b_bucket=session.b_bucket)
        session.close()
        return out

    results, counts = count_launches(kernels, run)
    order = {id(r): i for i, r in enumerate(reqs + [joiner])}
    results.sort(key=lambda res: order[id(res.request)])
    check_results(engine, reqs + [joiner], results)
    spec = [r.extras["spec"] for r in results]
    accepted = sum(x["accepted"] for x in spec)
    drafted = sum(x["drafted"] for x in spec)
    tokens = sum(r.generated_tokens for r in results)
    forwards = prefill_forwards(eng_mod, [r.prompt_tokens for r in results[:-1]])
    joiner_chunks = len(eng_mod._prompt_chunks(results[-1].prompt_tokens))
    expected = {fn.__name__: 0 for fn in kernels}
    expected[verify] = n_layers * rounds[0]
    expected["cuda_prefill_attention"] = n_layers * (forwards + joiner_chunks)
    for res, x in zip(results, spec):
        emit({"phase": phase, "prompt_tokens": res.prompt_tokens,
              "generated_tokens": res.generated_tokens, "sampled": res.request.temperature > 0,
              "joiner": res.request is joiner, "rounds": x["rounds"], "accepted": x["accepted"],
              "drafted": x["drafted"], "prefill_s": res.prefill_s, "decode_s": res.decode_s})
    # the greedy share against the plain contiguous session over the same rows
    speculative, engine.speculative = engine.speculative, {}
    try:
        plain_session = engine.decode_open(reqs + [joiner])
        assert plain_session.spec is None
        plain = {id(r.request): r for r in drain(plain_session)}
        plain_session.close()
    finally:
        engine.speculative = speculative
    same = total = 0
    for res in results:
        if res.request.temperature == 0:
            p = plain[id(res.request)].tokens
            total += len(res.tokens)
            same += sum(a == c for a, c in zip(res.tokens, p))
    emit({
        "phase": phase + "_summary", "rows": len(results), "k": SPEC_K, "verify_rounds": rounds[0],
        "accepted": accepted, "drafted": drafted, "acceptance": accepted / drafted,
        "decode_tokens_per_round_all_rows": (tokens - len(results)) / rounds[0],
        "generated_tokens": tokens, **times, "decode_tokens_per_s": tokens / times["decode_window_s"],
        "greedy_tokens": total, "greedy_equal_to_plain_session": same, "greedy_share": same / total,
        "profiled_round_device_kernels": len(traced) if traced else "trace lost",
        "profiled_round_contiguous_instantiation_kernels": len(ours) if traced else "trace lost",
        "device_kernel": ours[0] if ours else None,
        "prefill_forwards": forwards, "joiner_chunks": joiner_chunks,
        "counts": counts, "expected": expected,
    })
    assert counts == expected, (counts, expected)
    return counts


def adaptive_spec_phase(torch, eng_mod, kernels, GenerationRequest, smi):
    """The adaptive policy on the card: full-width qwen2:1.5b at int8 with
    a ``cross`` draft of the same vocabulary and no skill (WEAK_DRAFT: its
    config at 2 layers, installed with random weights of another seed, so
    that it shares not even the embedding), the 8 n-gram rows on the
    contiguous layout under ``spec_accept_floor`` ADAPTIVE_FLOOR, slices
    of ADAPTIVE_SLICE_STEPS. k halves 4 -> 2 -> 1 and the session falls
    back to plain decode; every row's fully rejected rounds are billed as
    the draft's wasted Joules. Reports k a slice, the slice of the
    fallback, the session's tokens/s before and after it, and the billed
    Joules."""
    from importlib import import_module

    cfg = import_module(f"{PKG}.models.config").get_model_config(MODEL)
    engine = eng_mod.TorchEngine(quantize="int8", registry={MODEL: cfg},
                                 speculative={MODEL: (f"cross:{WEAK_DRAFT}", SPEC_K)},
                                 spec_accept_floor=ADAPTIVE_FLOOR)
    engine.load_model(MODEL)
    dcfg = dataclasses.replace(cfg, n_layers=WEAK_DRAFT_LAYERS)
    gen = torch.Generator(device=engine.device).manual_seed(WEAK_DRAFT_SEED)
    engine.install_model(WEAK_DRAFT, dcfg,
                         import_module(f"{PKG}.models.transformer").init_params(dcfg, gen, engine.dtype))
    reqs = spec_requests(GenerationRequest)
    warm = engine.decode_open([dataclasses.replace(r, max_new_tokens=8) for r in reqs[:2]])
    drain(warm)
    warm.close()
    engine._spec_source_health.clear()  # the warm-up's verdict is not this session's
    slices = []

    def run():
        session = engine.decode_open(reqs, slice_steps=ADAPTIVE_SLICE_STEPS)
        assert session.spec is not None and session.spec["source"] == "cross"
        out = []
        while session.active:
            k = session.spec["k"] if session.spec is not None else None
            made = sum(len(row.generated) for row in session.rows if row)
            t0 = time.perf_counter()
            retired = session.step()
            engine._sync()
            wall = time.perf_counter() - t0
            made = sum(len(row.generated) for row in session.rows if row) - made
            made += sum(len(r.tokens) for r in retired)  # stop_at_eos=False: all of them
            slices.append({"k": k, "tokens": made, "wall_s": wall, "fallback": session.spec_fallback})
            out.extend(retired)
        session.close()
        return out

    results, counts = count_launches(kernels, run)
    check_results(engine, reqs, sorted(results, key=lambda r: reqs.index(r.request)))
    ks = [x["k"] for x in slices]
    at = next(i for i, x in enumerate(slices) if x["fallback"])
    before, after = slices[:at + 1], slices[at + 1:]
    rate = lambda xs: sum(x["tokens"] for x in xs) / sum(x["wall_s"] for x in xs)  # noqa: E731
    wasted = [r.extras["spec"].get("draft_wasted_J", 0.0) for r in results]
    emit({
        "phase": "engine_spec_adaptive", "draft": WEAK_DRAFT, "draft_layers": WEAK_DRAFT_LAYERS,
        "floor": ADAPTIVE_FLOOR, "slice_steps": ADAPTIVE_SLICE_STEPS, "k_per_slice": ks,
        # rows that retired before the fallback report fallback false
        "fallback_after_slice": at, "rows_reporting_fallback": sum(r.extras["spec"]["fallback"] for r in results),
        "tokens_per_s_speculating": rate(before), "tokens_per_s_after_fallback": rate(after) if after else None,
        "rows_with_draft_waste": sum(1 for w in wasted if w), "draft_wasted_J": sum(wasted),
        "rejected_rounds": sum(r.extras["spec"]["rejected"] for r in results),
        "counts": counts, "nvidia_smi": smi,
    })
    assert ks[0] == SPEC_K and 1 in ks and ks[-1] is None, ks
    assert after and any(r.extras["spec"]["fallback"] for r in results)
    assert sum(wasted) > 0 and counts["cuda_contiguous_mq_attention"] > 0, (wasted, counts)
    assert counts["cuda_decode_attention"] > 0, counts  # the draft's steps, then plain decode
    del engine
    torch.cuda.empty_cache()
    return counts


def spec_join_preempt_phase(torch, eng_mod, kernels, GenerationRequest, smi, paged):
    """Joins into and preemption of a speculating session (n-gram draft,
    qwen2:1.5b at int8 cut to SOLO_CUT_LAYERS layers), paged and
    contiguous: an anchor and a victim open, one slice runs, a greedy and
    a sampled joiner join; then the victim is preempted by swap, one
    slice runs without it, and it resumes into its slot. Its
    tokens, and every other row's, equal those of the same schedule run
    without the preemption (rows are independent and the n-gram history
    is rebuilt from the tokens)."""
    engine = eng_mod.TorchEngine(quantize="int8", paged_kv=paged, registry=cut_registry(),
                                 speculative={MODEL: ("ngram", SPEC_K)})
    engine.load_model(MODEL)
    anchor = GenerationRequest(MODEL, STUDY_PROMPT.format(words=STUDY_WORDS[0]), SPEC_NEW_TOKENS,
                               stop_at_eos=False)
    # the joiners inherit the session's draft config: their prompt
    # allocations fit the history buffer the opening rows sized
    victim = GenerationRequest(MODEL, context_prompt(700), SPEC_NEW_TOKENS, stop_at_eos=False)
    greedy = GenerationRequest(MODEL, context_prompt(300), 64, stop_at_eos=False)
    sampled = GenerationRequest(MODEL, context_prompt(200), 64, temperature=0.7, seed=5,
                                stop_at_eos=False)
    info = {}

    def schedule(preempt):
        session = engine.decode_open([anchor, victim], reserve_rows=4)
        assert session.spec is not None and session.paged == paged
        out = list(session.step())
        for joiner in (greedy, sampled):
            assert session.can_join(joiner)
            session.join(joiner)
        if preempt:
            slot = next(r for r, row in enumerate(session.rows) if row and row.request is victim)
            pr = session.preempt(victim, policy="swap")
            assert pr is not None
            info.update(host_bytes=pr.host_bytes, generated_at_preempt=len(pr.generated))
            out += session.step()
            assert session.can_resume(pr)
            assert session.join_commit(session.resume_begin(pr)) == slot
        else:
            out += session.step()
        out += drain(session)
        session.close()
        return {r.request.prompt: r for r in out}

    ref = schedule(False)
    got, counts = count_launches(kernels, lambda: schedule(True))
    equal = {name: got[r.prompt].tokens == ref[r.prompt].tokens
             for name, r in (("anchor", anchor), ("victim", victim), ("greedy_joiner", greedy),
                             ("sampled_joiner", sampled))}
    phase = "engine_spec_join_preempt_" + ("paged" if paged else "contiguous")
    emit({
        "phase": phase, "layers": SOLO_CUT_LAYERS, "equal_to_the_uninterrupted_run": equal,
        "rounds": {name: got[r.prompt].extras["spec"]["rounds"] for name, r in
                   (("greedy_joiner", greedy), ("sampled_joiner", sampled), ("victim", victim))},
        "generated_tokens": {name: got[r.prompt].generated_tokens for name, r in
                             (("greedy_joiner", greedy), ("sampled_joiner", sampled))},
        **info, "counts": counts, "nvidia_smi": smi,
    })
    assert all(equal.values()), equal
    assert got[sampled.prompt].extras["spec"]["rounds"] >= 1
    assert got[greedy.prompt].extras["spec"]["rounds"] >= 1
    del engine
    torch.cuda.empty_cache()
    return counts


def contiguous_spec_entry_points_phase(engine, GenerationRequest, kernels):
    """``generate`` on a default (contiguous) engine with an n-gram
    ``speculative=`` config: a greedy and a sampled request each drain a
    one-row contiguous session whose verify runs B7's contiguous
    instantiation, and no paged kernel runs."""
    prompt = STUDY_PROMPT.format(words=STUDY_WORDS[0])
    reqs = [GenerationRequest(MODEL, prompt, 64, stop_at_eos=False),
            GenerationRequest(MODEL, prompt, 64, temperature=0.7, seed=3, stop_at_eos=False)]
    results, counts = count_launches(kernels, lambda: [engine.generate(r) for r in reqs])
    for req, res in zip(reqs, results):
        x = res.extras["spec"]
        assert x["source"] == "ngram" and x["rounds"] >= 1 and res.extras["stepped"], res.extras
        emit({"phase": "spec_contiguous_entry_points", "sampled": req.temperature > 0,
              "generated_tokens": res.generated_tokens, "rounds": x["rounds"],
              "accepted": x["accepted"], "decode_s": res.decode_s, "tokens_per_s": res.tokens_per_s})
    assert counts["cuda_contiguous_mq_attention"] > 0, counts
    assert not any(n for name, n in counts.items() if "paged" in name), counts
    emit({"phase": "spec_contiguous_entry_points_launches", "counts": counts})
    return counts


def serve_cli_speculative_contiguous_phase(torch, root, smi):
    """``serve --backend torch --scheduler continuous --speculative
    qwen2:1.5b=ngram:4 --spec-accept-floor CLI_SPEC_FLOOR`` without
    ``--paged-kv`` (the contiguous session's verify), in a subprocess that
    owns the card: CLI_SPEC_REQUESTS concurrent requests through the
    port's HTTP client, each answered in full, the server's
    ``llm_spec_rounds_total`` moved, then SIGTERM and exit 0."""
    import gc
    import re
    import tempfile
    import threading
    import urllib.request
    from importlib import import_module

    client_mod = import_module(f"{PKG}.serve.client")
    GenerationRequest = import_module(f"{PKG}.engine.backend").GenerationRequest
    gc.collect()
    torch.cuda.empty_cache()
    reqs = [GenerationRequest(MODEL, context_prompt(n), 64, stop_at_eos=False)
            for n in (100, 200, 300, 400, 500, 600, 700, 800)[:CLI_SPEC_REQUESTS]]
    results = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_spec_") as out:
        log_path = Path(out) / "serve.log"
        args = ["--models", MODEL, "--quantize", "int8", "--scheduler", "continuous",
                "--speculative", f"{MODEL}=ngram:{SPEC_K}", "--spec-accept-floor", str(CLI_SPEC_FLOOR)]
        with ServeProcess(root, log_path, args) as server:
            client = client_mod.RemoteHTTPBackend(server.url)
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, client.generate(reqs[i])))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            with urllib.request.urlopen(f"{server.url}/metrics", timeout=30) as resp:
                metrics = resp.read().decode()
        log_tail = log_path.read_text()[-2000:]
    rounds = sum(float(x) for x in re.findall(r"^llm_spec_rounds_total\{[^}]*\} (\S+)$", metrics, re.M))
    assert server.rc == 0, (server.rc, log_tail)
    assert sorted(results) == list(range(len(reqs))), (sorted(results), log_tail)
    for i, res in results.items():
        assert 1 <= res.generated_tokens == len(res.tokens) <= reqs[i].max_new_tokens, (i, res)
    assert rounds > 0, metrics[-2000:]
    emit({"phase": "serve_cli_speculative_contiguous", "args": args, "server_start_s": server.started,
          "requests": len(reqs), "generated_tokens": [r.generated_tokens for _, r in sorted(results.items())],
          "spec_rounds_served": rounds, "server_exit_code": server.rc,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})


STUDY_IDLE_S = 2.0  # NVML power read before the study's first run
# NVML's two readings of a row must agree: the energy counter's Joules
# over the request's wall against the mean of the power samples. They
# differ by the window's edges (the profiler's window holds the request
# and a few milliseconds around it) and by the power sensor's own
# averaging; a counter read in the wrong units or a stale difference
# lies far outside.
STUDY_POWER_AGREEMENT = 0.15
# A row's power under load must not read below idle: the card's idle
# read (before the study) less this share is the floor.
STUDY_IDLE_MARGIN = 0.2


def study_phase(torch, eng_mod, kernels, smi):
    """The study's measured run: ``ExperimentController`` over
    ``LlmEnergyConfig`` (qwen2:1.5b, both locations, 100 words, two
    repetitions), whose ``before_experiment`` builds ``TorchEngine(quantize=
    "int8")`` itself. Each row must be done, with NVML's Joules beside the modelled ones and
    NVML's duty cycle in [0, 100] %; B1 and B2 must have run once a layer
    for every prefill chunk and decode step of the rows and of the
    warm-ups, and no other kernel at all."""
    import csv
    import tempfile
    from importlib import import_module

    nvml = import_module(f"{PKG}.profilers.nvml")
    study = import_module(f"{PKG}.experiments.llm_energy")
    controller = import_module(f"{PKG}.runner.controller")

    dev = nvml.nvml_device()  # the current CUDA device, found by its PCI bus id
    torch.cuda.synchronize()
    watts = []
    t_end = time.perf_counter() + STUDY_IDLE_S
    while time.perf_counter() < t_end:
        watts.append(dev.power_w())
        time.sleep(0.1)
    idle_w = sum(watts) / len(watts)
    emit({"phase": "study_idle", "nvml_idle_w": idle_w, "samples": len(watts),
          "nvml_name": dev.name(), "nvml_power_limit_w": dev.power_limit_w(), "nvidia_smi": smi})
    assert idle_w > 0, watts

    # Record every generate (the warm-ups' too) to count what B1/B2 owe.
    seen, warm = [], []
    generate, warmup = eng_mod.TorchEngine.generate, eng_mod.TorchEngine.warmup

    def recording_generate(self, request):
        seen.append(generate(self, request))
        return seen[-1]

    def recording_warmup(self, request):
        n = len(seen)
        warmup(self, request)
        warm.extend(seen[n:])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_study_") as out:
        config = study.LlmEnergyConfig(
            models=[MODEL], locations=["on_device", "remote"], lengths=[STUDY_WORDS[0]],
            repetitions=2, cooldown_ms=2000, results_output_path=out,
        )
        counter = nvml.NvmlEnergyProfiler()
        assert counter.available, f"NVML's energy counter does not read: {counter.unavailable_reason}"
        assert any(isinstance(p, nvml.NvmlEnergyProfiler) for p in config.profilers), config.profilers
        ctl = controller.ExperimentController(config, echo=False)
        eng_mod.TorchEngine.generate, eng_mod.TorchEngine.warmup = recording_generate, recording_warmup
        t0 = time.perf_counter()
        try:
            _, counts = count_launches(kernels, ctl.do_experiment)
        finally:
            eng_mod.TorchEngine.generate, eng_mod.TorchEngine.warmup = generate, warmup
        seconds = time.perf_counter() - t0
        exp = Path(out) / config.name
        with (exp / "run_table.csv").open() as f:
            rows = list(csv.DictReader(f))
        channels = json.loads((exp / "energy_channels.json").read_text())["channels"]
        engine = config._backends["on_device"]
        n_layers = engine._models[MODEL].cfg.n_layers

    assert [c["available"] for c in channels if c["name"] == "nvml"] == [True], channels
    assert len(rows) == 4 and all(r["__done"] == "DONE" for r in rows), rows
    measured = [r for r in seen if not any(r is w for w in warm)]
    assert len(measured) == 4 and len(seen) == 4 + len(engine._warmed), (len(seen), len(warm))
    assert sorted(int(r["generated_tokens"]) for r in rows) == sorted(r.generated_tokens for r in measured)
    for r in rows:
        remote = r["location"] == "remote"
        assert 1 <= int(r["generated_tokens"]) <= math.ceil(STUDY_WORDS[0] * TOKENS_PER_WORD), r
        assert float(r["gpu_energy_J"]) > 0 and float(r["energy_model_J"]) > 0, r
        assert float(r["joules_per_token"]) > 0, r
        assert r["backend"].endswith("[aliased-on_device]") == remote, r
        assert (r["remote_modeled_decode_s"] != "") == remote, r
        tokens = int(r["generated_tokens"])
        measured_j, modelled_j = float(r["gpu_energy_J"]), float(r["energy_model_J"])
        counter_w, sampled_w = measured_j / float(r["execution_time_s"]), float(r["gpu_avg_power_W"])
        assert abs(counter_w - sampled_w) <= STUDY_POWER_AGREEMENT * sampled_w, (counter_w, sampled_w, r)
        assert min(counter_w, sampled_w) > (1 - STUDY_IDLE_MARGIN) * idle_w, (counter_w, sampled_w, idle_w, r)
        emit({
            "phase": "study_row", "run": r["__run_id"], "location": r["location"],
            "backend": r["backend"], "chips": int(r["chips"]), "prompt_tokens": int(r["prompt_tokens"]),
            "generated_tokens": tokens, "execution_time_s": float(r["execution_time_s"]),
            "decode_s": float(r["decode_s"]), "remote_modeled_decode_s": r["remote_modeled_decode_s"],
            "measured_J": measured_j, "modelled_J": modelled_j,
            "measured_J_per_token": measured_j / tokens, "modelled_J_per_token": float(r["joules_per_token"]),
            # one card measured against one card modelled; a remote row's
            # modelled J is an 8-GPU node's, so no ratio is formed there
            "measured_over_modelled": None if remote else measured_j / modelled_j,
            "counter_W": counter_w, "gpu_avg_power_W": sampled_w,
            "gpu_power_model_W": float(r["gpu_power_model_W"]),
            "gpu_util_est": float(r["gpu_util_est"]), "nvml_idle_w": idle_w,
            "gpu_duty_cycle_pct": float(r["gpu_duty_cycle_pct"]), "energy_duty_J": float(r["energy_duty_J"]),
            "profiled_busy_pct": 100 * (1 - PROFILED_IDLE_SHARE), "nvidia_smi": smi,
        })
        assert 0.0 <= float(r["gpu_duty_cycle_pct"]) <= 100.0 and float(r["energy_duty_J"]) > 0, r
    chunks = sum(len(eng_mod._prompt_chunks(r.prompt_tokens)) for r in seen)
    # The decode loop runs one forward per token after the first, and
    # stops after appending EOS (which the result then drops).
    steps = sum(min(r.generated_tokens, r.request.max_new_tokens - 1) for r in seen)
    expected = {fn.__name__: 0 for fn in kernels}
    expected["cuda_prefill_attention"] = n_layers * chunks
    expected["cuda_decode_attention"] = n_layers * steps
    emit({"phase": "study_launches", "counts": counts, "expected": expected, "generates": len(seen),
          "warmups": len(warm), "seconds": seconds})
    assert counts == expected, (counts, expected)
    del config, ctl, engine
    return counts


# The study through the command line: every study model at 100 words, one
# repetition, 2 s cooldown. (A 1,000-word row was cut when the whole script
# took 973.4 s on an H100 80GB HBM3 at 700 W, 81% of its 1,200 s limit; the
# qwen2:1.5b 500-word row, 76.45 s of the 886.58 s script, was cut when the
# prefix-cache, checkpoint and duty-cycle phases came. The engine phases
# still decode 667 tokens on qwen2:1.5b, and the sweep,
# examples/torch_llm_energy_sweep.py, runs every length.)
STUDY_CLI_CONFIGS = (
    ("study_cli", None, (100,)),  # None: the study's 7 models
)
STUDY_CLI_COOLDOWN_MS = 2000
# recompute-energy must give back the stored modelled Joules.
RECOMPUTE_RTOL = 1e-6
STUDY_CLI_CONFIG = """from {pkg}.experiments.llm_energy import MODELS, LlmEnergyConfig


class RunnerConfig(LlmEnergyConfig):
    name = {name!r}

    def __init__(self):
        super().__init__(
            models={models}, locations=["on_device"], lengths={lengths}, repetitions=1,
            cooldown_ms={cooldown}, shuffle=False, results_output_path={out!r},
        )
"""


def study_cli_phase(torch, eng_mod, kernels, smi):
    """The study from the command line: ``runner.cli.main([config.py])``
    over the config files of STUDY_CLI_CONFIGS written here (the study's 7
    models at 100 words), each building its own
    ``TorchEngine(quantize="int8")`` and analysing its table at the end;
    then ``recompute-energy`` over the first table. Every row must be
    done with tokens and NVML Joules, its counter's mean W within
    STUDY_POWER_AGREEMENT of its sampled mean and both above the idle
    floor; every ``generate`` (warm-ups too) must carry
    ``extras["energy_model"]`` and have launched B1 once a layer per
    prefill chunk and B2 once a layer per decode forward, and nothing
    else; the report must analyse ``gpu_energy_J``; the recompute must
    leave ``energy_model_J`` as stored."""
    import csv
    import gc
    import tempfile
    from importlib import import_module

    cli = import_module(f"{PKG}.runner.cli")
    nvml = import_module(f"{PKG}.profilers.nvml")
    study = import_module(f"{PKG}.experiments.llm_energy")

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dev = nvml.nvml_device()
    watts = []
    t_end = time.perf_counter() + STUDY_IDLE_S
    while time.perf_counter() < t_end:
        watts.append(dev.power_w())
        time.sleep(0.1)
    idle_w = sum(watts) / len(watts)
    emit({"phase": "study_cli_idle", "nvml_idle_w": idle_w, "samples": len(watts),
          "memory_allocated_bytes": held, "nvidia_smi": smi})

    # Each generate's own launches: the counts just before and just after it.
    calls = []
    generate = eng_mod.TorchEngine.generate

    def recording_generate(self, request):
        before = {fn.__name__: fn.launches for fn in kernels}
        result = generate(self, request)
        after = {fn.__name__: fn.launches for fn in kernels}
        n_layers = self._models[request.model].cfg.n_layers
        calls.append((result, n_layers, {k: after[k] - before[k] for k in after}))
        return result

    totals = {fn.__name__: 0 for fn in kernels}
    rows_by_config = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_study_cli_") as out:
        for name, models, lengths in STUDY_CLI_CONFIGS:
            path = Path(out) / f"{name}.py"
            path.write_text(STUDY_CLI_CONFIG.format(
                pkg=PKG, name=name, models="MODELS" if models is None else list(models),
                lengths=list(lengths), cooldown=STUDY_CLI_COOLDOWN_MS, out=out))
            n_calls = len(calls)
            t1 = time.perf_counter()
            eng_mod.TorchEngine.generate = recording_generate
            try:
                rc, counts = count_launches(kernels, lambda: cli.main([str(path)]))
            finally:
                eng_mod.TorchEngine.generate = generate
            seconds = time.perf_counter() - t1
            assert rc == 0, (name, rc)
            gc.collect()  # the config's engine and its models go with it
            torch.cuda.empty_cache()
            exp = Path(out) / name
            with (exp / "run_table.csv").open() as f:
                rows = list(csv.DictReader(f))
            want = len(study.MODELS if models is None else models) * len(lengths)
            assert len(rows) == want and all(r["__done"] == "DONE" for r in rows), rows
            expected = {fn.__name__: 0 for fn in kernels}
            for result, n_layers, got in calls[n_calls:]:
                assert "energy_model" in (result.extras or {}), result.extras
                chunks = len(eng_mod._prompt_chunks(result.prompt_tokens))
                steps = min(result.generated_tokens, result.request.max_new_tokens - 1)
                owed = {fn.__name__: 0 for fn in kernels}
                owed["cuda_prefill_attention"] = n_layers * chunks
                owed["cuda_decode_attention"] = n_layers * steps
                assert got == owed, (result.request.model, got, owed)
                for k, v in owed.items():
                    expected[k] += v
            assert counts == expected, (name, counts, expected)
            for k, v in counts.items():
                totals[k] += v
            for r in rows:
                tokens = int(r["generated_tokens"])
                measured_j, modelled_j = float(r["gpu_energy_J"] or 0), float(r["energy_model_J"])
                assert tokens > 0 and measured_j > 0, r
                forwards = min(tokens, math.ceil(int(r["length"]) * TOKENS_PER_WORD) - 1)
                counter_w, sampled_w = measured_j / float(r["execution_time_s"]), float(r["gpu_avg_power_W"])
                emit({
                    "phase": "study_cli_row", "config": name, "model": r["model"],
                    "length": int(r["length"]), "prompt_tokens": int(r["prompt_tokens"]),
                    "generated_tokens": tokens, "request_s": float(r["execution_time_s"]),
                    "decode_s": float(r["decode_s"]),
                    "ms_per_decode_step": 1000 * float(r["decode_s"]) / max(forwards, 1),
                    "gpu_energy_J": measured_j, "nvml_W": sampled_w, "counter_W": counter_w,
                    "energy_model_J": modelled_j, "gpu_power_model_W": float(r["gpu_power_model_W"]),
                    "J_per_token_measured": measured_j / tokens,
                    "J_per_token_modelled": float(r["joules_per_token"]),
                    "nvml_idle_w": idle_w, "nvidia_smi": smi,
                })
                # NVML's two readings of the row agree, and neither reads
                # below idle: a window holding outside work (a build, a
                # load) or a stale counter fails here, as in ``study``.
                assert abs(counter_w - sampled_w) <= STUDY_POWER_AGREEMENT * sampled_w, (
                    name, counter_w, sampled_w, r)
                assert min(counter_w, sampled_w) > (1 - STUDY_IDLE_MARGIN) * idle_w, (
                    name, counter_w, sampled_w, idle_w, r)
            # The report's energy metric is NVML's: H2 correlates every
            # other column (the modelled Joules among them) against it.
            report = json.loads((exp / "analysis_report.json").read_text())
            assert "gpu_energy_J" in (exp / "analysis_report.md").read_text()
            assert report["h2_energy_is_modelled"] is False, report.get("h2_energy_is_modelled")
            assert report["h2_spearman"], report
            for loc, per_metric in report["h2_spearman"].items():
                assert "gpu_energy_J" not in per_metric and "energy_model_J" in per_metric, (loc, per_metric)
            assert report["variance_check"].get("metric", "gpu_energy_J") == "gpu_energy_J"
            emit({"phase": "study_cli_launches", "config": name, "counts": counts,
                  "expected": expected, "generates": len(calls) - n_calls, "seconds": seconds,
                  "energy_metric": "gpu_energy_J"})
            rows_by_config[name] = (exp, rows)

        exp, rows = rows_by_config[STUDY_CLI_CONFIGS[0][0]]
        assert cli.main(["recompute-energy", str(exp)]) == 0
        with (exp / "run_table.csv").open() as f:
            again = {r["__run_id"]: float(r["energy_model_J"]) for r in csv.DictReader(f)}
        worst = 0.0
        for r in rows:
            stored = float(r["energy_model_J"])
            rel = abs(again[r["__run_id"]] - stored) / stored
            worst = max(worst, rel)
            assert rel <= RECOMPUTE_RTOL, (r["__run_id"], stored, again[r["__run_id"]])
    emit({"phase": "study_cli_recompute", "rows": len(rows), "max_rel_change": worst})
    emit({"phase": "study_cli_done", "seconds": time.perf_counter() - t0,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return totals


# The serving phases: in-process GenerationServer over TorchEngine at int8
# weights on 127.0.0.1, driven over HTTP through the port's client. The
# continuous phase's traffic: seeded Poisson arrivals, prompts of 50–600
# tokens and 64–128 new tokens (the first request at both maxima, so that
# the session it opens takes every later request); three requests stream,
# one of them is closed after its second delta (a cancel), two sample, and
# the last two, of x_priority "high", are sent only once the session is
# full (no free slot, requests waiting in the scheduler's queue), so that
# they preempt.
SERVE_REQUESTS = 16
SERVE_SMALL_REQUESTS = 8  # the int8-pool and window phases
SERVE_MEAN_GAP_S = 0.05
SERVE_SEED = 13
SERVE_PROMPT_TOKENS = (50, 600)
SERVE_NEW_TOKENS = (64, 128)
SERVE_STREAMED = (2, 6, 10)
SERVE_CANCELLED = 6  # one of the streamed ones
SERVE_SAMPLED = (5, 9)
SERVE_HIGH = (14, 15)
SERVE_FULL_WAIT_S = 120.0
SERVE_CHUNK_TOKENS = 64  # the continuous scheduler's join-prefill chunk
SERVE_POWER_PERIOD_S = 0.05  # NVML power samples during the traffic
SERVE_SOLO_ROWS = 4  # greedy rows also run through solo generate (the share)


def serve_traffic(GenerationRequest, parse_priority, n, seed):
    """(requests, arrival gaps in s) of one serving phase (see above)."""
    import random

    rng = random.Random(seed)
    reqs, gaps = [], []
    for i in range(n):
        prompt = SERVE_PROMPT_TOKENS[1] if i == 0 else rng.randint(*SERVE_PROMPT_TOKENS)
        new = SERVE_NEW_TOKENS[1] if i == 0 else rng.randint(*SERVE_NEW_TOKENS)
        kw = dict(temperature=0.7, seed=i) if i in SERVE_SAMPLED else {}
        if i in SERVE_HIGH:
            kw["priority"] = parse_priority("high")
        reqs.append(GenerationRequest(MODEL, context_prompt(prompt), new, stop_at_eos=False, **kw))
        gaps.append(0.0 if i == 0 else rng.expovariate(1.0 / SERVE_MEAN_GAP_S))
    return reqs, gaps


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def drive_server(torch, server_mod, client_mod, engine, kernels, requests, gaps, streamed=(),
                 cancelled=None, dev=None, when_full=(), poll=True, **server_kw):
    """Start a GenerationServer over ``engine`` on 127.0.0.1 (port 0), send
    ``requests`` at their arrival gaps from one client thread each (the
    ``streamed`` ones through ``generate_stream``, ``cancelled`` closed
    after its second delta; the ``when_full`` ones only once the live
    session has no free slot and requests wait in the scheduler's queue),
    and stop the server. ``poll`` runs the sampler thread (NVML's W when
    ``dev`` is given, the session's live rows). The launch counts are
    set to 0 just before the first request and read just after the last
    answer. Returns (results by index, streamed deltas by index, counts,
    wall s, mean NVML W, the scheduler's largest live row count)."""
    import threading

    server = server_mod.GenerationServer(engine, host="127.0.0.1", port=0, quiet=True, **server_kw)
    server.start()
    client = client_mod.RemoteHTTPBackend(f"http://127.0.0.1:{server.port}")
    results, deltas, errors = {}, {}, {}
    watts, live_rows = [], [0]
    done = threading.Event()

    def sample():
        while not done.is_set():
            if dev is not None:
                watts.append(dev.power_w())
            dbg = getattr(server._scheduler, "_dbg", None)
            if dbg is not None:
                live_rows[0] = max(live_rows[0], dbg[0].active)
            time.sleep(SERVE_POWER_PERIOD_S)

    def send(i, req):
        try:
            if i not in streamed:
                results[i] = client.generate(req)
                return
            deltas[i] = []
            stream = client.generate_stream(req)
            for chunk in stream:
                if chunk.done:
                    results[i] = chunk.result
                    break
                deltas[i].extend(chunk.tokens)
                if i == cancelled and len(deltas[i]) >= 2:
                    stream.close()  # the server's next write fails: the row is cancelled
                    break
        except Exception as exc:  # noqa: BLE001 — reported below
            errors[i] = exc

    sampler = threading.Thread(target=sample, daemon=True)
    try:
        for fn in kernels:
            fn.launches = 0
        if poll:
            sampler.start()
        t0 = time.perf_counter()
        threads = []
        for i, (req, gap) in enumerate(zip(requests, gaps)):
            time.sleep(gap)
            deadline = time.perf_counter() + SERVE_FULL_WAIT_S
            sched = server._scheduler
            while i in when_full and not (sched._dbg is not None and sched._dbg[0].free_slots == 0
                                          and sched._queue.qsize() > 0):
                assert time.perf_counter() < deadline, "the session never filled"
                time.sleep(0.01)
            threads.append(threading.Thread(target=send, args=(i, req)))
            threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in kernels}
    finally:
        done.set()
        if poll:
            sampler.join(timeout=5)
        server.stop()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    mean_w = sum(watts) / len(watts) if watts else None
    return results, deltas, counts, wall, mean_w, live_rows[0]


def replay_gap(torch, engine, tfm, ca, eng_mod, request, tokens, plain=False):
    """Teacher-force ``tokens`` after the request's prompt through the
    engine's solo prefill (B1 over a contiguous cache; with ``plain``, the
    plain forward, no kernel at all): the largest gap between a position's
    maximum logit and the served token's logit."""
    tf = engine._models[request.model]
    tok = engine._tokenizer_for(request.model)
    prompt = tok.encode(request.prompt)
    ids = prompt + tokens[:-1]
    bucket = eng_mod._prompt_alloc(len(ids))  # one forward, past 2,048 tokens too
    k_cache, v_cache = tf.init_cache(1, bucket, dtype=engine.dtype)
    x = torch.tensor([ids + [tok.pad_id] * (bucket - len(ids))], device=engine.device)
    with torch.no_grad():
        hidden, _, _ = tfm.forward(tf.params, tf.cfg, x, 0, k_cache, v_cache, None,
                                   None if plain else ca.cuda_prefill_attention, layers=tf.layers)
        logits = tfm.logits_for(tf.params, tf.cfg, hidden[0, len(prompt) - 1 : len(ids)]).float()
        served = torch.tensor(tokens, device=engine.device)[:, None]
        gap = logits.max(dim=1).values - logits.gather(1, served)[:, 0]
    return float(gap.max())


def hold_greedy(torch, engine, tfm, ca, eng_mod, phase, requests, results, solo_rows=0):
    """Hold every served greedy row against the solo path: each served
    token's logit within LOGIT_ATOL of its position's maximum when the row
    is replayed teacher-forced (gated); the share of tokens equal to solo
    ``generate``'s over the first ``solo_rows`` rows (printed: random
    weights give near-ties, and the paged kernels' grids change with the
    rows)."""
    gaps, same, total = [], 0, 0
    for i, res in sorted(results.items()):
        if requests[i].temperature > 0:
            continue
        gaps.append(replay_gap(torch, engine, tfm, ca, eng_mod, requests[i], res.tokens))
        if len(gaps) <= solo_rows:
            solo = engine.generate(requests[i]).tokens
            same += sum(a == b for a, b in zip(solo, res.tokens))
            total += max(len(solo), len(res.tokens))
    line = {"phase": phase, "rows": len(gaps), "max_logit_gap": max(gaps), "logit_atol": LOGIT_ATOL}
    if solo_rows:
        line.update(solo_rows=min(len(gaps), solo_rows), solo_token_share=same / total)
    emit(line)
    assert max(gaps) <= LOGIT_ATOL, gaps


def decode_clock(eng_mod, path, kv="bf16"):
    """(decode-window seconds, decode steps) the engine's telemetry has
    recorded so far on ``path`` (``contiguous`` or ``paged``): a session
    observes each slice's wall and steps, so the difference over a
    serving phase over the difference in steps is its ms a session
    step."""
    return eng_mod._DECODE_H._default.sum, eng_mod._STEPS_C.labels(path=path, kv=kv).value


def check_served(requests, results, eos, cancelled=()):
    """Every request that was not cancelled ended (its budget or an EOS)
    with in-vocabulary tokens and its modelled energy."""
    for i, req in enumerate(requests):
        if i in cancelled:
            assert i not in results, i
            continue
        res = results[i]
        assert res.generated_tokens == len(res.tokens) >= 1, (i, res.generated_tokens)
        assert len(res.tokens) == req.max_new_tokens or res.tokens[-1] == eos, (i, len(res.tokens))
        assert "energy_model" in (res.extras or {}), (i, res.extras)


def serve_phases(torch, eng_mod, kernels, smi, tfm, ca):
    """The serving phases on full-width qwen2:1.5b at int8 weights cut to
    SOLO_CUT_LAYERS layers (see SERVE_*): ``serve_continuous`` (the
    continuous scheduler over the bf16 pool: joins in prefill chunks,
    streams, a cancel, swap preemption), ``serve_continuous_int8_kv`` (the
    int8 pool), ``serve_window`` (``generate_batch``) and
    ``serve_serial`` (``generate`` and ``generate_stream`` under the
    server's lock). Returns the launches."""
    import gc
    from importlib import import_module

    server_mod = import_module(f"{PKG}.serve.server")
    client_mod = import_module(f"{PKG}.serve.client")
    protocol = import_module(f"{PKG}.serve.protocol")
    flight = import_module(f"{PKG}.obs.flight")
    nvml = import_module(f"{PKG}.profilers.nvml")
    GenerationRequest = import_module(f"{PKG}.engine.backend").GenerationRequest
    dev = nvml.nvml_device()
    names = {fn.__name__ for fn in kernels}
    totals = {name: 0 for name in names}

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    def only(counts, ran):
        """``ran`` launched, every other kernel stayed at 0."""
        assert all(counts[k] > 0 for k in ran), counts
        assert all(counts[k] == 0 for k in names - set(ran)), counts

    engine = eng_mod.TorchEngine(quantize="int8", paged_kv=True, registry=cut_registry())
    engine.load_model(MODEL)
    reqs, gaps = serve_traffic(GenerationRequest, protocol.parse_priority, SERVE_REQUESTS, SERVE_SEED)
    # warm: a batch, and a session with a chunked joiner
    engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in reqs[:2]])
    sess = engine.decode_open([dataclasses.replace(reqs[0], max_new_tokens=4)], reserve_rows=2)
    pj = sess.join_begin(dataclasses.replace(reqs[1], max_new_tokens=4), SERVE_CHUNK_TOKENS)
    while not sess.join_step(pj):
        pass
    sess.join_commit(pj)
    while sess.active:
        sess.step()
    sess.close()
    admission_rows = engine.max_admission_rows(reqs[0])
    flight.FLIGHT.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock0 = decode_clock(eng_mod, "paged")
    results, deltas, counts, wall, mean_w, live = drive_server(
        torch, server_mod, client_mod, engine, kernels, reqs, gaps, streamed=SERVE_STREAMED,
        cancelled=SERVE_CANCELLED, dev=dev, when_full=SERVE_HIGH, scheduler="continuous",
        prefill_chunk_tokens=SERVE_CHUNK_TOKENS,
    )
    clock1 = decode_clock(eng_mod, "paged")
    peak = torch.cuda.max_memory_allocated()
    events = flight.FLIGHT.events()
    by = lambda kind, **kw: [e for e in events if e["type"] == kind  # noqa: E731
                             and all(e.get(k) == v for k, v in kw.items())]
    joins = len(by(flight.EV_REQUEST_ADMITTED, joined=True))
    chunks = len(by(flight.EV_JOIN_CHUNK))
    preempts, resumes = len(by(flight.EV_ROW_PREEMPTED)), len(by(flight.EV_ROW_RESUMED))
    cancels = len(by(flight.EV_ROW_RETIRED, reason="cancelled"))
    eos = engine._tokenizer_for(MODEL).eos_id
    check_served(reqs, results, eos, cancelled=(SERVE_CANCELLED,))
    for i in SERVE_STREAMED:
        if i != SERVE_CANCELLED:
            assert deltas[i] == results[i].tokens, i
    only(counts, ("cuda_prefill_attention", "cuda_paged_decode_attention_parts"))
    add(counts)
    tokens = sum(r.generated_tokens for r in results.values())
    ttft = [r.extras["sched"]["ttft_s"] for r in results.values()]
    emit({
        "phase": "serve_continuous", "requests": len(reqs), "completed": len(results),
        "cancelled": cancels, "joins": joins, "join_chunks": chunks, "preemptions": preempts,
        "resumes": resumes, "generated_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "ttft_p50_s": percentile(ttft, 0.5),
        "ttft_p95_s": percentile(ttft, 0.95),
        "join_chunk_stall_ms": 1e3 * sum(e["dur_s"] for e in by(flight.EV_JOIN_CHUNK)) / max(chunks, 1),
        "swap_bytes": sum(e.get("swapped_bytes", 0) for e in by(flight.EV_ROW_PREEMPTED)),
        "ms_per_session_step": 1e3 * (clock1[0] - clock0[0]) / (clock1[1] - clock0[1]),
        "max_live_rows": live, "max_admission_rows": admission_rows,
        "batch_kv_budget_bytes": eng_mod.BATCH_KV_BUDGET_BYTES,
        "max_memory_allocated_bytes": peak, "nvml_mean_w": mean_w, "counts": counts,
        "nvidia_smi": smi,
    })
    assert cancels == 1 and SERVE_CANCELLED not in results, (cancels, sorted(results))
    assert joins > 0 and chunks > 0 and preempts >= 1 and resumes >= 1, (joins, chunks, preempts, resumes)
    hold_greedy(torch, engine, tfm, ca, eng_mod, "serve_continuous_greedy", reqs, results,
                solo_rows=SERVE_SOLO_ROWS)

    # the window scheduler: generate_batch over the same engine
    small, small_gaps = serve_traffic(GenerationRequest, protocol.parse_priority, SERVE_SMALL_REQUESTS,
                                      SERVE_SEED + 1)
    small = [dataclasses.replace(r, priority=protocol.DEFAULT_PRIORITY) for r in small]
    results, _, counts, wall, mean_w, _ = drive_server(
        torch, server_mod, client_mod, engine, kernels, small, small_gaps, dev=dev,
        scheduler="window", batch_window_ms=200,
    )
    check_served(small, results, eos)
    assert all(r.extras["energy_model"]["window"] == "shared" for r in results.values())
    only(counts, ("cuda_prefill_attention", "cuda_paged_decode_attention_parts"))
    add(counts)
    tokens = sum(r.generated_tokens for r in results.values())
    emit({"phase": "serve_window", "requests": len(small), "generated_tokens": tokens, "wall_s": wall,
          "tokens_per_s": tokens / wall,
          "decode_windows": len({r.extras["decode_window"] for r in results.values()}),
          "nvml_mean_w": mean_w, "counts": counts, "nvidia_smi": smi})
    hold_greedy(torch, engine, tfm, ca, eng_mod, "serve_window_greedy", small, results)

    # no scheduler: generate and generate_stream, one at a time
    serial = [dataclasses.replace(small[i], temperature=0.0, priority=protocol.DEFAULT_PRIORITY)
              for i in (0, 1, 0)]
    results, deltas, counts, wall, mean_w, _ = drive_server(
        torch, server_mod, client_mod, engine, kernels, serial, [0.0, 0.0, 0.0], streamed=(2,), dev=dev,
    )
    check_served(serial, results, eos)
    assert deltas[2] == results[2].tokens == results[0].tokens
    only(counts, ("cuda_prefill_attention", "cuda_decode_attention"))
    add(counts)
    emit({"phase": "serve_serial", "requests": len(serial), "streamed": 1,
          "generated_tokens": sum(r.generated_tokens for r in results.values()), "wall_s": wall,
          "nvml_mean_w": mean_w, "counts": counts, "nvidia_smi": smi})
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    engine = eng_mod.TorchEngine(quantize="int8", paged_kv=True, kv_quantize="int8",
                                 registry=cut_registry())
    engine.load_model(MODEL)
    small8, gaps8 = serve_traffic(GenerationRequest, protocol.parse_priority, SERVE_SMALL_REQUESTS,
                                  SERVE_SEED + 2)
    small8 = [dataclasses.replace(r, priority=protocol.DEFAULT_PRIORITY) for r in small8]
    engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in small8[:2]])  # warm
    results, _, counts, wall, mean_w, live = drive_server(
        torch, server_mod, client_mod, engine, kernels, small8, gaps8, dev=dev,
        scheduler="continuous", prefill_chunk_tokens=SERVE_CHUNK_TOKENS,
    )
    check_served(small8, results, engine._tokenizer_for(MODEL).eos_id)
    only(counts, ("cuda_prefill_attention", "cuda_paged_decode_attention_parts_int8"))
    add(counts)
    tokens = sum(r.generated_tokens for r in results.values())
    emit({"phase": "serve_continuous_int8_kv", "requests": len(small8), "generated_tokens": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall, "max_live_rows": live,
          "nvml_mean_w": mean_w, "counts": counts, "nvidia_smi": smi})
    # the replay reads a bf16 cache: the gap also holds the int8 pool's error
    hold_greedy(torch, engine, tfm, ca, eng_mod, "serve_continuous_int8_kv_greedy", small8, results)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def contiguous_serve_phases(torch, eng_mod, kernels, smi, tfm, ca):
    """The serving phases on the contiguous layouts (the JAX package's
    ``serve`` defaults: no ``paged_kv``), qwen2:1.5b at int8 weights cut
    to SOLO_CUT_LAYERS layers:
    ``serve_continuous_contiguous`` (``serve_continuous``'s traffic over
    the contiguous session, its high-tier requests preempting rows with
    ``recompute``: their K/V dropped and re-prefilled in join chunks
    through B1; B2 decodes; every greedy row replayed teacher-forced),
    then ``serve_window_contiguous`` (8 requests through ``generate_batch``
    on an int8 contiguous cache, B3). Returns the launches."""
    import gc
    from importlib import import_module

    server_mod = import_module(f"{PKG}.serve.server")
    client_mod = import_module(f"{PKG}.serve.client")
    protocol = import_module(f"{PKG}.serve.protocol")
    flight = import_module(f"{PKG}.obs.flight")
    energy = import_module(f"{PKG}.obs.energy")
    nvml = import_module(f"{PKG}.profilers.nvml")
    GenerationRequest = import_module(f"{PKG}.engine.backend").GenerationRequest
    dev = nvml.nvml_device()
    names = {fn.__name__ for fn in kernels}
    totals = {name: 0 for name in names}

    def only(counts, ran):
        assert all(counts[k] > 0 for k in ran), counts
        assert all(counts[k] == 0 for k in names - set(ran)), counts
        for k, v in counts.items():
            totals[k] += v

    engine = eng_mod.TorchEngine(quantize="int8", registry=cut_registry())
    engine.load_model(MODEL)
    reqs, gaps = serve_traffic(GenerationRequest, protocol.parse_priority, SERVE_REQUESTS, SERVE_SEED)
    # warm: a batch, and a session with a chunked joiner and a recompute resume
    engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in reqs[:2]])
    sess = engine.decode_open([dataclasses.replace(reqs[0], max_new_tokens=8)], reserve_rows=2)
    pj = sess.join_begin(dataclasses.replace(reqs[1], max_new_tokens=8), SERVE_CHUNK_TOKENS)
    while not sess.join_step(pj):
        pass
    sess.join_commit(pj)
    sess.step(2)
    pr = sess.preempt(sess.rows[1].request, policy="recompute")
    if pr is not None:  # None only when the row already ended at an EOS
        pj = sess.resume_begin(pr, SERVE_CHUNK_TOKENS)
        while not sess.join_step(pj):
            pass
        sess.join_commit(pj)
    while sess.active:
        sess.step()
    sess.close()
    redo_tokens = energy.WASTED_TOKENS.labels(cause="recompute")
    redo_j = energy.WASTED_J.labels(cause="recompute")
    tokens0, joules0 = redo_tokens.value, redo_j.value
    flight.FLIGHT.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock0 = decode_clock(eng_mod, "contiguous")
    results, deltas, counts, wall, mean_w, live = drive_server(
        torch, server_mod, client_mod, engine, kernels, reqs, gaps, streamed=SERVE_STREAMED,
        cancelled=SERVE_CANCELLED, dev=dev, when_full=SERVE_HIGH, scheduler="continuous",
        prefill_chunk_tokens=SERVE_CHUNK_TOKENS, preempt_policy="recompute",
    )
    clock1 = decode_clock(eng_mod, "contiguous")
    peak = torch.cuda.max_memory_allocated()
    events = flight.FLIGHT.events()
    by = lambda kind, **kw: [e for e in events if e["type"] == kind  # noqa: E731
                             and all(e.get(k) == v for k, v in kw.items())]
    joins = len(by(flight.EV_REQUEST_ADMITTED, joined=True))
    chunks = len(by(flight.EV_JOIN_CHUNK))
    preempts = len(by(flight.EV_ROW_PREEMPTED, policy="recompute"))
    resumes = len(by(flight.EV_ROW_RESUMED, policy="recompute"))
    cancels = len(by(flight.EV_ROW_RETIRED, reason="cancelled"))
    eos = engine._tokenizer_for(MODEL).eos_id
    check_served(reqs, results, eos, cancelled=(SERVE_CANCELLED,))
    for i in SERVE_STREAMED:
        if i != SERVE_CANCELLED:
            assert deltas[i] == results[i].tokens, i
    only(counts, ("cuda_prefill_attention", "cuda_decode_attention"))
    tokens = sum(r.generated_tokens for r in results.values())
    ttft = [r.extras["sched"]["ttft_s"] for r in results.values()]
    emit({
        "phase": "serve_continuous_contiguous", "requests": len(reqs), "completed": len(results),
        "cancelled": cancels, "joins": joins, "join_chunks": chunks,
        "recompute_preemptions": preempts, "recompute_resumes": resumes,
        "tokens_redone": redo_tokens.value - tokens0, "redone_wasted_J": redo_j.value - joules0,
        "generated_tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_p50_s": percentile(ttft, 0.5), "ttft_p95_s": percentile(ttft, 0.95),
        "join_chunk_stall_ms": 1e3 * sum(e["dur_s"] for e in by(flight.EV_JOIN_CHUNK)) / max(chunks, 1),
        "ms_per_session_step": 1e3 * (clock1[0] - clock0[0]) / (clock1[1] - clock0[1]),
        "max_live_rows": live, "max_memory_allocated_bytes": peak, "nvml_mean_w": mean_w,
        "counts": counts, "nvidia_smi": smi,
    })
    assert cancels == 1 and SERVE_CANCELLED not in results, (cancels, sorted(results))
    assert joins > 0 and chunks > 0 and preempts >= 1 and resumes >= 1, (joins, chunks, preempts, resumes)
    assert redo_tokens.value > tokens0, "no recompute resume re-prefilled anything"
    hold_greedy(torch, engine, tfm, ca, eng_mod, "serve_continuous_contiguous_greedy", reqs, results,
                solo_rows=SERVE_SOLO_ROWS)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    engine = eng_mod.TorchEngine(quantize="int8", kv_quantize="int8", registry=cut_registry())
    engine.load_model(MODEL)
    small, small_gaps = serve_traffic(GenerationRequest, protocol.parse_priority, SERVE_SMALL_REQUESTS,
                                      SERVE_SEED + 3)
    small = [dataclasses.replace(r, priority=protocol.DEFAULT_PRIORITY) for r in small]
    engine.generate_batch([dataclasses.replace(r, max_new_tokens=4) for r in small[:2]])  # warm
    results, _, counts, wall, mean_w, _ = drive_server(
        torch, server_mod, client_mod, engine, kernels, small, small_gaps, dev=dev,
        scheduler="window", batch_window_ms=200,
    )
    check_served(small, results, engine._tokenizer_for(MODEL).eos_id)
    assert all(r.extras["energy_model"]["window"] == "shared" for r in results.values())
    only(counts, ("cuda_prefill_attention", "cuda_decode_attention_int8"))
    tokens = sum(r.generated_tokens for r in results.values())
    emit({"phase": "serve_window_contiguous", "requests": len(small), "generated_tokens": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall,
          "decode_windows": len({r.extras["decode_window"] for r in results.values()}),
          "nvml_mean_w": mean_w, "counts": counts, "nvidia_smi": smi})
    # the replay reads a bf16 cache: the gap also holds the int8 cache's error
    hold_greedy(torch, engine, tfm, ca, eng_mod, "serve_window_contiguous_greedy", small, results)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return totals


CAPSTONE_CONFIG = """from {pkg}.experiments.llm_energy import LlmEnergyConfig
from {pkg}.profilers.nvml import NvmlEnergyProfiler


class RunnerConfig(LlmEnergyConfig):
    name = "serve_cli_capstone"

    def __init__(self):
        super().__init__(
            models=[{model!r}], locations=["on_device", "remote"], lengths=[100], repetitions=1,
            cooldown_ms={cooldown}, shuffle=False, results_output_path={out!r},
            on_device_url={url!r}, remote_url={url!r},
        )
        # the card's counter, read from this client beside the serving process
        self.profilers.insert(0, NvmlEnergyProfiler())
"""
SERVER_START_S = 300  # the subprocess imports torch, loads its kernels and weights
CLI_CONTIGUOUS_REQUESTS = 3  # concurrent requests to `serve --scheduler continuous`


class ServeProcess:
    """``python -m …_tpu_torch serve --backend torch`` with ``args`` in a
    subprocess that owns the card, on a free port of 127.0.0.1, its output
    in ``log_path``. Entering waits until ``/api/tags`` answers (at most
    SERVER_START_S); leaving sends SIGTERM and keeps its exit code in
    ``rc``."""

    def __init__(self, root, log_path, args):
        self.root, self.log_path, self.args = root, log_path, list(args)
        self.rc = None

    def __enter__(self):
        import os
        import socket
        import urllib.request

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.url = f"http://127.0.0.1:{port}"
        t0 = time.perf_counter()
        with self.log_path.open("w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", PKG, "serve", "--backend", "torch", "--host", "127.0.0.1",
                 "--port", str(port), *self.args],
                cwd=str(self.root), stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": str(self.root), "PYTHONUNBUFFERED": "1"},
            )
        try:
            deadline = time.perf_counter() + SERVER_START_S
            while True:
                assert self.proc.poll() is None, self.log_path.read_text()[-4000:]
                try:
                    with urllib.request.urlopen(f"{self.url}/api/tags", timeout=5) as resp:
                        self.tags = json.loads(resp.read())
                    break
                except OSError:
                    assert time.perf_counter() < deadline, self.log_path.read_text()[-4000:]
                    time.sleep(1.0)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        self.started = time.perf_counter() - t0
        return self

    def __exit__(self, *exc):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise
        return False


def serve_cli_capstone_phase(torch, root, smi):
    """``python -m …_tpu_torch serve --backend torch`` in a subprocess that
    owns the card, then the study as a pure HTTP client of it:
    ``runner.cli.main`` over a config naming the server for both locations
    (qwen2:1.5b, 100 words, one repetition). Each row's ``backend`` is the
    URL, it has its 134 tokens, its NVML Joules are checked as the study's
    are,
    ``recompute-energy`` treats the remote rows as aliased and gives the
    modelled Joules back, and the server exits 0 on SIGTERM. Its launches
    happen in the subprocess and are not counted here."""
    import csv
    import gc
    import tempfile
    from importlib import import_module

    cli = import_module(f"{PKG}.runner.cli")
    nvml = import_module(f"{PKG}.profilers.nvml")
    client_mod = import_module(f"{PKG}.serve.client")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capstone_") as out:
        log_path = Path(out) / "serve.log"
        with ServeProcess(root, log_path, ["--models", MODEL, "--quantize", "int8"]) as server:
            url, tags, started = server.url, server.tags, server.started
            assert [m["name"] for m in tags["models"]] == [MODEL], tags
            dev = nvml.nvml_device()
            watts = []
            t_end = time.perf_counter() + STUDY_IDLE_S
            while time.perf_counter() < t_end:
                watts.append(dev.power_w())
                time.sleep(0.1)
            idle_w = sum(watts) / len(watts)
            path = Path(out) / "capstone.py"
            path.write_text(CAPSTONE_CONFIG.format(pkg=PKG, model=MODEL, cooldown=STUDY_CLI_COOLDOWN_MS,
                                                   out=out, url=url))
            assert cli.main([str(path)]) == 0
            exp = Path(out) / "serve_cli_capstone"
            with (exp / "run_table.csv").open() as f:
                rows = list(csv.DictReader(f))
            assert cli.main(["recompute-energy", str(exp)]) == 0
            with (exp / "run_table.csv").open() as f:
                again = {r["__run_id"]: r for r in csv.DictReader(f)}
        rc = server.rc
        log_tail = log_path.read_text()[-2000:]
    base = client_mod.RemoteHTTPBackend(url).base_url
    assert rc == 0, (rc, log_tail)
    assert len(rows) == 2 and all(r["__done"] == "DONE" for r in rows), rows
    worst = 0.0
    for r in rows:
        remote = r["location"] == "remote"
        assert r["backend"] == f"http:{base}" + ("[aliased-on_device]" if remote else ""), r["backend"]
        tokens = int(r["generated_tokens"])
        assert tokens == math.ceil(100 * TOKENS_PER_WORD), r
        measured_j = float(r["gpu_energy_J"])
        counter_w, sampled_w = measured_j / float(r["execution_time_s"]), float(r["gpu_avg_power_W"])
        assert abs(counter_w - sampled_w) <= STUDY_POWER_AGREEMENT * sampled_w, (counter_w, sampled_w, r)
        assert min(counter_w, sampled_w) > (1 - STUDY_IDLE_MARGIN) * idle_w, (counter_w, sampled_w, idle_w)
        redone = again[r["__run_id"]]
        assert (redone["remote_modeled_decode_s"] != "") == remote, redone
        rel = abs(float(redone["energy_model_J"]) - float(r["energy_model_J"])) / float(r["energy_model_J"])
        worst = max(worst, rel)
        assert rel <= RECOMPUTE_RTOL, (r["__run_id"], rel)
        emit({
            "phase": "serve_cli_capstone_row", "location": r["location"], "backend": r["backend"],
            "generated_tokens": tokens, "request_s": float(r["execution_time_s"]),
            "gpu_energy_J": measured_j, "counter_W": counter_w, "nvml_W": sampled_w,
            "energy_model_J": float(r["energy_model_J"]),
            "remote_modeled_decode_s": r["remote_modeled_decode_s"], "nvml_idle_w": idle_w,
            "nvidia_smi": smi,
        })
    emit({"phase": "serve_cli_capstone", "server_start_s": started, "server_exit_code": rc,
          "recompute_max_rel_change": worst, "seconds": time.perf_counter() - t0})


def serve_cli_contiguous_phase(torch, root, smi):
    """``serve --backend torch --scheduler continuous --preempt-policy
    recompute`` from the command line with the JAX package's defaults (no
    ``--paged-kv``: the contiguous session), in a subprocess that owns
    the card: CLI_CONTIGUOUS_REQUESTS concurrent greedy requests through
    the port's HTTP client, each answered in full by the continuous
    scheduler, then SIGTERM and exit 0. Its launches happen in the
    subprocess and are not counted here."""
    import gc
    import tempfile
    import threading
    from importlib import import_module

    client_mod = import_module(f"{PKG}.serve.client")
    GenerationRequest = import_module(f"{PKG}.engine.backend").GenerationRequest
    gc.collect()
    torch.cuda.empty_cache()
    reqs = [GenerationRequest(MODEL, context_prompt(n), 64, stop_at_eos=False)
            for n in (100, 300, 600)[:CLI_CONTIGUOUS_REQUESTS]]
    results = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_contiguous_") as out:
        log_path = Path(out) / "serve.log"
        args = ["--models", MODEL, "--quantize", "int8", "--scheduler", "continuous",
                "--preempt-policy", "recompute"]
        with ServeProcess(root, log_path, args) as server:
            client = client_mod.RemoteHTTPBackend(server.url)
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, client.generate(reqs[i])))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        log_tail = log_path.read_text()[-2000:]
    assert server.rc == 0, (server.rc, log_tail)
    assert sorted(results) == list(range(len(reqs))), (sorted(results), log_tail)
    for i, res in results.items():
        assert res.generated_tokens == len(res.tokens) >= 1, (i, res)
        assert "sched" in (res.extras or {}), (i, res.extras)
    emit({"phase": "serve_cli_contiguous", "args": args, "server_start_s": server.started,
          "requests": len(reqs), "generated_tokens": [r.generated_tokens for _, r in sorted(results.items())],
          "server_exit_code": server.rc, "seconds": time.perf_counter() - t0, "nvidia_smi": smi})


# The solo prefix cache: turn 1 is exactly one prefill chunk, turn 2 that
# prompt plus PREFIX_TAIL_TOKENS, answered in PREFIX_NEW_TOKENS tokens.
PREFIX_TAIL_TOKENS = 64
PREFIX_NEW_TOKENS = 128


def prefix_tail(k: int = 0) -> str:
    """PREFIX_TAIL_TOKENS characters (byte-tokenizer tokens), distinct per k."""
    return (f" Question {k}: how do the dark reactions fix carbon dioxide? " * 3)[:PREFIX_TAIL_TOKENS]


def prefix_cache_phase(torch, eng_mod, kernels, GenerationRequest, smi):
    """The solo prompt-prefix KV cache on qwen2:1.5b at int8 weights, full
    width, cut to SOLO_CUT_LAYERS layers: turn 1 is a prompt of exactly one prefill chunk
    (``PREFILL_CHUNK`` tokens), turn 2 that prompt plus PREFIX_TAIL_TOKENS.
    Turn 2 runs cold (no cache: chunk (0, 2048), then a 64-token bucket at
    offset 2048) and with a hit (the cached 2,048 positions copied in, then
    the same 64-token bucket at offset 2048): the greedy tokens must be
    equal token for token, and B1 launches n_layers × 2 cold and n_layers
    on a hit. (A ``torch.profiler`` trace of a one-token turn counted the
    same ``prefill_mma_kernel`` device kernels, 28 and 56, in a call of
    these phases alone; in the whole script the same trace lost its
    leading records five times running, so the script does not take it.)
    Over a bf16 and an int8 decode cache (the cache stores the bf16
    prefill either way). Then a byte cap below two entries evicts the
    older. Returns the launches."""
    import gc

    chunk = eng_mod.PREFILL_CHUNK
    turn1 = context_prompt(chunk)
    turn2 = turn1 + prefix_tail()
    totals = {fn.__name__: 0 for fn in kernels}
    params = None
    for kv in (None, "int8"):
        phase = "engine_prefix_cache" + ("_int8_kv" if kv else "")
        warm = eng_mod.TorchEngine(quantize="int8", kv_quantize=kv, prefix_cache_size=4,
                                   registry=cut_registry())
        if params is None:
            warm.load_model(MODEL)
            params = warm._models[MODEL].params
        else:
            warm.install_model(MODEL, warm.registry[MODEL], params)
        cold = eng_mod.TorchEngine(quantize="int8", kv_quantize=kv, registry=cut_registry())
        cold.install_model(MODEL, warm.registry[MODEL], params)  # the same tensors
        cfg = warm._models[MODEL].cfg
        tok = warm._tokenizer_for(MODEL)
        ids1, ids2 = tok.encode(turn1), tok.encode(turn2)
        assert len(ids1) == chunk and len(ids2) == chunk + PREFIX_TAIL_TOKENS and ids2[:chunk] == ids1
        for eng in (warm, cold):  # allocator and library state, outside the timed turns
            eng.generate(GenerationRequest(MODEL, "warm up the engine", 8, stop_at_eos=False))
        warm.generate(GenerationRequest(MODEL, turn1, 16, stop_at_eos=False))
        assert tuple(ids1) in warm._prefix_cache[MODEL]
        req = GenerationRequest(MODEL, turn2, PREFIX_NEW_TOKENS, stop_at_eos=False)
        res_cold, c_cold = count_launches(kernels, lambda: cold.generate(req))
        res_hit, c_hit = count_launches(kernels, lambda: warm.generate(req))
        hits = warm._prefix_hits
        decode = "cuda_decode_attention_int8" if kv else "cuda_decode_attention"
        steps = PREFIX_NEW_TOKENS - 1
        expected_cold = {fn.__name__: 0 for fn in kernels}
        expected_cold.update({"cuda_prefill_attention": 2 * cfg.n_layers, decode: cfg.n_layers * steps})
        expected_hit = dict(expected_cold, cuda_prefill_attention=cfg.n_layers)
        equal = res_hit.tokens == res_cold.tokens
        b1_repeat = None
        if not equal:
            b1_repeat = b1_repeat_bit_equal(torch, cold, eng_mod, ids2)
        emit({
            "phase": phase, "prompt_tokens": res_hit.prompt_tokens, "cached_tokens": chunk,
            "generated_tokens": res_hit.generated_tokens, "tokens_equal": equal,
            "prefill_s_cold": res_cold.prefill_s, "prefill_s_hit": res_hit.prefill_s,
            "decode_s_cold": res_cold.decode_s, "decode_s_hit": res_hit.decode_s,
            "hits": hits, "entries": len(warm._prefix_cache[MODEL]),
            "prefix_bytes": warm._prefix_bytes(), "counts_cold": c_cold, "counts_hit": c_hit,
            "b1_repeat_bit_equal": b1_repeat, "nvidia_smi": smi,
        })
        assert equal, (phase, b1_repeat, res_hit.tokens[:16], res_cold.tokens[:16])
        assert hits == 1, hits
        assert c_cold == expected_cold, (c_cold, expected_cold)
        assert c_hit == expected_hit, (c_hit, expected_hit)
        for counts in (c_cold, c_hit):
            for k, v in counts.items():
                totals[k] += v
        del warm, cold
        gc.collect()
    # The byte cap: below two turn-1-sized entries, the second evicts the first.
    eng = eng_mod.TorchEngine(quantize="int8", prefix_cache_bytes=1 << 40, registry=cut_registry())
    eng.install_model(MODEL, eng.registry[MODEL], params)
    other = ("Background: " + "the Calvin cycle builds sugars from carbon dioxide. " * 60)[: chunk - 1]
    eng.generate(GenerationRequest(MODEL, turn1, 4, stop_at_eos=False))
    one = eng._prefix_bytes()
    eng.prefix_cache_bytes = int(1.5 * one)
    eng.generate(GenerationRequest(MODEL, other, 4, stop_at_eos=False))
    kept = list(eng._prefix_cache[MODEL])
    emit({"phase": "engine_prefix_cache_eviction", "entry_bytes": one, "cap_bytes": eng.prefix_cache_bytes,
          "entries_after": len(kept), "bytes_after": eng._prefix_bytes(), "nvidia_smi": smi})
    assert kept == [tuple(eng._tokenizer_for(MODEL).encode(other))], len(kept)
    assert eng._prefix_bytes() <= eng.prefix_cache_bytes
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def b1_repeat_bit_equal(torch, engine, eng_mod, ids):
    """B1 twice on the same inputs (the tail chunk's shape: S 64 at offset
    2048 over layer 0's cache after a cold prefill): are the two outputs
    bit-equal? Read only when a hit's tokens differ from the cold ones."""
    from importlib import import_module

    ca = import_module(f"{PKG}.ops.cuda_attention")
    tf = engine._models[MODEL]
    cfg = tf.cfg
    _, k_cache, v_cache = engine._run_prefill(MODEL, ids, len(ids) + 64)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((1, PREFIX_TAIL_TOKENS, cfg.n_heads, cfg.d_head), generator=gen, device="cuda",
                    dtype=k_cache.dtype)
    outs = [ca.cuda_prefill_attention(q, k_cache[0], v_cache[0], len(ids) - PREFIX_TAIL_TOKENS)
            for _ in range(2)]
    return bool(torch.equal(outs[0], outs[1]))


def hf_state_dict(params, cfg):
    """The port's params under HF's tensor names and [out, in] layout (the
    inverse of ``models/convert.py``; a tied model writes no lm_head)."""
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = params["attn_norm"][i]
        sd[f"{p}.post_attention_layernorm.weight"] = params["mlp_norm"][i]
        for leaf, proj in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            sd[f"{p}.self_attn.{proj}.weight"] = params[leaf][i].T
        if cfg.qkv_bias:
            for leaf, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                sd[f"{p}.self_attn.{proj}.bias"] = params[leaf][i]
        for leaf, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
            sd[f"{p}.mlp.{proj}.weight"] = params[leaf][i].T
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = params["lm_head"].T
    return sd


def same_leaves(torch, got, want):
    """The names of the leaves (quantized parts included) that differ in
    dtype, shape or any bit."""
    bad = [] if sorted(got) == sorted(want) else ["<names>"]
    for name, leaf in want.items():
        if name not in got:
            continue
        parts = leaf.items() if isinstance(leaf, dict) else [("", leaf)]
        for sub, t in parts:
            g = got[name][sub] if sub else got[name]
            if g.dtype != t.dtype or g.shape != t.shape or not torch.equal(g, t):
                bad.append(f"{name}.{sub}" if sub else name)
    return bad


HF_SEED = 21
HF_SERVE_PROMPT_TOKENS = 1024
HF_SERVE_NEW_TOKENS = 64


def hf_checkpoint_phases(torch, root, eng_mod, kernels, GenerationRequest, smi):
    """Weights from a local checkpoint: qwen2:1.5b's params at full width
    and depth, drawn from a seed at bf16, written under HF's tensor names
    (``hf_state_dict``) as one safetensors file by the port's own writer
    into a temporary directory. ``TorchEngine(hf_checkpoints=...,
    weight_cache_dir=...)`` loads it at int8 twice: cold (read, converted
    and quantized on the CPU, moved to the card, and written to the weight
    cache) and warm (read back from the cache). Every leaf of both must
    equal the same params quantized on the install path (on the card),
    bit for bit, and the greedy tokens must be equal; the load seconds and
    the bytes on disk are printed. Then ``serve --backend torch
    --hf qwen2:1.5b=<dir> --prefix-cache 4`` in a subprocess: 3 requests,
    the second and third extending the first's prompt, two prefix hits in
    ``GET /debug/state``, exit 0 on SIGTERM. The directory goes at the
    end. Returns the launches."""
    import gc
    import os
    import shutil
    import tempfile
    import urllib.request
    from importlib import import_module

    ckpt = import_module(f"{PKG}.engine.checkpoint")
    tfm = import_module(f"{PKG}.models.transformer")
    client_mod = import_module(f"{PKG}.serve.client")
    totals = {fn.__name__: 0 for fn in kernels}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_hf_"))
    try:
        cfg = import_module(f"{PKG}.models.config").get_model_config(MODEL)
        dtype = eng_mod.TorchEngine().dtype  # the engines' own: unquantized leaves compare as stored
        params = tfm.init_params(cfg, torch.Generator(device="cuda").manual_seed(HF_SEED), dtype)
        hf_dir = tmp / "qwen2-1.5b-hf"
        hf_dir.mkdir()
        t0 = time.perf_counter()
        ckpt.save_params(hf_state_dict(params, cfg), hf_dir / "model.safetensors")
        write_s = time.perf_counter() - t0
        installed = eng_mod.TorchEngine(quantize="int8")
        installed.install_model(MODEL, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # the first load converts, quantizes on the CPU and writes the weight
        # cache (cold); a second engine reads the cache back (warm)
        cache_dir = tmp / "weight_cache"
        engines, load = {}, {}
        for turn in ("cold", "warm"):
            engines[turn] = eng_mod.TorchEngine(quantize="int8", hf_checkpoints={MODEL: str(hf_dir)},
                                                weight_cache_dir=str(cache_dir))
            t0 = time.perf_counter()
            engines[turn].load_model(MODEL)
            load[turn] = time.perf_counter() - t0
        engine = engines["cold"]
        bad = same_leaves(torch, engine._models[MODEL].params, installed._models[MODEL].params)
        cached_bad = same_leaves(torch, engines["warm"]._models[MODEL].params, engine._models[MODEL].params)
        on_card = {t.device.type for e in engines.values() for leaf in e._models[MODEL].params.values()
                   for t in (leaf.values() if isinstance(leaf, dict) else [leaf])} == {engine.device.type}
        del engines
        cache_files = sorted(cache_dir.glob("*.safetensors"))
        req = study_requests(GenerationRequest)[0]
        engine.warmup(req)
        res, counts = count_launches(kernels, lambda: engine.generate(req))
        want = installed.generate(req)
        expected = {fn.__name__: 0 for fn in kernels}
        expected.update({"cuda_prefill_attention": cfg.n_layers,
                         "cuda_decode_attention": cfg.n_layers * (len(res.tokens) - 1)})
        emit({
            "phase": "engine_hf_checkpoint", "checkpoint_bytes": (hf_dir / "model.safetensors").stat().st_size,
            "write_s": write_s, "cold_load_s": load["cold"], "warm_load_s": load["warm"],
            "leaves": len(engine._models[MODEL].params), "leaves_differing": bad,
            "cached_leaves_differing": cached_bad, "params_on_card": on_card,
            "tokens_equal": res.tokens == want.tokens, "generated_tokens": res.generated_tokens,
            "counts": counts, "expected": expected, "weight_cache_files": len(cache_files),
            "weight_cache_bytes": sum(f.stat().st_size for f in cache_files), "nvidia_smi": smi,
        })
        assert not bad and not cached_bad and on_card, (bad, cached_bad, on_card)
        assert res.tokens == want.tokens
        assert counts == expected, (counts, expected)
        assert len(cache_files) == 1, cache_files
        for k, v in counts.items():
            totals[k] += v
        del engine, installed
        gc.collect()
        torch.cuda.empty_cache()

        # serve --hf --prefix-cache from the command line
        base = context_prompt(HF_SERVE_PROMPT_TOKENS)
        prompts = [base, base + prefix_tail(1), base + prefix_tail(1) + prefix_tail(2)]
        log_path = tmp / "serve.log"
        args = ["--models", MODEL, "--quantize", "int8", "--hf", f"{MODEL}={hf_dir}", "--prefix-cache", "4"]
        t0 = time.perf_counter()
        with ServeProcess(root, log_path, args) as server:
            client = client_mod.RemoteHTTPBackend(server.url)
            served = [client.generate(GenerationRequest(MODEL, p, HF_SERVE_NEW_TOKENS, stop_at_eos=False))
                      for p in prompts]
            with urllib.request.urlopen(f"{server.url}/debug/state", timeout=30) as resp:
                state = json.loads(resp.read())
        log_tail = log_path.read_text()[-2000:]
        prefix_state = state.get("models", {}).get("prefix_cache")
        emit({
            "phase": "serve_cli_hf", "args": [a if a != f"{MODEL}={hf_dir}" else f"{MODEL}=<dir>" for a in args],
            "server_start_s": server.started, "server_exit_code": server.rc,
            "prompt_tokens": [r.prompt_tokens for r in served],
            "generated_tokens": [r.generated_tokens for r in served],
            "prefill_s": [r.prefill_s for r in served], "prefix_cache": prefix_state,
            "seconds": time.perf_counter() - t0, "nvidia_smi": smi,
        })
        assert server.rc == 0, (server.rc, log_tail)
        assert [r.generated_tokens for r in served] == [HF_SERVE_NEW_TOKENS] * 3, log_tail
        assert prefix_state is not None and prefix_state["hits"] == 2, (state.get("models"), log_tail)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not os.path.exists(tmp)
    torch.cuda.empty_cache()
    return totals


# PR 3's solo int8 step profile (scripts/torch_decode_profile.py, an
# H100 80GB HBM3 at 700 W): the card idled 0.620 of the step.
PROFILED_IDLE_SHARE = 0.620


def trace_busy_share(path):
    """Busy share of the card over a ``torch.profiler`` trace: the union
    of its kernels' intervals over the span from the first kernel's start
    to the last one's end. Kernels the trace lost count as idle."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    names = {e["name"] for e in events}
    return busy / (spans[-1][1] - spans[0][0]), len(events), names


def study_duty_trace_phase(torch, eng_mod, kernels, smi):
    """The study's two on_device rows (qwen2:1.5b at full width cut to
    SOLO_CUT_LAYERS layers, the engine passed in as ``backends``: the
    ``study`` phase runs the study's own engine at full depth; 100 words,
    two repetitions) with
    ``NvmlDutyCycleProfiler`` (the study wires it when NVML's utilization
    reads) and ``TorchTraceProfiler`` (CUDA activity)
    attached: each row's ``gpu_duty_cycle_pct`` lies in [0, 100], its
    ``energy_duty_J`` is set, and its trace names the port's kernels
    (``prefill_mma_kernel``, ``decode_tile_kernel``; names, not counts:
    a trace can lose records). The duty cycle is printed beside the busy
    share read from the row's own trace and beside 1 − PR 3's profiled
    idle share. Returns the launches."""
    import csv
    import tempfile
    from importlib import import_module

    study = import_module(f"{PKG}.experiments.llm_energy")
    controller = import_module(f"{PKG}.runner.controller")
    probe = import_module(f"{PKG}.profilers.energy_probe")
    trace_mod = import_module(f"{PKG}.profilers.torch_trace")
    from torch.profiler import ProfilerActivity

    # A process's first trace initialises CUPTI (seconds): not inside a row.
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_duty_") as out:
        config = study.LlmEnergyConfig(
            models=[MODEL], locations=["on_device"], lengths=[STUDY_WORDS[0]],
            repetitions=2, cooldown_ms=STUDY_CLI_COOLDOWN_MS, results_output_path=out,
            backends={"on_device": eng_mod.TorchEngine(quantize="int8", registry=cut_registry())},
        )
        assert isinstance(config.profilers[0], probe.NvmlDutyCycleProfiler), config.profilers
        config.profilers.append(trace_mod.TorchTraceProfiler(activities=[ProfilerActivity.CUDA]))
        ctl = controller.ExperimentController(config, echo=False)
        _, counts = count_launches(kernels, ctl.do_experiment)
        exp = Path(out) / config.name
        with (exp / "run_table.csv").open() as f:
            rows = list(csv.DictReader(f))
        channels = json.loads((exp / "energy_channels.json").read_text())["channels"]
        results = []
        for r in rows:
            t1 = time.perf_counter()
            path = Path(r["trace_dir"]) / "trace.json"
            busy, n_kernels, names = trace_busy_share(path)
            results.append((r, busy, n_kernels, names, path.stat().st_size, time.perf_counter() - t1))
        del config, ctl
    assert [c["available"] for c in channels if c["name"] == "nvml_utilization"] == [True], channels
    assert len(rows) == 2 and all(r["__done"] == "DONE" for r in rows), rows
    for r, busy, n_kernels, names, trace_bytes, parse_s in results:
        duty = float(r["gpu_duty_cycle_pct"])
        emit({
            "phase": "study_duty_trace_row", "run": r["__run_id"], "generated_tokens": int(r["generated_tokens"]),
            "execution_time_s": float(r["execution_time_s"]), "gpu_duty_cycle_pct": duty,
            "energy_duty_J": float(r["energy_duty_J"]), "gpu_energy_J": float(r["gpu_energy_J"]),
            "energy_model_J": float(r["energy_model_J"]), "trace_busy_share": busy,
            "trace_kernels": n_kernels, "trace_bytes": trace_bytes, "trace_parse_s": parse_s,
            "profiled_busy_share": 1 - PROFILED_IDLE_SHARE,
            "names_port_kernels": sorted(n for n in names if "prefill_mma" in n or "decode_tile" in n)[:4],
            "nvidia_smi": smi,
        })
        assert 0.0 <= duty <= 100.0 and float(r["energy_duty_J"]) > 0, r
        assert any("prefill_mma_kernel" in n for n in names), sorted(names)[:20]
        assert any("decode_tile_kernel" in n for n in names), sorted(names)[:20]
    emit({"phase": "study_duty_trace", "counts": counts, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    return counts


def mixed_quant_phase(engine, GenerationRequest, kernels, chunks_of, params_nbytes):
    """One engine with per-model modes (qwen2:1.5b at int8, by default
    int4): each model generates the study's 134-token request; the int4
    kernel runs in the int4 model's decode forwards only."""
    all_counts = {}
    for model in (MODEL, LARGE_MODEL):
        engine.load_model(model)
        cfg = engine._models[model].cfg
        req = GenerationRequest(model, STUDY_PROMPT.format(words=STUDY_WORDS[0]),
                                math.ceil(STUDY_WORDS[0] * TOKENS_PER_WORD), stop_at_eos=False)
        engine.warmup(dataclasses.replace(req, max_new_tokens=4))
        results, counts = count_launches(kernels, lambda: [engine.generate(req)])
        check_results(engine, [req], results)
        res = results[0]
        steps = len(res.tokens) - 1
        mode = engine._quant_mode(model)
        expected = {fn.__name__: 0 for fn in kernels}
        expected["cuda_prefill_attention"] = cfg.n_layers * chunks_of(res.prompt_tokens)
        expected["cuda_decode_attention"] = cfg.n_layers * steps
        if mode == "int4":
            expected["cuda_int4_matmul"] = MATMULS_PER_LAYER * cfg.n_layers * steps
        nbytes = params_nbytes(engine._models[model].params)
        emit({
            "phase": "engine_mixed_quant", "model": model, "weights": mode,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "weight_bytes": nbytes,
            "prompt_tokens": res.prompt_tokens, "generated_tokens": res.generated_tokens,
            "prefill_s": res.prefill_s, "decode_s": res.decode_s, "tokens_per_s": res.tokens_per_s,
            "counts": counts, "expected": expected,
        })
        assert counts == expected, (model, counts, expected)
        for name, n in counts.items():
            all_counts[name] = all_counts.get(name, 0) + n
    return all_counts


# -- the shared prefix store and live row migration ---------------------------
SHARE_ANCHOR_TOKENS = 2048
SHARE_CHUNK_TOKENS = 256
SHARE_NEW_TOKENS = 64
# Two 2,048-token openers size the session's pool (pow2(2·(32 + 1)) = 128
# pages): the cold run's six joined rows need 82 of them beside the
# openers' 32 (78 for the anchor and its four sharers, 28 when shared).
SHARE_OPENERS = 2
# (prompt tokens shared with the anchor, own tail tokens): whole pages and
# whole chunks first, then one divergence mid-page (a copy on write)
SHARE_JOINERS = ((1536, 512), (1792, 256), (1536, 256))
SHARE_MIDPAGE = (1600, 400)
# a prompt of its own: it shares BOS alone, the one-token hit every joiner
# of a live store takes, and its chunks start at position 1
SHARE_NATURAL = (1, 512)
SPILL_PREFIX_TOKENS = 1024
MIGRATE_PROMPT_TOKENS = (900, 930, 960, 990, 1000)  # 8 pages each, as the anchor's
MIGRATE_NEW_TOKENS = 64
MIGRATE_SAMPLED = 4  # the one sampled request
EVAC_NEW_TOKENS = 128
EVAC_JOINER_TOKENS = (700, 800, 900)
CLI_SHARE_SYSTEM_TOKENS = 1024
CLI_SHARE_REQUESTS = 8
CLI_SHARE_HBM_BYTES = 256 << 20


def share_text(n_tokens: int, tag: str) -> str:
    """Prompt text of ``n_tokens`` byte-tokenizer tokens (BOS included)
    built from ``tag``'s sentence: each tag gives other bytes."""
    sentence = f"{tag}: the dark reactions fix carbon dioxide into sugars. "
    return (sentence * (n_tokens // len(sentence) + 1))[: n_tokens - 1]


def share_joiner(anchor: str, shared: int, tail: int, k: int) -> str:
    """The anchor's first ``shared`` tokens, then ``tail`` tokens of its
    own (the first of them differs from the anchor's next byte)."""
    own = share_text(tail + 1, f"{'QRSTUVW'[k]} tail question")
    assert own[0] != anchor[shared - 1]
    return anchor[: shared - 1] + own


def ran_only(counts, per_layer, exact=()):
    """The path launched each kernel of ``per_layer`` ({name: layers}) a
    whole number of times a layer, at least once, those of ``exact``
    ({name: launches}) that many times, and no other kernel."""
    for name, n in counts.items():
        layers = per_layer.get(name)
        assert (n == 0) if layers is None else (n > 0 and n % layers == 0), (name, counts)
    for name, n in dict(exact).items():
        assert counts[name] == n, (name, n, counts)


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def chunked_join(torch, session, request):
    """``join_begin`` in SHARE_CHUNK_TOKENS chunks through ``join_commit``:
    (pending, wall seconds)."""
    def run():
        pending = session.join_begin(request, chunk_tokens=SHARE_CHUNK_TOKENS)
        while not session.join_step(pending):
            pass
        session.join_commit(pending)
        return pending

    return timed(torch, run)


def prefix_share_paged_phase(torch, eng_mod, kernels, GenerationRequest, smi, tfm, ca):
    """The shared prefix store on the bf16 pool, qwen2:1.5b at int8 weights,
    full width, cut to SOLO_CUT_LAYERS layers (``serve_cli_prefix_share``
    runs the store at full depth). Two openers, then an anchor of
    SHARE_ANCHOR_TOKENS tokens by a chunked join (256-token chunks), then
    five joiners: three share its first 1,536 or 1,792 tokens (whole
    pages and whole chunks) and diverge in 256–512-token tails, one
    diverges mid-page, so its join copies a page on write, and one shares
    BOS alone (the hit every joiner of a live store takes). The same
    schedule runs cold, on an engine without ``prefix_share`` over the
    same weights. Each chunk-aligned joiner's greedy tokens equal its cold
    twin's; the mid-page and the BOS joiners, whose chunks lie otherwise
    than their twins', are replayed teacher-forced (LOGIT_ATOL), their
    share of equal tokens printed. B1 runs once a layer for each
    prefill forward and join chunk, and a hit's join runs only its tail's
    chunks. Returns the shared run's launches."""
    import gc

    from importlib import import_module

    prefix = import_module(f"{PKG}.engine.prefix")
    share = eng_mod.TorchEngine(quantize="int8", paged_kv=True, prefix_share=True, registry=cut_registry())
    share.load_model(MODEL)
    params = share._models[MODEL].params
    cold = eng_mod.TorchEngine(quantize="int8", paged_kv=True)
    cold.install_model(MODEL, share.registry[MODEL], params)  # the same tensors
    n_layers = share._models[MODEL].cfg.n_layers
    b1 = next(fn for fn in kernels if fn.__name__ == "cuda_prefill_attention")
    anchor_text = context_prompt(SHARE_ANCHOR_TOKENS)
    openers = [GenerationRequest(MODEL, share_text(SHARE_ANCHOR_TOKENS, f"Opener {i}"), SHARE_NEW_TOKENS,
                                 stop_at_eos=False) for i in range(SHARE_OPENERS)]
    anchor = GenerationRequest(MODEL, anchor_text, SHARE_NEW_TOKENS, stop_at_eos=False)
    shapes = (*SHARE_JOINERS, SHARE_MIDPAGE, SHARE_NATURAL)
    joiners = [GenerationRequest(MODEL, share_joiner(anchor_text, s, t, k), SHARE_NEW_TOKENS,
                                 stop_at_eos=False)
               for k, (s, t) in enumerate(shapes)]
    publish_ms = []
    store = share.prefix_store
    publish = store.publish

    def timed_publish(model, ids, *args, **kwargs):
        out, dt = timed(torch, lambda: publish(model, ids, *args, **kwargs))
        publish_ms.append((len(ids), dt * 1e3))
        return out

    store.publish = timed_publish
    for eng in (share, cold):  # allocator and library state, outside the timed runs
        eng.generate(GenerationRequest(MODEL, "warm up the engine", 8, stop_at_eos=False))

    def schedule(engine):
        session = engine.decode_open(openers, reserve_rows=1 + len(joiners) + SHARE_OPENERS)
        if engine is share:
            # The openers only size the pool: their nodes leave the store,
            # so that the anchor's join does not hit their one shared token
            # (BOS), which would seed position 0 and move its chunks by one
            # against the cold run's.
            store.release_all()
        session.step(8)
        rec = {"anchor": chunked_join(torch, session, anchor)}
        session.step(8)
        for k, joiner in enumerate(joiners):
            b0 = b1.launches
            rec[k] = (*chunked_join(torch, session, joiner), b1.launches - b0)
        five = (anchor, *joiners[: len(SHARE_JOINERS) + 1])  # the anchor's sharers
        live = [row for row in session.rows if row is not None and row.request in five]
        pages = sorted(p for row in live for p in row.pages)
        rec["pages"] = {"held": len(set(pages)), "mapped": len(pages),
                        "pool": session.pool.n_pages, "store": store.hbm_pages_held if engine is share else 0}
        out = drain(session)
        session.close()
        rec["results"] = {r.request.prompt: r for r in out}
        return rec

    counters0 = (prefix.PREFIX_HIT_TOKENS_C.labels().value, prefix.PREFIX_COW_COPIES_C.labels().value)
    cold_rec = schedule(cold)
    hit_rec, counts = count_launches(kernels, lambda: schedule(share))
    hit_tokens = prefix.PREFIX_HIT_TOKENS_C.labels().value - counters0[0]
    cow = prefix.PREFIX_COW_COPIES_C.labels().value - counters0[1]
    store.publish = publish
    rows, equal = [], {}
    for k, joiner in enumerate(joiners):
        pend, wall, b1_hit = hit_rec[k]
        cpend, cwall, b1_cold = cold_rec[k]
        got = hit_rec["results"][joiner.prompt].tokens
        want = cold_rec["results"][joiner.prompt].tokens
        aligned = k < len(SHARE_JOINERS)
        row = {"shared_tokens": shapes[k][0], "tail_tokens": len(pend.ids) - shapes[k][0],
            "hit_tokens": pend.hit_tokens, "shared_pages": pend.shared_pages,
            "b1_launches_hit": b1_hit, "b1_launches_cold": b1_cold,
            "join_ms_hit": wall * 1e3, "join_ms_cold": cwall * 1e3,
            "tail_chunks": len(pend.chunks), "cold_chunks": len(cpend.chunks)}
        assert pend.hit_tokens >= shapes[k][0] and pend.shared_pages == pend.hit_tokens // PAGE, row
        assert b1_hit == n_layers * len(pend.chunks) and b1_cold == n_layers * len(cpend.chunks), row
        if aligned:
            equal[k] = got == want
            row["tokens_equal_cold"] = equal[k]
        else:
            row["max_logit_gap"] = replay_gap(torch, share, tfm, ca, eng_mod, joiner, got)
            row["share_equal_cold"] = sum(a == b for a, b in zip(got, want)) / max(len(got), len(want))
        rows.append(row)
    # the openers (one chunk each, one bucket) prefill in one grouped forward
    expected_b1 = n_layers * (1 + len(hit_rec["anchor"][0].chunks)
                              + sum(len(hit_rec[k][0].chunks) for k in range(len(joiners))))
    emit({
        "phase": "engine_prefix_share_paged", "layers": n_layers, "joiners": rows,
        "anchor_tokens_equal_cold": hit_rec["results"][anchor.prompt].tokens
        == cold_rec["results"][anchor.prompt].tokens,
        "hit_tokens_total": hit_tokens, "cow_copies": cow,
        "pages_five_rows_shared": hit_rec["pages"], "pages_five_rows_cold": cold_rec["pages"],
        "publish_ms": publish_ms, "anchor_join_ms": hit_rec["anchor"][1] * 1e3,
        "store": store.debug_state(), "counts": counts, "nvidia_smi": smi,
    })
    assert all(equal.values()), equal
    assert all(row["max_logit_gap"] <= LOGIT_ATOL for row in rows[len(SHARE_JOINERS):]), rows
    # the store is empty when the anchor joins; the mid-page and the BOS
    # joiners each copy a page on write
    assert cow == 2 and hit_tokens == sum(r["hit_tokens"] for r in rows), (cow, hit_tokens)
    assert rows[-1]["hit_tokens"] == 1, rows[-1]
    assert counts["cuda_prefill_attention"] == expected_b1, (counts, expected_b1)
    parts = counts["cuda_paged_decode_attention_parts"]
    assert parts > 0 and parts % n_layers == 0, counts
    assert all(n == 0 for name, n in counts.items()
               if name not in ("cuda_prefill_attention", "cuda_paged_decode_attention_parts")), counts
    store.release_all()
    del share, cold, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def prefix_share_spill_phase(torch, eng_mod, kernels, GenerationRequest, smi):
    """The store's budgets and seed-only reuse, qwen2:1.5b at int8 weights
    cut to SOLO_CUT_LAYERS layers. On an int8 pool with a device budget
    that holds one SPILL_PREFIX_TOKENS-token node: a joiner publishes it and
    retires, a second joiner's publication spills it to host memory, and a
    third joiner that shares it restores it (``llm_prefix_store_restores``)
    and gives the cold join's tokens. Then on the contiguous session (no
    pool): a joiner sharing a published prefix seeds its private cache
    from the slab (seed-only reuse) and gives the cold join's tokens.
    Returns the launches of the two shared runs."""
    import gc

    from importlib import import_module

    store_mod = import_module(f"{PKG}.engine.radix_store")
    totals = {fn.__name__: 0 for fn in kernels}
    params = None
    first = share_text(SPILL_PREFIX_TOKENS + 1, "Spilled prefix")[:SPILL_PREFIX_TOKENS - 1]
    opener = GenerationRequest(MODEL, share_text(SHARE_ANCHOR_TOKENS, "Opener"), EVAC_NEW_TOKENS,
                               stop_at_eos=False)
    publisher = GenerationRequest(MODEL, first, 8, stop_at_eos=False)
    other = GenerationRequest(MODEL, share_text(512, "Another prefix"), 32, stop_at_eos=False)
    sharer = GenerationRequest(MODEL, first + share_text(257, "#restored tail"), 32, stop_at_eos=False)
    for layout, kv in (("paged", "int8"), ("contiguous", None)):
        kw = dict(quantize="int8", paged_kv=layout == "paged", kv_quantize=kv, registry=cut_registry())
        share = eng_mod.TorchEngine(prefix_share=True, **kw)
        if params is None:
            share.load_model(MODEL)
            params = share._models[MODEL].params
        else:
            share.install_model(MODEL, share.registry[MODEL], params)
        cold = eng_mod.TorchEngine(**kw)
        cold.install_model(MODEL, share.registry[MODEL], params)
        store = share.prefix_store
        node_bytes = None

        def schedule(engine):
            nonlocal node_bytes
            session = engine.decode_open([opener], reserve_rows=4)
            if engine is share:
                store.release_all()  # as in prefix_share_paged_phase: no BOS hit for the publisher
            out = []
            if layout == "paged" and engine is share:
                node_bytes = (SPILL_PREFIX_TOKENS // PAGE) * (
                    session.pool.payload_nbytes() // session.pool.n_pages)
                store.hbm_bytes = node_bytes  # the device budget holds one such node
            chunked_join(torch, session, publisher)
            while any(row is not None and row.request is publisher for row in session.rows):
                out += session.step(8)
            if layout == "paged":
                chunked_join(torch, session, other)  # its publication spills the cold node
            pending, _ = chunked_join(torch, session, sharer)
            out += drain(session)
            session.close()
            return pending, {r.request.prompt: r for r in out}

        _, want = schedule(cold)
        spills0 = store_mod.STORE_SPILLS_C.labels().value
        restores0 = store_mod.STORE_RESTORES_C.labels().value
        (pending, got), counts = count_launches(kernels, lambda: schedule(share))
        line = {
            "phase": "engine_prefix_share_spill", "layout": layout, "kv": kv or "bf16",
            "layers": SOLO_CUT_LAYERS, "hit_tokens": pending.hit_tokens, "shared_pages": pending.shared_pages,
            "spills": store_mod.STORE_SPILLS_C.labels().value - spills0,
            "restores": store_mod.STORE_RESTORES_C.labels().value - restores0,
            "hbm_budget_bytes": node_bytes, "store": store.debug_state(),
            "tokens_equal_cold": got[sharer.prompt].tokens == want[sharer.prompt].tokens,
            "counts": counts, "nvidia_smi": smi,
        }
        emit(line)
        assert line["tokens_equal_cold"], line
        assert pending.hit_tokens >= SPILL_PREFIX_TOKENS - 1, line
        decode = "cuda_paged_decode_attention_parts_int8" if layout == "paged" else "cuda_decode_attention"
        if layout == "paged":
            assert line["spills"] >= 1 and line["restores"] >= 1, line
        else:
            assert pending.shared_pages == 0 and line["store"]["hbm_pages"] == 0, line
        ran_only(counts, {"cuda_prefill_attention": SOLO_CUT_LAYERS, decode: SOLO_CUT_LAYERS})
        for name, n in counts.items():
            totals[name] += n
        store.release_all()
        del share, cold
        gc.collect()
    del params
    torch.cuda.empty_cache()
    return totals


def collect_stream(chunks):
    """(tokens, final result) of a client's chunk iterator."""
    toks, final = [], None
    for ch in chunks:
        if ch.done:
            final = ch.result
        else:
            toks.extend(ch.tokens)
    return toks, final


def wait_until(cond, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def stream_thread(fn, out, key):
    """Consume the chunk iterator ``fn()`` on a thread into ``out[key]``:
    ``{"tokens", "final", "t_first", "error"}``, filled as chunks arrive."""
    import threading

    rec = out[key] = {"tokens": [], "final": None, "t_first": None, "error": None}

    def run():
        try:
            for ch in fn():
                if ch.done:
                    rec["final"] = ch.result
                elif ch.tokens:
                    if rec["t_first"] is None:
                        rec["t_first"] = time.perf_counter()
                    rec["tokens"].extend(ch.tokens)
        except BaseException as exc:  # noqa: BLE001 — the caller reads it
            rec["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def joined(threads, out):
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a stream did not end"
    for key, rec in out.items():
        assert rec["error"] is None and rec["final"] is not None, (key[:40], rec["error"])
    return out


def migration_joules(url):
    """The wasted-energy ledger's ``cause="migration"`` Joules, read from
    a server's ``/metrics``."""
    import re
    import urllib.request

    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    found = re.findall(r'^llm_request_wasted_joules_total\{cause="migration"\} (\S+)$', text, re.M)
    return float(found[0]) if found else 0.0


def serve_migrate_phase(torch, eng_mod, kernels, smi):
    """Live row migration between in-process ``GenerationServer``s on
    127.0.0.1 (the continuous scheduler over the bf16 pool, qwen2:1.5b at
    int8 weights cut to SOLO_CUT_LAYERS layers). Each request is first
    served alone on a third server: the reference. A bundle sent to the
    ``role="decode"`` server while it has no live row fails (a real
    engine opens a session on a first request). Then, with an anchor
    stream open there, a ``role="prefill"`` server primes four greedy
    requests and one sampled (``x_prime``: the prefill, then the row
    exported as a bundle), the port's client ships each bundle to the
    decode server's ``/api/migrate``, and the row streams from there
    with the reference's tokens (the sampled row carries its generator's
    state). Then ``/admin/evacuate`` on a server with four live
    streaming rows: each bundle seats on the decode server and the rows
    finish with the tokens of the same schedule run uninterrupted on the
    third. Every session has 4 slots, and the rows of a part share their
    page span and side columns, so a row's arithmetic does not depend on
    the server that decodes it. The counts are read around the primes
    and seats (B1 once a layer for each prime's prefill, the paged parts
    kernel, nothing else) and around the evacuation and seats (the
    paged parts kernel alone: a seated row brings its K/V); the seating
    server charges each transfer, read from its ``/metrics``. Returns
    the launches of those two runs."""
    import gc
    from importlib import import_module

    server_mod = import_module(f"{PKG}.serve.server")
    client_mod = import_module(f"{PKG}.serve.client")
    migrate = import_module(f"{PKG}.serve.migrate")
    GenerationRequest = import_module(f"{PKG}.engine.backend").GenerationRequest
    j_per_byte = import_module(f"{PKG}.obs.energy").SWAP_J_PER_BYTE
    obs = import_module(f"{PKG}.obs")
    was = obs.enabled()
    obs.enable()
    engines = [eng_mod.TorchEngine(quantize="int8", paged_kv=True, registry=cut_registry()) for _ in range(3)]
    engines[0].load_model(MODEL)
    params = engines[0]._models[MODEL].params
    for eng in engines[1:]:
        eng.install_model(MODEL, eng.registry[MODEL], params)  # the same tensors
    servers = [server_mod.GenerationServer(
        eng, host="127.0.0.1", port=0, models=[MODEL], quiet=True, scheduler="continuous",
        max_batch=4, budget_aware=False, prefill_chunk_tokens=1024, role=role,
    ) for eng, role in zip(engines, ("mixed", "prefill", "decode"))]
    for srv in servers:
        srv.start()
    dec_url = f"http://127.0.0.1:{servers[2].port}"
    ref, pre, dec = (client_mod.RemoteHTTPBackend(f"http://127.0.0.1:{srv.port}") for srv in servers)
    pre_sched, dec_sched = servers[1]._scheduler, servers[2]._scheduler
    export_row, submit_migrate = pre_sched._export_row, dec_sched.submit_migrate
    export_ms, seat_mark = [], {}

    def timed_export(*a, **k):
        t0 = time.perf_counter()
        out = export_row(*a, **k)
        export_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def marked_submit(bundle):
        seat_mark[bundle["request"]["prompt"]] = time.perf_counter()
        return submit_migrate(bundle)

    pre_sched._export_row, dec_sched.submit_migrate = timed_export, marked_submit
    reqs = [GenerationRequest(MODEL, share_text(n, f"Migrant {i}"), MIGRATE_NEW_TOKENS, stop_at_eos=False,
                              seed=21 + i,
                              **({"temperature": 0.7, "top_p": 0.9} if i == MIGRATE_SAMPLED else {}))
            for i, n in enumerate(MIGRATE_PROMPT_TOKENS)]
    t_phase = time.perf_counter()
    try:
        alone = {}
        for r in reqs:  # each alone on one server: the reference
            joined([stream_thread(lambda r=r: ref.generate_stream(r), alone, r.prompt)], alone)
        want = {prompt: rec["tokens"] for prompt, rec in alone.items()}

        # the decode server has no live row: the migration fails
        idle = collect_stream(pre.generate_stream(reqs[0], prime=True))[1].extras["migrate"]
        try:
            collect_stream(dec.migrate_stream(idle))
            idle_error = None
        except client_mod.RemoteServerError as exc:
            idle_error = str(exc)
        assert idle_error and "needs at least one request" in idle_error, idle_error
        export_ms.clear()

        streams = {}
        anchor = GenerationRequest(MODEL, share_text(MIGRATE_PROMPT_TOKENS[-1], "Decode anchor"),
                                   MIGRATE_NEW_TOKENS, stop_at_eos=False)
        anchor_t = stream_thread(lambda: dec.generate_stream(anchor), streams, "anchor")
        wait_until(lambda: streams["anchor"]["tokens"])  # its prefill is done
        migrated, rows = {}, []
        j0 = migration_joules(dec_url)

        def prime_and_seat():
            threads = [anchor_t]
            for r in reqs:
                t0 = time.perf_counter()
                toks, primed = collect_stream(pre.generate_stream(r, prime=True))
                bundle = primed.extras["migrate"]
                assert toks == [] and bundle["kind"] == "real", (toks, primed.extras)
                t_post = time.perf_counter()
                threads.append(stream_thread(lambda b=bundle: dec.migrate_stream(b), migrated, r.prompt))
                rows.append({"sampled": r.temperature > 0, "prime_ms": (t_post - t0) * 1e3,
                             "bundle_bytes": migrate.bundle_nbytes(bundle),
                             "json_bytes": len(json.dumps(bundle)), "t_post": t_post})
            joined(threads, {**migrated, **streams})

        _, counts = count_launches(kernels, prime_and_seat)
        joules = migration_joules(dec_url) - j0
        for r, row, ms in zip(reqs, rows, export_ms):
            rec = migrated[r.prompt]
            t_post = row.pop("t_post")
            row.update(
                export_ms=ms, wire_ms=(seat_mark[r.prompt] - t_post) * 1e3,
                seat_to_first_token_ms=(rec["t_first"] - seat_mark[r.prompt]) * 1e3,
                migrated=rec["final"].extras["sched"].get("migrated") is True,
                tokens_equal_one_server=rec["tokens"] == want[r.prompt],
            )
        bundle_bytes = sum(row["bundle_bytes"] for row in rows)
        emit({"phase": "serve_migrate", "layers": SOLO_CUT_LAYERS, "rows": rows, "idle_receiver_error": idle_error,
              "charged_J": joules, "charged_J_expected": 2 * bundle_bytes * j_per_byte,
              "anchor_generated": len(streams["anchor"]["tokens"]), "counts": counts, "nvidia_smi": smi})
        assert all(row["tokens_equal_one_server"] and row["migrated"] for row in rows), rows
        assert abs(joules - 2 * bundle_bytes * j_per_byte) <= 1e-9 * max(1.0, joules), (joules, bundle_bytes)
        # one prefill forward a prime (a prompt in one chunk); the seats
        # prefill nothing. The anchor decodes across the count's edges, so
        # B4's count need not be a whole number of steps.
        ran_only(counts, {"cuda_prefill_attention": SOLO_CUT_LAYERS, "cuda_paged_decode_attention_parts": 1},
                 exact={"cuda_prefill_attention": SOLO_CUT_LAYERS * len(reqs)})

        # Drain evacuation: four live streaming rows (an anchor whose
        # 2,048-token prompt sizes the pool, and three joiners, one
        # sampled) leave the prefill server for the decode server, which
        # serves an anchor of the same span; the same schedule run on the
        # third server uninterrupted is the reference.
        evac = [GenerationRequest(MODEL, share_text(SHARE_ANCHOR_TOKENS, "Evacuated anchor"),
                                  EVAC_NEW_TOKENS, stop_at_eos=False)]
        evac += [GenerationRequest(MODEL, share_text(n, f"Evacuee {i}"), EVAC_NEW_TOKENS, stop_at_eos=False,
                                   seed=31 + i, **({"temperature": 0.7} if i == 1 else {}))
                 for i, n in enumerate(EVAC_JOINER_TOKENS)]

        def four_live(client, sched, out):
            threads = [stream_thread(lambda: client.generate_stream(evac[0]), out, evac[0].prompt)]
            wait_until(lambda: out[evac[0].prompt]["tokens"])  # the anchor's session is open
            threads += [stream_thread(lambda r=r: client.generate_stream(r), out, r.prompt) for r in evac[1:]]
            wait_until(lambda: sched._dbg is not None and sched._dbg[0].active == len(evac))
            return threads

        uninterrupted = {}
        joined(four_live(ref, servers[0]._scheduler, uninterrupted), uninterrupted)
        heads = {}
        threads = four_live(pre, pre_sched, heads)
        threads.append(stream_thread(
            lambda: dec.generate_stream(GenerationRequest(
                MODEL, share_text(SHARE_ANCHOR_TOKENS, "Receiving anchor"), EVAC_NEW_TOKENS,
                stop_at_eos=False)),
            streams, "receiving anchor"))
        wait_until(lambda: streams["receiving anchor"]["tokens"])  # its prefill is done
        seated, timing = {}, {}
        j0 = migration_joules(dec_url)

        def evacuate_and_seat():
            t0 = time.perf_counter()
            timing["evacuated"] = pre.evacuate(timeout_s=60)
            timing["evacuate_ms"] = (time.perf_counter() - t0) * 1e3
            joined(threads[:-1], heads)
            for r in evac:
                bundle = heads[r.prompt]["final"].extras["migrate"]
                threads.append(stream_thread(lambda b=bundle: dec.migrate_stream(b), seated, r.prompt))
            joined(threads, {**seated, **streams})

        _, evac_counts = count_launches(kernels, evacuate_and_seat)
        evac_joules = migration_joules(dec_url) - j0
        evac_rows = [{
            "sampled": r.temperature > 0, "streamed_before": len(heads[r.prompt]["tokens"]),
            "after": len(seated[r.prompt]["tokens"]),
            "bundle_bytes": migrate.bundle_nbytes(heads[r.prompt]["final"].extras["migrate"]),
            "tokens_equal_uninterrupted":
                heads[r.prompt]["tokens"] + seated[r.prompt]["tokens"] == uninterrupted[r.prompt]["tokens"],
        } for r in evac]
        evac_bytes = sum(row["bundle_bytes"] for row in evac_rows)
        emit({"phase": "serve_migrate_evacuate", "layers": SOLO_CUT_LAYERS, "evacuated": timing["evacuated"],
              "evacuate_ms": timing["evacuate_ms"], "rows": evac_rows, "charged_J": evac_joules,
              "charged_J_expected": 2 * evac_bytes * j_per_byte, "counts": evac_counts,
              "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi})
        assert timing["evacuated"] == len(evac), timing
        assert all(row["tokens_equal_uninterrupted"] for row in evac_rows), evac_rows
        assert abs(evac_joules - 2 * evac_bytes * j_per_byte) <= 1e-9 * max(1.0, evac_joules), evac_joules
        # every row was prefilled before the count: nothing prefills again
        # (and the rows decode across the count's edges)
        ran_only(evac_counts, {"cuda_paged_decode_attention_parts": 1})
    finally:
        for srv in servers:
            srv.stop()
        (obs.enable if was else obs.disable)()
    del engines, params
    gc.collect()
    torch.cuda.empty_cache()
    return {name: n + evac_counts[name] for name, n in counts.items()}


def serve_cli_prefix_share_phase(torch, root, smi):
    """``serve --backend torch --paged-kv --prefix-share
    --prefix-store-hbm-bytes CLI_SHARE_HBM_BYTES`` (continuous scheduler,
    int8 weights, full depth) in a subprocess that owns the card:
    CLI_SHARE_REQUESTS requests over one shared CLI_SHARE_SYSTEM_TOKENS-token
    system prompt, the first streamed until its session is open, the
    rest sent together so that they join it and hit the store; the
    server's ``llm_prefix_hit_tokens_total`` read from ``/metrics``, then
    SIGTERM and exit 0."""
    import gc
    import re
    import tempfile
    import threading
    import urllib.request
    from importlib import import_module

    client_mod = import_module(f"{PKG}.serve.client")
    GenerationRequest = import_module(f"{PKG}.engine.backend").GenerationRequest
    gc.collect()
    torch.cuda.empty_cache()
    system = share_text(CLI_SHARE_SYSTEM_TOKENS, "System")
    reqs = [GenerationRequest(MODEL, system + f" Question {i}: how is light turned into sugar?", 64,
                              stop_at_eos=False) for i in range(CLI_SHARE_REQUESTS)]
    results = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_share_") as out:
        log_path = Path(out) / "serve.log"
        args = ["--models", MODEL, "--quantize", "int8", "--scheduler", "continuous", "--paged-kv",
                "--prefix-share", "--prefix-store-hbm-bytes", str(CLI_SHARE_HBM_BYTES)]
        with ServeProcess(root, log_path, args) as server:
            client = client_mod.RemoteHTTPBackend(server.url)
            first = {}
            t_first = stream_thread(lambda: client.generate_stream(reqs[0]), first, "first")
            wait_until(lambda: first["first"]["tokens"], timeout=300)
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, client.generate(reqs[i])))
                       for i in range(1, len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            joined([t_first], first)
            with urllib.request.urlopen(f"{server.url}/metrics", timeout=30) as resp:
                metrics = resp.read().decode()
        log_tail = log_path.read_text()[-2000:]
    hit = sum(float(x) for x in re.findall(r"^llm_prefix_hit_tokens_total(?:\{[^}]*\})? (\S+)$", metrics, re.M))
    assert server.rc == 0, (server.rc, log_tail)
    assert sorted(results) == list(range(1, len(reqs))), (sorted(results), log_tail)
    for i, res in results.items():
        assert res.generated_tokens == len(res.tokens) == reqs[i].max_new_tokens, (i, res.generated_tokens)
    assert hit > 0, metrics[-2000:]
    emit({"phase": "serve_cli_prefix_share", "args": args, "server_start_s": server.started,
          "requests": len(reqs), "prefix_hit_tokens_total": hit, "server_exit_code": server.rc,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})


# -- mixtral:8x7b: the mixture-of-experts MLP at full width --------------------
MOE_MODEL = "mixtral:8x7b"
MOE_PROMPT_TOKENS = 256
MOE_NEW_TOKENS = 24
MOE_SHORT_TOKENS = 12  # the paged batch's rows and the int4 request
MOE_BATCH_PROMPTS = (256, 220, 180, 140)  # row 0 is the solo request's prompt
MOE_LAYER_TOKENS = 64
# Dense dispatch against the routed loop, of the largest output: the two
# round the combine weights and the expert sum to bf16 at other places,
# each within 2^-8 of a value; four such steps.
MOE_LAYER_RTOL = 2**-6
# A served token's experts against the plain replay's own router: the
# served choice may fall short of the replay's k-th probability by this
# much and no more. The two paths' bf16 hidden states part by rounding
# over 32 layers, which moves a router probability by up to ~0.02 (a
# near-tie then goes either way); a wrong expert falls short by the
# router's spread, ~0.1.
MOE_ROUTE_SLACK = 2**-5
MOE_ATTENTION_MATMULS = 4  # wq, wk, wv, wo: an MoE layer's 2-D leaves (B9 at int4)
# Load headroom over the resident weights: one layer of one expert leaf's
# float draw ([8, 4096, 14336] f32 is 1.88 GB) and its temporaries, far
# under one whole bf16 expert leaf (30.1 GB).
MOE_LOAD_HEADROOM = 8 * 1024**3
MOE_PROFILED_TOKENS = 4


def moe_request(GenerationRequest, n_tokens=MOE_PROMPT_TOKENS, new_tokens=MOE_NEW_TOKENS):
    """An ``n_tokens``-token prompt asking ``new_tokens`` greedy tokens."""
    return GenerationRequest(MOE_MODEL, context_prompt(n_tokens), new_tokens, stop_at_eos=False)


def moe_load(torch, eng_mod, qmod, memory, phase, smi, **engine_kw):
    """A fresh engine loads full-width mixtral:8x7b at the given weight
    mode (random weights from the engine's seed, drawn a layer at a time):
    its bytes, load seconds and the allocator's peak over the weights."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    engine = eng_mod.TorchEngine(**engine_kw)
    _, load_s = timed(torch, lambda: engine.load_model(MOE_MODEL))
    tf = engine._models[MOE_MODEL]
    cfg = tf.cfg
    nbytes = qmod.params_nbytes(tf.params)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": phase, "weights": engine._quant_mode(MOE_MODEL), "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "experts": cfg.n_experts, "top_k": cfg.top_k_experts,
          "weight_bytes": nbytes, "estimate_bytes": memory.estimate_weight_bytes(cfg, engine._quant_mode(MOE_MODEL)),
          "load_s": load_s, "allocated_before_bytes": before,
          "memory_allocated_bytes": torch.cuda.memory_allocated(), "max_memory_allocated_bytes": peak,
          "peak_over_weights_bytes": peak - before - nbytes, "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k_experts) == (32, 4096, 14336, 8, 2)
    assert peak - before - nbytes <= MOE_LOAD_HEADROOM, (peak, before, nbytes)
    return engine


def moe_layer_phase(torch, tfm, engine, smi):
    """Layer 0 of the loaded int8 model at full width (E 8, k 2, D 4096,
    F 14336) on MOE_LAYER_TOKENS bf16 tokens: the port's dense dispatch
    (``_moe_mlp``: every expert computes every token) against an
    independent routed loop (``torch.topk`` on its own f32 router logits,
    then each expert's own dequantized weights over the tokens routed to
    it, summed in f32). The experts chosen must be identical and the
    outputs within MOE_LAYER_RTOL of the largest one; both are timed."""
    import torch.nn.functional as F

    t0 = time.perf_counter()
    tf = engine._models[MOE_MODEL]
    cfg, layer = tf.cfg, tf.layers[0]
    gen = torch.Generator(device=engine.device).manual_seed(18)
    h = torch.randn((MOE_LAYER_TOKENS, cfg.d_model), generator=gen, device=engine.device).to(torch.bfloat16)

    def expert(name, e):
        return (layer[name]["q"][e].to(torch.float32) * layer[name]["s"][e]).to(torch.bfloat16)

    def routed():
        probs = torch.softmax(h.to(torch.float32) @ layer["router"].to(torch.float32), dim=-1)
        top_w, top_i = torch.topk(probs, cfg.top_k_experts, dim=-1)
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        out = torch.zeros((h.shape[0], cfg.d_model), dtype=torch.float32, device=h.device)
        for e in range(cfg.n_experts):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            x = h[rows]
            y = (F.silu(x @ expert("w_gate", e)) * (x @ expert("w_up", e))) @ expert("w_down", e)
            out.index_add_(0, rows, y.to(torch.float32) * top_w[rows, slot, None])
        return out, top_i

    def dense():
        return tfm._moe_mlp(cfg, h[None], layer)[0]

    (want, want_i), _ = timed(torch, routed)  # the first calls pay cuBLAS's setup
    got, _ = timed(torch, dense)
    _, got_i = tfm.moe_route(cfg, h, layer["router"])
    _, routed_s = timed(torch, routed)
    _, dense_s = timed(torch, dense)
    diff = (got.to(torch.float32) - want).abs().max().item()
    scale = want.abs().max().item()
    same_experts = bool(torch.equal(got_i, want_i))
    emit({"phase": "moe_layer", "tokens": MOE_LAYER_TOKENS, "experts": cfg.n_experts, "top_k": cfg.top_k_experts,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "same_experts": same_experts,
          "tokens_per_expert": torch.bincount(want_i.flatten(), minlength=cfg.n_experts).tolist(),
          "max_abs_err": diff, "max_abs_out": scale, "tolerance": MOE_LAYER_RTOL * scale,
          "dense_ms": dense_s * 1e3, "routed_loop_ms": routed_s * 1e3,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    assert torch.isfinite(got).all() and got.shape == (MOE_LAYER_TOKENS, cfg.d_model)
    assert same_experts, (got_i, want_i)
    assert diff <= MOE_LAYER_RTOL * scale, (diff, scale)


class MoeRouting:
    """Wraps ``models/transformer.py::moe_route`` (the MoE MLP's router)
    while a context is open. Recording (``forced`` None): the experts it
    chooses on each call, [T, k] per call, in call order (each forward
    calls it once a layer). Forcing: each call takes its experts from
    ``forced`` (one (positions, experts) pair a call; other positions keep
    the router's own choice) and their renormalised probabilities as
    weights, and records how far short of the router's own k-th
    probability the forced experts' probabilities fall (0 where the two
    agree)."""

    def __init__(self, torch, tfm, forced=None):
        self.torch, self.tfm, self.forced = torch, tfm, forced
        self.calls, self.shortfall, self.changed = [], 0.0, 0

    def __enter__(self):
        self.route = self.tfm.moe_route
        self.tfm.moe_route = self._route
        return self

    def __exit__(self, *exc):
        self.tfm.moe_route = self.route

    def _route(self, cfg, x, router):
        torch = self.torch
        w, own = self.route(cfg, x, router)
        if self.forced is None:
            self.calls.append(own)
            return w, own
        positions, experts = self.forced.pop(0)
        probs = torch.softmax(x.to(torch.float32) @ router.to(torch.float32), dim=-1)
        i = own.clone()
        i[positions] = experts
        top = probs.gather(1, i)
        kth = torch.sort(probs, dim=-1, descending=True).values[:, cfg.top_k_experts - 1]
        self.shortfall = max(self.shortfall, float((kth - top.min(dim=-1).values).max()))
        self.changed += int((i.sort(dim=-1).values != own.sort(dim=-1).values).any(dim=-1).sum())
        return top / top.sum(dim=-1, keepdim=True), i


def moe_replay(torch, engine, tfm, ca, eng_mod, request, tokens, calls, row=0, rows=1):
    """Teacher-force a served row through the plain forward twice: with
    the router's own choices, and with the experts the served run chose
    at every position and layer (``calls``: the served run's recorded
    [T, k] a call; its first forward's calls hold the row's prompt at
    ``row`` of ``rows`` equal-width rows, each later forward's one token a
    row). Routing is discontinuous: a token whose k-th and (k+1)-th router
    probabilities are within rounding of each other takes either expert,
    and the served path and the replay round differently. Returns (the
    largest logit gap with the replay's own routing, with the served
    routing, the largest shortfall of a served expert's replayed
    probability under the replay's own k-th, the positions and layers
    whose served experts differ from the replay's own)."""
    cfg = engine._models[request.model].cfg
    n_layers = cfg.n_layers
    prompt = len(engine._tokenizer_for(request.model).encode(request.prompt))
    steps = len(tokens) - 1
    assert len(calls) == n_layers * (1 + steps), (len(calls), steps)
    width = calls[0].shape[0] // rows  # the prefill's bucket
    device = calls[0].device
    forced = []
    for layer in range(n_layers):
        prefill = calls[layer][row * width : row * width + prompt]
        decode = [calls[n_layers * (1 + s) + layer][row] for s in range(steps)]
        experts = torch.cat([prefill, torch.stack(decode)]) if decode else prefill
        forced.append((torch.arange(prompt + steps, device=device), experts))
    own = replay_gap(torch, engine, tfm, ca, eng_mod, request, tokens, plain=True)
    with MoeRouting(torch, tfm, forced) as routing:
        served = replay_gap(torch, engine, tfm, ca, eng_mod, request, tokens, plain=True)
    assert not routing.forced, len(routing.forced)
    return own, served, routing.shortfall, routing.changed


def moe_generate_phase(torch, phase, engine, tfm, ca, eng_mod, kernels, request, smi, matmul=None):
    """One study-shaped request through ``generate``: its launches (B1
    once a layer for the prompt's chunk, the decode kernel of the cache's
    kind once a layer a decode forward, with ``matmul`` the int4 kernel
    MOE_ATTENTION_MATMULS times a layer a decode forward, nothing else),
    its tokens replayed teacher-forced through the plain forward under the
    experts the served run chose (``moe_replay``: each token within
    LOGIT_ATOL of its position's maximum, each served expert within
    MOE_ROUTE_SLACK of the replay's own k-th probability), its ms a step,
    NVML's Joules and mean W over the call beside
    ``extras["energy_model"]``."""
    from importlib import import_module

    dev = import_module(f"{PKG}.profilers.nvml").nvml_device()
    cfg = engine._models[MOE_MODEL].cfg
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    e0 = dev.total_energy_mj()
    with MoeRouting(torch, tfm) as routing:
        (res,), counts = count_launches(kernels, lambda: [engine.generate(request)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    joules = (dev.total_energy_mj() - e0) / 1e3
    check_results(engine, [request], [res])
    steps = len(res.tokens) - 1
    decode = "cuda_decode_attention_int8" if engine.kv_quantize else "cuda_decode_attention"
    expected = {fn.__name__: 0 for fn in kernels}
    expected["cuda_prefill_attention"] = cfg.n_layers * len(eng_mod._prompt_chunks(res.prompt_tokens))
    expected[decode] = cfg.n_layers * steps
    if matmul:
        expected[matmul] = MOE_ATTENTION_MATMULS * cfg.n_layers * steps
    own_gap, gap, shortfall, changed = moe_replay(torch, engine, tfm, ca, eng_mod, request, res.tokens,
                                                  routing.calls)
    model = (res.extras or {}).get("energy_model") or {}
    emit({"phase": phase, "weights": engine._quant_mode(MOE_MODEL), "kv": engine.kv_quantize or "bf16",
          "prompt_tokens": res.prompt_tokens, "generated_tokens": res.generated_tokens,
          "prefill_s": res.prefill_s, "decode_s": res.decode_s, "ms_per_step": res.decode_s / steps * 1e3,
          "tokens_per_s": res.tokens_per_s, "wall_s": wall, "nvml_J": joules, "nvml_mean_W": joules / wall,
          "nvml_J_per_token": joules / res.generated_tokens, "energy_model": model,
          "max_logit_gap_plain": gap, "logit_atol": LOGIT_ATOL, "max_logit_gap_plain_own_routing": own_gap,
          "routing_changed": changed, "routing_shortfall": shortfall, "routing_slack": MOE_ROUTE_SLACK,
          "counts": counts, "expected": expected,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "seconds": wall,
          "nvidia_smi": smi})
    assert counts == expected, (counts, expected)
    assert model.get("J_per_token") is not None, res.extras
    assert gap <= LOGIT_ATOL and shortfall <= MOE_ROUTE_SLACK, (gap, shortfall)
    return counts, res


def moe_busy_share(torch, engine, GenerationRequest):
    """The card's busy share over a ``torch.profiler`` trace of one
    MOE_PROFILED_TOKENS-token ``generate`` (prefill included), and the
    trace's kernel count."""
    import tempfile
    from torch.profiler import ProfilerActivity

    req = moe_request(GenerationRequest, new_tokens=MOE_PROFILED_TOKENS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_trace_") as out:
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.generate(req)
            torch.cuda.synchronize()
        path = Path(out) / "trace.json"
        prof.export_chrome_trace(str(path))
        busy, n_kernels, _ = trace_busy_share(path)
    return busy, n_kernels


def moe_batch_phase(torch, engine, tfm, ca, eng_mod, kernels, GenerationRequest, solo, smi):
    """``generate_batch`` of MOE_BATCH_PROMPTS rows over the paged bf16
    pool: B1 once a layer a prefill forward, B4 once a layer a decode
    step (every row asks MOE_SHORT_TOKENS), nothing else; every row's
    tokens replayed as ``moe_generate_phase`` replays them; row 0's tokens
    beside the solo request's."""
    cfg = engine._models[MOE_MODEL].cfg
    reqs = [moe_request(GenerationRequest, n, MOE_SHORT_TOKENS) for n in MOE_BATCH_PROMPTS]
    t0 = time.perf_counter()
    with MoeRouting(torch, tfm) as routing:
        results, counts = count_launches(kernels, lambda: engine.generate_batch(reqs))
    wall = time.perf_counter() - t0
    check_results(engine, reqs, results)
    forwards = prefill_forwards(eng_mod, [r.prompt_tokens for r in results])
    expected = {fn.__name__: 0 for fn in kernels}
    expected["cuda_prefill_attention"] = cfg.n_layers * forwards
    expected["cuda_paged_decode_attention_parts"] = cfg.n_layers * (MOE_SHORT_TOKENS - 1)
    replays = [moe_replay(torch, engine, tfm, ca, eng_mod, r, res.tokens, routing.calls, row, len(reqs))
               for row, (r, res) in enumerate(zip(reqs, results))]
    own_gaps, gaps, shortfalls, changed = (list(x) for x in zip(*replays))
    same = sum(a == b for a, b in zip(results[0].tokens, solo.tokens)) / len(results[0].tokens)
    windows = {res.extras["decode_window"]: res.decode_s for res in results}
    emit({"phase": "engine_mixtral_paged_batch", "rows": len(reqs),
          "prompt_tokens": [r.prompt_tokens for r in results], "generated_tokens": [r.generated_tokens for r in results],
          "decode_window_s": sum(windows.values()),
          "ms_per_step": sum(windows.values()) / (MOE_SHORT_TOKENS - 1) * 1e3,
          "decode_tokens_per_s": sum(r.generated_tokens for r in results) / sum(windows.values()),
          "max_logit_gap_plain": gaps, "logit_atol": LOGIT_ATOL, "max_logit_gap_plain_own_routing": own_gaps,
          "routing_changed": changed, "routing_shortfall": shortfalls, "routing_slack": MOE_ROUTE_SLACK,
          "row0_solo_token_share": same, "counts": counts, "expected": expected, "seconds": wall,
          "nvidia_smi": smi})
    assert counts == expected, (counts, expected)
    assert max(gaps) <= LOGIT_ATOL and max(shortfalls) <= MOE_ROUTE_SLACK, (gaps, shortfalls)
    return counts


def mixtral_phases(torch, eng_mod, tfm, qmod, ca, kernels, GenerationRequest, smi):
    """mixtral:8x7b at its published width and depth (32 layers, 8 experts
    of d_ff 14336, top-2), random weights from the engine's seed, after
    every earlier engine has let go of its memory: the bf16 load refused
    before it allocates (93.4 GB); an int8 engine (46.7 GB) whose layer 0
    holds the dense dispatch against a routed loop (``moe_layer``), then
    the study's ``generate`` over a bf16 KV cache and over an int8 one,
    and ``generate_batch`` over the paged bf16 pool (engines that install
    the int8 engine's weights, no copy); last a fresh int4 engine (B9 on
    wq/wk/wv/wo, the experts dequantized). Returns the launches."""
    import gc
    from importlib import import_module

    memory = import_module(f"{PKG}.utils.memory")
    gc.collect()
    torch.cuda.empty_cache()
    totals = {fn.__name__: 0 for fn in kernels}

    def add(counts):
        for name, n in counts.items():
            totals[name] += n

    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()
    engine = eng_mod.TorchEngine()  # bf16 weights
    try:
        engine.load_model(MOE_MODEL)
    except memory.ModelMemoryError as exc:
        refused = str(exc)
    else:
        raise AssertionError("the bf16 load of mixtral:8x7b was not refused")
    after = torch.cuda.memory_allocated()
    emit({"phase": "mixtral_bf16_refused", "error": refused,
          "estimate_bytes": memory.estimate_weight_bytes(eng_mod.get_model_config(MOE_MODEL), None),
          "allocated_before_bytes": before, "allocated_after_bytes": after,
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    assert after == before and not engine._models and "quantize" in refused, (before, after, refused)
    del engine

    engine = moe_load(torch, eng_mod, qmod, memory, "mixtral_load_int8", smi, quantize="int8")
    cfg, params = engine._models[MOE_MODEL].cfg, engine._models[MOE_MODEL].params
    moe_layer_phase(torch, tfm, engine, smi)
    request = moe_request(GenerationRequest)
    counts, solo = moe_generate_phase(torch, "engine_mixtral_int8", engine, tfm, ca, eng_mod, kernels,
                                      request, smi)
    add(counts)
    t0 = time.perf_counter()
    busy, n_kernels = moe_busy_share(torch, engine, GenerationRequest)
    # The byte model bills a decode step's top-k experts; dense dispatch
    # reads the codes of all of them.
    all_experts = dataclasses.replace(cfg, top_k_experts=cfg.n_experts)
    emit({"phase": "engine_mixtral_int8_profile", "generated_tokens": MOE_PROFILED_TOKENS,
          "trace_busy_share": busy, "trace_kernels": n_kernels,
          "modelled_step_weight_bytes": memory.decode_weight_stream_bytes(cfg, "int8"),
          "streamed_step_weight_bytes": memory.decode_weight_stream_bytes(all_experts, "int8"),
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    del engine

    for phase, kw in (("engine_mixtral_int8_kv", dict(kv_quantize="int8")),
                      ("engine_mixtral_paged_batch", dict(paged_kv=True))):
        engine = eng_mod.TorchEngine(quantize="int8", **kw)
        engine.install_model(MOE_MODEL, cfg, params)  # the same tensors: int8 leaves pass through
        if phase == "engine_mixtral_int8_kv":
            add(moe_generate_phase(torch, phase, engine, tfm, ca, eng_mod, kernels, request, smi)[0])
        else:
            add(moe_batch_phase(torch, engine, tfm, ca, eng_mod, kernels, GenerationRequest, solo, smi))
        del engine
    del params
    gc.collect()
    torch.cuda.empty_cache()

    engine = moe_load(torch, eng_mod, qmod, memory, "mixtral_load_int4", smi, quantize="int4")
    counts, res = moe_generate_phase(torch, "engine_mixtral_int4", engine, tfm, ca, eng_mod, kernels,
                                     moe_request(GenerationRequest, new_tokens=MOE_SHORT_TOKENS), smi,
                                     matmul="cuda_int4_matmul")
    add(counts)
    emit({"phase": "mixtral_done", "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "int8_int4_token_share": sum(a == b for a, b in zip(solo.tokens, res.tokens)) / len(res.tokens)})
    del engine, res, solo
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def main() -> int:
    import torch

    root = Path(__file__).resolve().parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sources = ("attention.cu", "paged_attention.cu", "int4_matmul.cu")
    if not all((root / PKG / "csrc" / f).is_file() for f in sources):
        print(f"chip_smoke: the {PKG} package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from importlib import import_module

    kernels = import_module(f"{PKG}.ops._kernels")
    ca = import_module(f"{PKG}.ops.cuda_attention")
    cpa = import_module(f"{PKG}.ops.cuda_paged_attention")
    plain = import_module(f"{PKG}.ops.attention")
    eng_mod = import_module(f"{PKG}.engine.torch_engine")
    backend = import_module(f"{PKG}.engine.backend")
    tfm = import_module(f"{PKG}.models.transformer")
    pk = import_module(f"{PKG}.engine.paged_kv")
    cq = import_module(f"{PKG}.ops.cuda_quant")
    qplain = import_module(f"{PKG}.ops.quant")
    qmod = import_module(f"{PKG}.models.quantize")
    all_kernels = ca.KERNELS + cpa.KERNELS + cq.KERNELS

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({
        "phase": "device", "name": kind, "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    t0 = time.perf_counter()
    log = kernels.build()  # one nvcc per source, all at once
    for name in kernels.SOURCES:
        kernels.library(name)
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(kernels.SOURCES),
        "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln],
    })

    timer = Timer(torch)
    control = b7_f32_control(torch, cpa)  # the profiler's two-kernel control
    summary = kernel_phase(torch, ca, plain, timer)
    summary.update(paged_kernel_phase(torch, cpa, plain, timer, qmod.quantize_kv_vector, control))
    summary.update(paged_mq_kernel_phase(torch, cpa, plain, timer, qmod.quantize_kv_vector, kernels,
                                         control))
    summary.update(contiguous_mq_kernel_phase(torch, cpa, plain, timer, qmod.quantize_kv_vector))
    stacked_layer_kernel_phase(torch, cpa, timer, qmod.quantize_kv_vector)
    summary.update(int4_kernel_phase(torch, cq, qplain, qmod, timer, control))
    summary.update(paged_decode_kernel_phase(torch, cpa, ca, plain, timer, control))
    summary.update(w4a8_kernel_phase(torch, cq, qplain, qmod, timer, control))
    del timer
    torch.cuda.empty_cache()

    launches = {fn.__name__: 0 for fn in all_kernels}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    add(w4a8_probe_phase(torch, root, all_kernels))
    torch.cuda.empty_cache()

    requests = study_requests(backend.GenerationRequest)
    chunks_of = lambda n: len(eng_mod._prompt_chunks(n))  # noqa: E731
    attention = (ca.cuda_prefill_attention, ca.cuda_decode_attention)
    # (phase, weights, kv, int4 kernel, its plain version, layers: None for
    # the model's own depth)
    cut = cut_registry()[MODEL]
    solo_phases = (
        ("engine_bf16_kv", "int8", None, None, None, cut),
        ("engine_int8_kv", "int8", "int8", None, None, cut),
        ("engine_int4", "int4", None, cq.cuda_int4_matmul, qplain.int4_matmul_reference, cut),
        ("engine_int4_i32", "int4-i32", None, cq.cuda_int4_matmul_i32, None, cut),
    )
    for phase, weights, kv, matmul, matmul_plain, cfg in solo_phases:
        engine = eng_mod.TorchEngine(quantize=weights, kv_quantize=kv,
                                     registry=None if cfg is None else {MODEL: cfg})
        engine.load_model(MODEL)
        n_layers = engine._models[MODEL].cfg.n_layers
        add(engine_phase(phase, engine, requests, all_kernels, n_layers, chunks_of,
                         matmul.__name__ if matmul else None))
        if phase == "engine_bf16_kv":
            integration_phase(torch, engine, "integration", {
                "kernels": (*attention, cq.cuda_int4_matmul),
                "plain": (plain.prefill_attention_cached, plain.decode_attention_reference,
                          cq.cuda_int4_matmul),
            }, tfm.forward, tfm.logits_for, qmod)
        if matmul_plain is not None:
            integration_phase(torch, engine, "int4_integration", {
                "kernels": (*attention, matmul), "plain": (*attention, matmul_plain),
            }, tfm.forward, tfm.logits_for, qmod)
        del engine
        torch.cuda.empty_cache()

    engine = eng_mod.TorchEngine(quantize={MODEL: "int8", "default": "int4"}, registry=cut_registry())
    add(mixed_quant_phase(engine, backend.GenerationRequest, all_kernels, chunks_of, qmod.params_nbytes))
    del engine
    torch.cuda.empty_cache()

    # (phase, weights, kv, requests, int4 kernel's name)
    paged_phases = (
        ("engine_paged_bf16_kv", "int8", None, batch_requests, None),
        ("engine_paged_int8_kv", "int8", "int8", batch_requests, None),
        ("engine_paged_int4", "int4", None, int4_batch_requests, "cuda_int4_matmul"),
    )
    for phase, weights, kv, make_requests, matmul in paged_phases:
        engine = eng_mod.TorchEngine(quantize=weights, paged_kv=True, kv_quantize=kv,
                                     registry=cut_registry())
        engine.load_model(MODEL)
        n_layers = engine._models[MODEL].cfg.n_layers
        add(paged_engine_phase(phase, engine, make_requests(backend.GenerationRequest),
                               all_kernels, n_layers, eng_mod, matmul))
        if phase == "engine_paged_bf16_kv":
            paged_integration_phase(torch, engine, pk, plain, tfm, eng_mod)
            add(write_through_phase(torch, engine, pk, tfm, eng_mod, all_kernels, n_layers,
                                    backend.GenerationRequest))
            write_through_integration_phase(torch, engine, pk, plain, tfm, eng_mod,
                                            backend.GenerationRequest)
        del engine
        torch.cuda.empty_cache()

    # Speculative sessions over the paged pool at int8 weights: the n-gram
    # draft (bf16 and int8 pools), then a self-draft (the model drafts for
    # itself: every candidate position of the verify carries real work).
    mq_names = ("cuda_paged_decode_attention_mq_parts", "cuda_paged_decode_attention_mq_parts_int8")
    for phase, kv, verify in (("engine_spec_ngram_bf16_kv", None, mq_names[0]),
                              ("engine_spec_ngram_int8_kv", "int8", mq_names[1])):
        engine = eng_mod.TorchEngine(quantize="int8", paged_kv=True, kv_quantize=kv,
                                     registry=cut_registry(), speculative={MODEL: ("ngram", SPEC_K)})
        engine.load_model(MODEL)
        n_layers = engine._models[MODEL].cfg.n_layers
        reqs = spec_requests(backend.GenerationRequest)
        counts, results = spec_engine_phase(phase, engine, reqs, all_kernels, n_layers, eng_mod, verify)
        add(counts)
        if kv is None:
            add(spec_entry_points_phase(engine, backend.GenerationRequest, all_kernels))
            greedy_share("spec_greedy_share", engine, reqs, results)
        spec_integration_phase(torch, engine, pk, plain, tfm, eng_mod)
        del engine, results
        torch.cuda.empty_cache()
    # k = 12: the verify block of 13 positions runs B7 in one launch a layer.
    engine = eng_mod.TorchEngine(quantize="int8", paged_kv=True,
                                 speculative={MODEL: ("ngram", LONG_SPEC_K)})
    engine.load_model(MODEL)
    n_layers = engine._models[MODEL].cfg.n_layers
    q_max = kernels.library("paged_attention").paged_mq_query_max(1)  # the engine's q is bf16
    counts, _ = spec_engine_phase("engine_spec_ngram_k12", engine,
                                  long_spec_requests(backend.GenerationRequest), all_kernels, n_layers,
                                  eng_mod, mq_names[0], k=LONG_SPEC_K,
                                  verify_launches=-(-(LONG_SPEC_K + 1) // q_max))
    add(counts)
    del engine
    torch.cuda.empty_cache()
    engine = eng_mod.TorchEngine(quantize="int8", paged_kv=True, speculative={MODEL: (MODEL, SPEC_K)})
    engine.load_model(MODEL)
    n_layers = engine._models[MODEL].cfg.n_layers
    counts, _ = spec_engine_phase("engine_spec_selfdraft", engine, selfdraft_requests(backend.GenerationRequest),
                                  all_kernels, n_layers, eng_mod, mq_names[0], draft_layers=n_layers)
    assert counts["cuda_decode_attention"] > 0 and counts[mq_names[0]] > 0, counts
    add(counts)
    del engine
    torch.cuda.empty_cache()
    # The contiguous session's verify (the engine's default layout): B7/B8's
    # bodies over contiguous rows, bf16 and int8 caches, a joiner mid-flight;
    # then generate's routing there, the adaptive policy, and joins into
    # and preemption of a speculating session on both layouts.
    contig_names = ("cuda_contiguous_mq_attention", "cuda_contiguous_mq_attention_int8")
    for phase, kv, verify in (("engine_spec_contiguous_bf16_kv", None, contig_names[0]),
                              ("engine_spec_contiguous_int8_kv", "int8", contig_names[1])):
        engine = eng_mod.TorchEngine(quantize="int8", kv_quantize=kv, registry=cut_registry(),
                                     speculative={MODEL: ("ngram", SPEC_K)})
        engine.load_model(MODEL)
        n_layers = engine._models[MODEL].cfg.n_layers
        add(contiguous_spec_phase(phase, torch, engine, all_kernels, n_layers, eng_mod,
                                  backend.GenerationRequest, verify))
        if kv is None:
            add(contiguous_spec_entry_points_phase(engine, backend.GenerationRequest, all_kernels))
        del engine
        torch.cuda.empty_cache()
    add(adaptive_spec_phase(torch, eng_mod, all_kernels, backend.GenerationRequest, smi))
    for paged in (True, False):
        add(spec_join_preempt_phase(torch, eng_mod, all_kernels, backend.GenerationRequest, smi, paged))
    add(serve_phases(torch, eng_mod, all_kernels, smi, tfm, ca))
    torch.cuda.empty_cache()
    add(contiguous_batch_phase(torch, eng_mod, tfm, ca, all_kernels, backend.GenerationRequest, smi))
    add(contiguous_serve_phases(torch, eng_mod, all_kernels, smi, tfm, ca))
    add(lru_phase(torch, eng_mod, all_kernels, backend.GenerationRequest, smi))
    torch.cuda.empty_cache()
    wide_integration_phase(torch, eng_mod, ca, plain, cq, tfm, qmod)
    torch.cuda.empty_cache()
    add(study_phase(torch, eng_mod, all_kernels, smi))
    torch.cuda.empty_cache()
    add(study_cli_phase(torch, eng_mod, all_kernels, smi))
    serve_cli_capstone_phase(torch, root, smi)
    serve_cli_contiguous_phase(torch, root, smi)
    serve_cli_speculative_contiguous_phase(torch, root, smi)
    torch.cuda.empty_cache()
    add(prefix_cache_phase(torch, eng_mod, all_kernels, backend.GenerationRequest, smi))
    add(hf_checkpoint_phases(torch, root, eng_mod, all_kernels, backend.GenerationRequest, smi))
    add(study_duty_trace_phase(torch, eng_mod, all_kernels, smi))
    torch.cuda.empty_cache()
    # The shared prefix store and live row migration.
    add(prefix_share_paged_phase(torch, eng_mod, all_kernels, backend.GenerationRequest, smi, tfm, ca))
    add(prefix_share_spill_phase(torch, eng_mod, all_kernels, backend.GenerationRequest, smi))
    add(serve_migrate_phase(torch, eng_mod, all_kernels, smi))
    serve_cli_prefix_share_phase(torch, root, smi)
    # The mixture-of-experts MLP: mixtral:8x7b at full width and depth.
    add(mixtral_phases(torch, eng_mod, tfm, qmod, ca, all_kernels, backend.GenerationRequest, smi))
    assert all(launches.values()), launches

    rows = []
    for fn in all_kernels:
        r = summary[fn.__name__]
        source, replaces = KERNEL_INFO[fn.__name__]
        rows.append({
            "name": fn.__name__, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[fn.__name__],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
